"""The benchmark's plain reference: torch and numpy only, nothing of the
port.  Every function takes the inputs the benchmark made (coordinates,
observables, models, ensembles, experiments) and works out again what
the port derives from them, in the dtype it is given: float64 for the
judge, a lower precision for the control."""
