"""LM steps a job runs: kernel B's launches (one a step of fit.engine's
loop, replays of its graph included), from the port's launch counters,
a mean over the traced window's jobs."""

UNIT = "steps"


def read(t):
    n = [r["launches"]["B"] for r in t.records if "launches" in r]
    return sum(n) / len(n) if n else None
