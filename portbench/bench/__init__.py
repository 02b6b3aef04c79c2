"""The harness's own parts: finding a cell's data by name, the traced
window, and the guard against loading the JAX side."""
