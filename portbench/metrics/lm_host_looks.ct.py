"""Host reads of the LM's ``live`` flag a job makes (the counter
``fit.host_looks`` of ``fit.engine``'s loops: one a stall window of the
graph loop, one a step of the eager loop), a mean over the traced
window's jobs."""

from portbench.spans import count_in_window

UNIT = "looks"


def read(t):
    n = count_in_window(t, "fit.host_looks")
    return None if n is None else n / len(t.records)
