"""Seconds a job spends in the finish's DoF ladder (the span
``run_finish.ladder`` around ``fit.expfit.fit_ct_ladder`` in
``parallel.streamed.run_finish``), host clock, a mean over the traced
window's jobs."""

from portbench.spans import seconds_per_job

UNIT = "s"


def read(t):
    return seconds_per_job(t, "run_finish.ladder")
