"""Seconds a run-all job spends in its ct step (run_workflow's own wall
of the step, a mean over the traced window's jobs)."""

UNIT = "s"


def read(t):
    return t.per_job("step_s.ct")
