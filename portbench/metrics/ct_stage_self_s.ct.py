"""Seconds a job spends in ``pipeline.stages.stage_ct_streamed``'s own
host loop: the span ``stage_ct`` less what its children (``decode``,
``h2d``, ``accumulate``, ``write``) cover, a mean over the traced
window's jobs."""

from portbench.spans import self_seconds_per_job

UNIT = "s"


def read(t):
    return self_seconds_per_job(t, "stage_ct")
