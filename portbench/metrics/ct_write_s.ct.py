"""Seconds a job spends writing the C(t) stage's artefacts (the spans
``stage_ct.write`` of ``pipeline.stages.stage_ct_streamed``: each
artefact's read of its statistics from the card, formatting and file
write), a mean over the traced window's jobs."""

from portbench.spans import seconds_per_job

UNIT = "s"


def read(t):
    return seconds_per_job(t, "stage_ct.write")
