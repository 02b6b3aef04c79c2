"""Seconds a job that rank 0 spends in ``ShardedCtStream``'s all-reduces
over "rep" (the spans ``ct_stream.allreduce`` of
``parallel.streamed.ShardedCtStream.update``, one a stream and group: the
host's launch of the three collectives, and its wait where the backend
blocks), a mean over the traced window's jobs.  None where the program
records no such span."""

from portbench.spans import window

UNIT = "s"


def read(t):
    w = window(t)
    got = [b - a for _, name, a, b, _ in (w[0] if w else ()) if name == "ct_stream.allreduce"]
    return sum(got) / 1e9 / len(t.records) if got else None
