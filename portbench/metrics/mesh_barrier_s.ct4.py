"""Seconds a job that rank 0 waits in the mesh's barriers (the spans
``mesh.barrier`` of ``parallel.mesh.barrier``, one after each artefact
the writing rank writes), a mean over the traced window's jobs.  Rank 0
is the writer, so this is its wait for the slowest other rank.  None
where the program records no such span."""

from portbench.spans import window

UNIT = "s"


def read(t):
    w = window(t)
    got = [b - a for _, name, a, b, _ in (w[0] if w else ()) if name == "mesh.barrier"]
    return sum(got) / 1e9 / len(t.records) if got else None
