"""Device milliseconds a job that rank 0's card spends in NCCL's kernels
(every kernel whose name holds ``nccl``: the all-reduces over "rep", the
gathers over "res" and the whole mesh, the barriers), by name in the
profiler, a mean over the traced window's jobs.  A collective's kernel
runs from its launch until every peer has joined, so the time holds the
wait for the slowest rank."""

UNIT = "ms"


def read(t):
    spent = t.kernel_seconds(lambda n: "nccl" in n.lower())
    if not t.records or spent <= 0:
        return None
    return 1e3 * spent / len(t.records)
