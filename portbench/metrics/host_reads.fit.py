"""Device-to-host reads a fit job makes (``fit.globalfit.host_reads``,
the port's count of every read of its fits), a mean over the traced
window's jobs."""

UNIT = "reads"


def read(t):
    return t.per_job("host_reads")
