"""Kernel A's share of its roofline, in %: the least time of every launch
of the traced window (``portbench.roofline.acf_bound`` at each launch's
series, frames and lags) over kernel A's device time in the profiler."""

from portbench.roofline import acf_bound

UNIT = "%"


def read(t):
    shapes = [s for r in t.records for s in r.get("acf_shapes", [])]
    spent = t.kernel_seconds(lambda name: "acf_lag_sums" in name)
    if not shapes or spent <= 0:
        return None
    return 100.0 * sum(acf_bound(*s)[0] for s in shapes) / 1e3 / spent
