"""GB/s of the C(t) stage's copies to the card: the bytes of the
observables it copies (the counter ``stage_ct.h2d_bytes``) over the
profiler's ``Memcpy HtoD`` seconds, both over the traced window.  None
where the window has no such copies (the CPU)."""

from portbench.spans import count_in_window

UNIT = "GB/s"


def read(t):
    n = count_in_window(t, "stage_ct.h2d_bytes")
    secs = t.kernel_seconds(lambda name: "HtoD" in name)
    if not n or secs <= 0:
        return None
    return n / secs / 1e9
