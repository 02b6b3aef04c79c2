"""Per cent of the C(t) stage's copied bytes that went to the card through
its pinned staging slots: the counter ``stage_ct.h2d_pinned_bytes`` over
``stage_ct.h2d_bytes``, both over the traced window.  0 for a program
that keeps no such counter (its copies are pageable); None where the
window copies nothing."""

from portbench.spans import count_in_window

UNIT = "%"


def read(t):
    n = count_in_window(t, "stage_ct.h2d_bytes")
    if not n:
        return None
    return 100.0 * count_in_window(t, "stage_ct.h2d_pinned_bytes") / n
