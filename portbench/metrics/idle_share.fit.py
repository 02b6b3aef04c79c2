"""The card's idle share of the traced window: 1 - (the union of its
kernel and copy intervals) / (the window's wall), in %."""

UNIT = "%"


def read(t):
    if t.busy_s is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
