"""The card's idle share of the window: 1 - the union of its kernels,
copies and sets in the profiler's trace over the window's length."""

UNIT = "%"
LAYER = "device"
MOVES = "values_per_s"


def read(r):
    if r.busy_s is None or not r.window_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
