"""The word kernel's share of the same roofline (kernels/word_mark.py, the
``torch`` backend's marking in torch ops): the least time the window's
segments need (benchmark/roofline/, the fused kernel's yardstick) over
the device time of every operation the word path ran in the window, from
the profiler's trace."""

UNIT = "%"
LAYER = "word kernel"
MOVES = "values_per_s.words"


def read(r):
    if not r.device_ops or r.config["backend"] != "torch":
        return None
    busy = sum(b - a for _, a, b in r.device_ops)
    bound = r.job_bound_s()
    if not busy or bound is None:
        return None
    return 100.0 * r.jobs * bound / busy
