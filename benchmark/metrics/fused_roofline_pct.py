"""The fused kernel's share of its roofline (kernels/csrc/fused_mark.cu):
the least time the window's segments need (benchmark/roofline/, counted
from each segment's range and seeds) over the device time of the fused
kernel's two launches per segment, ``fused_mark_kernel`` and its
``combine_kernel``, summed from the profiler's trace of the window."""

UNIT = "%"
LAYER = "fused kernel"
MOVES = "values_per_s"
KERNELS = ("fused_mark_kernel", "combine_kernel")


def read(r):
    if not r.device_ops or r.config["backend"] != "cuda":
        return None
    busy = sum(b - a for name, a, b in r.device_ops
               if any(k in name for k in KERNELS))
    bound = r.job_bound_s()
    if not busy or bound is None:
        return None
    return 100.0 * r.jobs * bound / busy
