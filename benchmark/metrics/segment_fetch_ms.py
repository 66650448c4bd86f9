"""The fetch per segment on the local run: the span ``fused.fetch``
(sieve_torch/kernels/cuda_mark.py), the one synchronising read of a
segment's uint32[4] after the fused kernel's launch, so the kernel's
remaining time, the synchronise and the copy out, over the window,
divided by its count. None where the program has no such span."""

UNIT = "ms"
LAYER = "segment fetch"
MOVES = "values_per_s"


def read(r):
    s, n = r.spans.get("fused.fetch", (0.0, 0))
    return 1e3 * s / n if n else None
