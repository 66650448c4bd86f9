"""Host staging time per segment on the local run: the spans
``fused.stage`` (the fused kernel's inputs packed into one buffer),
``fused.pin`` (that buffer pinned), ``fused.copy`` (its copy to the card
queued) and ``fused.launch`` (the kernel's launch queued), all inside
``segment.device`` (sieve_torch/kernels/cuda_mark.py), over the window,
divided by the launches. None where the program has no such spans."""

UNIT = "ms"
LAYER = "segment staging"
MOVES = "values_per_s"
SPANS = ("fused.stage", "fused.pin", "fused.copy", "fused.launch")


def read(r):
    launches = r.spans.get("fused.launch", (0.0, 0))[1]
    if not launches:
        return None
    return 1e3 * sum(r.spans.get(k, (0.0, 0))[0] for k in SPANS) / launches
