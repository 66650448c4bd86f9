"""Host prepare time per segment on the local run (sieve_torch/coordinator.py
driving a backend's ``process_segment``): the span ``segment.prepare``
(the spec tables of one segment, built by the backend's chain) over the
window, divided by its segments. The card idles through it."""

UNIT = "ms"
LAYER = "segment prepare"
MOVES = "values_per_s"


def read(r):
    prep, segs = r.spans.get("segment.prepare", (0.0, 0))
    return 1e3 * prep / segs if segs else None
