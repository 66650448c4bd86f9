"""Segment partitioning: contiguous segments that tile [2, n+1) exactly,
with no overlap."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Segment:
    seg_id: int
    lo: int
    hi: int  # half-open [lo, hi)
    owner: int = 0

    @property
    def span(self) -> int:
        return self.hi - self.lo


def plan_segments(
    n: int,
    n_segments: int,
    n_workers: int = 1,
    align: int = 2,
    lo_start: int = 2,
) -> list[Segment]:
    """Cut [lo_start, n+1) into <= n_segments contiguous segments.

    Interior boundaries are aligned down to a multiple of ``align`` (keeps
    odd/even pairing stable across packings); the first and last boundaries
    are exact. Degenerate (empty) segments are dropped, so fewer than
    n_segments may be returned for tiny ranges. Owners round-robin over
    n_workers.
    """
    if n < lo_start:
        raise ValueError(f"n={n} < lo_start={lo_start}")
    hi_total = n + 1
    span = hi_total - lo_start
    n_segments = max(1, min(n_segments, span))
    bounds = [lo_start]
    for i in range(1, n_segments):
        raw = lo_start + (span * i) // n_segments
        b = (raw // align) * align
        b = max(b, bounds[-1])  # keep monotone
        bounds.append(b)
    bounds.append(hi_total)
    segs: list[Segment] = []
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i], bounds[i + 1]
        if hi <= lo:
            continue
        segs.append(Segment(seg_id=len(segs), lo=lo, hi=hi))
    return [dataclasses.replace(s, owner=s.seg_id % n_workers) for s in segs]


def validate_plan(segs: list[Segment], n: int, lo_start: int = 2) -> None:
    """Raise unless the plan tiles [lo_start, n+1) exactly with no overlap."""
    if not segs:
        raise ValueError("empty plan")
    if segs[0].lo != lo_start:
        raise ValueError(f"plan starts at {segs[0].lo}, expected {lo_start}")
    for a, b in zip(segs, segs[1:]):
        if a.hi != b.lo:
            raise ValueError(f"gap/overlap between segment {a.seg_id} and {b.seg_id}")
    if segs[-1].hi != n + 1:
        raise ValueError(f"plan ends at {segs[-1].hi}, expected {n + 1}")
