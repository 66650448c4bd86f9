"""Prime-pair merge fix-up: pairs that straddle a segment boundary.

A pair (v, v+gap) straddles the boundary at hi exactly when
hi-gap <= v < hi. It is attributed to the left segment and resolved from
the two segments' boundary bitwords alone — the 32-bit words every
backend returns.
"""

from __future__ import annotations

from sieve_torch.bitset import WORD_BITS, Layout
from sieve_torch.worker import SegmentResult

_SMALL_PRIMES = {2, 3, 5, 7, 11, 13}


def is_prime_from_boundary(layout: Layout, seg: SegmentResult, v: int) -> bool:
    """Primality of v using only seg's boundary words (v near lo or hi)."""
    if not (seg.lo <= v < seg.hi):
        raise ValueError(f"value {v} outside segment [{seg.lo}, {seg.hi})")
    if v in layout.extra_primes:
        return True
    if not layout.is_candidate(v):
        return False
    b = layout.bit_of(v, seg.lo)
    if b < 0 or b >= seg.nbits:
        return False
    if b < WORD_BITS:
        return bool((seg.first_word >> b) & 1)
    off = b - (seg.nbits - WORD_BITS)
    if off < 0:
        raise ValueError(
            f"value {v} (bit {b}) not within a boundary word of "
            f"segment [{seg.lo}, {seg.hi}) with nbits={seg.nbits}"
        )
    return bool((seg.last_word >> off) & 1)


def straddle_pairs(
    layout: Layout, left: SegmentResult, right: SegmentResult, n: int,
    gap: int = 2,
) -> int:
    """Prime pairs (v, v+gap) with v in `left`, v+gap in `right`
    (consecutive segments); gap is 2 (twins) or 4 (cousins)."""
    if left.hi != right.lo:
        raise ValueError("segments are not consecutive")
    hi = left.hi
    total = 0
    for v in range(hi - gap, hi):
        w = v + gap
        if v < left.lo or w < hi or w > n:
            continue
        if w >= right.hi:
            # only possible for degenerate 1-value segments, which
            # plan_segments never emits
            raise ValueError(f"segment [{right.lo},{right.hi}) too small for pair fix-up")
        if w in _SMALL_PRIMES:
            right_prime = True  # 3/5/7... are prime regardless of packing
        else:
            right_prime = is_prime_from_boundary(layout, right, w)
        if right_prime and is_prime_from_boundary(layout, left, v):
            total += 1
    return total
