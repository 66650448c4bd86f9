"""Prime enumeration: materialize the primes in a subrange.

The reference's ``sieve/enumerate.py``. Counting is the scalable product,
enumeration is the inspection tool.
Emission is host/IO-bound by nature, so it runs the readable numpy marking
(sieve_torch/backends/cpu_numpy.py) over the requested window in segment-sized
slices — any packing, any window inside [2, n+1), modest memory.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Iterator, Sequence

import numpy as np

from sieve_torch.backends.cpu_numpy import sieve_segment_flags
from sieve_torch.bitset import get_layout
from sieve_torch.seed import seed_primes

# Enumerating more than this per call is almost certainly a mistake (the
# output alone would be GBs); counting is the scalable interface.
MAX_SPAN = 10**9
# Window position cap: the seed sieve needs isqrt(hi) memory (a 10**14
# ceiling keeps it at ~10 MB). Windows beyond that need a segmented seed
# sieve — out of scope for an inspection tool.
MAX_HI = 10**14
_SLICE = 1 << 24  # values per internal slice


def primes_in_range(
    packing: str,
    lo: int,
    hi: int,
    *,
    bounds: Sequence[int] | None = None,
    flags_fn: Callable[[int, int], "np.ndarray | None"] | None = None,
) -> Iterator[np.ndarray]:
    """Yield ascending int64 arrays of the primes in [lo, hi).

    Streams one array per internal slice so callers can print without
    holding the whole result. Bounds are validated eagerly (before the
    first yield), so callers can start writing output once this returns.

    The query service (sieve_torch/service/) plugs in here: ``bounds`` is an
    ascending sequence of segment boundaries the internal slices must not
    straddle (so a cached whole-segment bitset can be bit-sliced per
    slice), and ``flags_fn(slo, shi)`` may return the candidate-flag
    array for a slice — returning ``None`` falls back to the local
    numpy marking for that slice.
    """
    lo = max(lo, 2)
    if hi > lo + MAX_SPAN:
        raise ValueError(
            f"enumeration span {hi - lo} exceeds {MAX_SPAN}; "
            "narrow the window (counting scales, enumeration is for windows)"
        )
    if hi > MAX_HI:
        raise ValueError(
            f"enumeration window ends at {hi} > {MAX_HI}: the seed sieve "
            "for that offset would need isqrt(hi) memory"
        )
    return _primes_in_range_gen(packing, lo, hi, bounds, flags_fn)


def _slices(
    lo: int, hi: int, bounds: Sequence[int] | None
) -> Iterator[tuple[int, int]]:
    """Cut [lo, hi) at every interior bound, then sub-chunk by _SLICE."""
    cuts = [lo]
    if bounds:
        i = bisect.bisect_right(bounds, lo)
        while i < len(bounds) and bounds[i] < hi:
            cuts.append(int(bounds[i]))
            i += 1
    cuts.append(hi)
    for clo, chi in zip(cuts, cuts[1:]):
        for slo in range(clo, chi, _SLICE):
            yield slo, min(slo + _SLICE, chi)


def _primes_in_range_gen(
    packing: str,
    lo: int,
    hi: int,
    bounds: Sequence[int] | None = None,
    flags_fn: Callable[[int, int], "np.ndarray | None"] | None = None,
) -> Iterator[np.ndarray]:
    if hi <= lo:
        return
    layout = get_layout(packing)
    seeds = None
    for slo, shi in _slices(lo, hi, bounds):
        flags = flags_fn(slo, shi) if flags_fn is not None else None
        if flags is None:
            if seeds is None:
                seeds = seed_primes(math.isqrt(hi - 1))
            flags = sieve_segment_flags(packing, slo, shi, seeds)
        vals = layout.values_np(slo, np.nonzero(flags)[0])
        extras = np.array(
            [p for p in layout.extra_primes if slo <= p < shi], dtype=np.int64
        )
        if extras.size:
            vals = np.concatenate([extras, vals])
        yield vals
