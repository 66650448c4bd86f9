"""Reference CPU backend: readable numpy segmented marking.

The plain recipe every other backend is held against. The ``cuda``
backend also hands it segments under MIN_DEVICE_BITS candidate bits.
"""

from __future__ import annotations

import time

import numpy as np

from sieve_torch import trace
from sieve_torch.bitset import boundary_words, get_layout
from sieve_torch.worker import SegmentResult, SieveWorker


def sieve_segment_flags(
    layout_name: str, lo: int, hi: int, seed_primes: np.ndarray
) -> np.ndarray:
    """Boolean candidate flags for [lo, hi) after marking all composites."""
    layout = get_layout(layout_name)
    nbits = layout.nbits(lo, hi)
    flags = np.ones(nbits, dtype=bool)
    if nbits == 0:
        return flags
    wheel = set(layout.wheel_primes)
    for p in seed_primes.tolist():
        if p in wheel:
            continue
        if p * p >= hi:
            break  # seeds ascend; no later prime can mark in [lo, hi)
        layout.mark_numpy(flags, lo, hi, p)
    return flags


class CpuNumpyWorker(SieveWorker):
    name = "cpu-numpy"

    def process_segment(
        self, lo: int, hi: int, seed_primes: np.ndarray, seg_id: int = 0
    ) -> SegmentResult:
        t0 = time.perf_counter()
        with trace.span("segment.mark", backend=self.name, seg=seg_id):
            layout = get_layout(self.config.packing)
            flags = sieve_segment_flags(self.config.packing, lo, hi, seed_primes)
            count = int(np.count_nonzero(flags)) + layout.extras_in(lo, hi)
            gap = self.config.pair_gap or 2
            twin_count = (
                layout.pairs_internal(flags, lo, hi, gap) if self.config.twins else 0
            )
            first_word, last_word = boundary_words(flags)
        return SegmentResult(
            seg_id=seg_id,
            lo=lo,
            hi=hi,
            count=count,
            twin_count=twin_count,
            first_word=first_word,
            last_word=last_word,
            nbits=int(flags.size),
            elapsed_s=time.perf_counter() - t0,
        )
