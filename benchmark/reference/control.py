"""The control: the reference in the program's place with one guarantee
broken, so that the comparison is shown to fail on a near miss.

The configuration guarantees exact counts, which needs every prime up to
sqrt(hi) as a seed. The control sieves each segment without the largest
seed p whose square lies below the segment's end. Then p*p, when it lies
in the segment, counts as a prime, and below it so do the products p*q
for the primes q in [lo/p, hi/p): every segment reads at least one prime
too many, and a 10^9-value segment near 10^11 a few hundred.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import packing


def dropped_seed(seeds: np.ndarray, hi: int) -> int:
    """The seed the control leaves out of segment [lo, hi)."""
    below = seeds[seeds * seeds < hi]
    return int(below[-1])


def summarize(packing_name: str, lo: int, hi: int, seeds: np.ndarray,
              gap: int) -> dict:
    """The control's answers for one segment."""
    p = dropped_seed(seeds, hi)
    return packing(packing_name).summarize(lo, hi, seeds[seeds != p], gap)
