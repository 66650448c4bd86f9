"""Seed-prime sieve: primes <= sqrt(N), computed once on the host.

For N=1e12 the seed set is pi(1e6) = 78,498 primes (~628 KB as int64),
so a plain numpy sieve is the right tool. ``seed_primes`` memoizes its
last few results; cached arrays are returned read-only so one caller
cannot corrupt another's view.
"""

from __future__ import annotations

import collections
import math
import numpy as np

from sieve_torch.analysis.lockdebug import named_lock

_CACHE_SIZE = 8  # distinct limits kept (largest seed set ~628 KB at 1e7)
_cache: "collections.OrderedDict[int, np.ndarray]" = collections.OrderedDict()
_cache_lock = named_lock("seed._cache_lock")


def seed_primes(limit: int) -> np.ndarray:
    """All primes p <= limit, ascending, as int64 (read-only array).

    Plain (non-segmented) Sieve of Eratosthenes; O(limit) memory as bool.
    Memoized on ``limit`` (small LRU); results are bit-exact vs uncached.
    """
    limit = int(limit)
    with _cache_lock:
        hit = _cache.get(limit)
        if hit is not None:
            _cache.move_to_end(limit)
            return hit
    primes = _seed_primes_uncached(limit)
    primes.setflags(write=False)
    with _cache_lock:
        _cache[limit] = primes
        _cache.move_to_end(limit)
        while len(_cache) > _CACHE_SIZE:
            _cache.popitem(last=False)
    return primes


def _seed_primes_uncached(limit: int) -> np.ndarray:
    if limit < 2:
        return np.zeros(0, dtype=np.int64)
    flags = np.ones(limit + 1, dtype=bool)
    flags[:2] = False
    for p in range(2, math.isqrt(limit) + 1):
        if flags[p]:
            flags[p * p :: p] = False
    return np.nonzero(flags)[0].astype(np.int64)
