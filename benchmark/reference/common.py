"""Seed primes, the segment plan and pi(N), in plain NumPy."""

from __future__ import annotations

import math

import numpy as np


def seed_primes(limit: int) -> np.ndarray:
    """All primes p <= limit, ascending, int64 (a plain sieve)."""
    limit = int(limit)
    if limit < 2:
        return np.zeros(0, np.int64)
    flags = np.ones(limit + 1, bool)
    flags[:2] = False
    for p in range(2, math.isqrt(limit) + 1):
        if flags[p]:
            flags[p * p :: p] = False
    return np.flatnonzero(flags).astype(np.int64)


def plan(n: int, k: int) -> list[tuple[int, int]]:
    """The k half-open segments [lo, hi) that tile [2, n + 1): interior
    bounds at 2 + span*i//k, rounded down to even so that a pair of odd
    neighbours never changes segment with the count (the rule the
    README's ``--segments`` and ``--rounds`` promise)."""
    span = n + 1 - 2
    k = max(1, min(k, span))
    bounds = [2]
    for i in range(1, k):
        bounds.append(max(bounds[-1], (2 + span * i // k) // 2 * 2))
    bounds.append(n + 1)
    return [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]


def prime_pi(n: int) -> int:
    """pi(n) by the Lucy-Hedgehog recursion: S(v) = #primes <= v for every
    v = n // i, sieved prime by prime. O(n^(3/4)) work, no sieve array."""
    if n < 2:
        return 0
    r = math.isqrt(n)
    small = np.arange(-1, r, dtype=np.int64)            # small[v] = S(v), v <= r
    large = n // np.arange(1, r + 1, dtype=np.int64) - 1  # large[i-1] = S(n // i)
    for p in range(2, r + 1):
        if small[p] == small[p - 1]:
            continue                                     # p is composite
        sp = int(small[p - 1])
        p2 = p * p
        lim = min(r, n // p2)
        ip = np.arange(1, lim + 1, dtype=np.int64) * p
        inner = np.where(ip <= r, large[np.minimum(ip, r) - 1],
                         small[np.minimum(n // ip, r)])
        large[:lim] -= inner - sp
        if p2 <= r:
            v = np.arange(p2, r + 1, dtype=np.int64)
            small[p2:] -= small[v // p] - sp
    return int(large[0])
