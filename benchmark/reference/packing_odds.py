"""The odds layout: one flag per odd value, in plain NumPy.

A segment [lo, hi) holds the odd values f, f + 2, ... below hi, where f is
the first odd value >= max(lo, 3); flag k is value f + 2k, set when that
value is prime. 2 has no flag and is counted apart. What a segment
answers, as the README's counting run defines it:

- ``count``: the primes in [lo, hi), 2 included when it lies there;
- ``twin_count``: the pairs (v, v + gap) of primes with both in [lo, hi);
- ``first_word``: flags 0..31 as bits 0..31; ``last_word``: flags
  nbits-32 .. nbits-1 as bits 0..31 (the first word again when nbits <=
  32). Pairs that straddle two segments are read from these words.
"""

from __future__ import annotations

import numpy as np

CHUNK = 1 << 24          # flags sieved at once: 16 MiB of bool
WHEEL_MAX = 17           # seeds laid down as one repeated pattern


def _odd_bounds(lo: int, hi: int) -> tuple[int, int]:
    f = max(lo, 3) | 1
    last = hi - 1 if (hi - 1) % 2 else hi - 2
    return f, (last - f) // 2 + 1 if last >= f else 0


def _flags(f: int, c0: int, c1: int, seeds: np.ndarray) -> np.ndarray:
    """Flags c0..c1-1 of the segment starting at odd f: every odd multiple
    p*m (m >= p) of an odd seed is cleared. The seeds up to 17 that are
    in ``seeds`` are laid down first as one repeated pattern (period
    3*5*...*17 flags), with the seeds themselves set again."""
    v0, vend = f + 2 * c0, f + 2 * c1
    wheel = seeds[(seeds > 2) & (seeds <= WHEEL_MAX)]
    if wheel.size:
        period = int(np.prod(wheel))
        v = v0 + 2 * np.arange(min(period, c1 - c0), dtype=np.int64)
        base = (v[:, None] % wheel[None, :] != 0).all(axis=1)
        flags = np.resize(base, c1 - c0)
        for q in wheel.tolist():
            if v0 <= q < vend:
                flags[(q - v0) // 2] = True
    else:
        flags = np.ones(c1 - c0, bool)
    odd = seeds[(seeds > WHEEL_MAX) & (seeds * seeds < vend)]
    start = np.maximum(odd * odd, -(-v0 // odd) * odd)
    start += np.where(start % 2 == 0, odd, 0)
    for p, s in zip(odd.tolist(), ((start - v0) // 2).tolist()):
        flags[s::p] = False
    return flags


def _word(bits: np.ndarray) -> int:
    return int(np.dot(bits.astype(np.int64), 1 << np.arange(bits.size, dtype=np.int64)))


def summarize(lo: int, hi: int, seeds: np.ndarray, gap: int,
              chunk: int = CHUNK) -> dict:
    """The segment's answers (module docstring), sieved chunk by chunk.
    ``seeds`` must hold every prime whose square is below hi that the
    sieve is to use; gap is 2 (twins), 4 (cousins) or 0 (no pairs)."""
    f, nbits = _odd_bounds(lo, hi)
    count = 1 if lo <= 2 < hi else 0
    pairs = 0
    b = gap // 2
    tail = np.zeros(0, bool)        # the last b flags of the chunk before
    head = np.zeros(0, bool)
    for c0 in range(0, nbits, chunk):
        c1 = min(c0 + chunk, nbits)
        flags = _flags(f, c0, c1, seeds)
        count += int(np.count_nonzero(flags))
        if b:
            both = np.concatenate([tail, flags])
            pairs += int(np.count_nonzero(both[:-b] & both[b:]))
            tail = both[-b:]
        if c0 == 0:
            head = flags[:32]
        last = flags
    if nbits == 0:
        return {"lo": lo, "hi": hi, "count": count, "twin_count": 0,
                "first_word": 0, "last_word": 0, "nbits": 0}
    if nbits > 32 and last.size < 32:   # the last chunk is short: refill it
        last = _flags(f, nbits - 32, nbits, seeds)
    first = _word(head)
    return {"lo": lo, "hi": hi, "count": count, "twin_count": pairs,
            "first_word": first,
            "last_word": first if nbits <= 32 else _word(last[-32:]),
            "nbits": nbits}


def boundary_words(lo: int, hi: int, seeds: np.ndarray) -> tuple[int, int, int]:
    """(first_word, last_word, nbits) of a segment without sieving it:
    each of the 64 edge values is tested against every seed."""
    f, nbits = _odd_bounds(lo, hi)
    if nbits == 0:
        return 0, 0, 0

    def word(c0: int) -> int:
        k = min(32, nbits - c0)
        v = f + 2 * (c0 + np.arange(k, dtype=np.int64))
        odd = seeds[seeds > 2]
        hit = (v[:, None] % odd[None, :] == 0) & (v[:, None] != odd[None, :])
        return _word(~hit.any(axis=1))

    first = word(0)
    return first, (first if nbits <= 32 else word(nbits - 32)), nbits


def straddles(left: dict, right: dict, n: int, gap: int) -> int:
    """Pairs (v, v + gap) of primes with v in ``left`` and v + gap in
    ``right`` (two neighbouring segments), read from their edge words."""
    hi = left["hi"]
    fl, _ = _odd_bounds(left["lo"], left["hi"])
    fr, _ = _odd_bounds(right["lo"], right["hi"])
    total = 0
    for v in range(hi - gap, hi):
        w = v + gap
        if v < max(left["lo"], 3) or w > n or v % 2 == 0:
            continue
        bit_l = (v - fl) // 2 - max(0, left["nbits"] - 32)
        bit_r = (w - fr) // 2
        if not (0 <= bit_l < 32 and 0 <= bit_r < 32):
            raise ValueError(f"segment too short for the pair ({v}, {w})")
        total += (left["last_word"] >> bit_l) & (right["first_word"] >> bit_r) & 1
    return total
