"""Bit-packed segment layouts: plain / odds-only / wheel-30.

The value <-> bit maps the whole port shares (a copy of the reference's
``sieve/bitset.py`` layouts, kept here so the port imports nothing of it):

  - plain:   bit b of a segment starting at lo  <->  value lo + b
  - odds:    bit b of a segment whose first odd is f  <->  value f + 2b;
             a prime stride p in value space is stride p in bit space
  - wheel30: candidates are v with v % 30 in {1,7,11,13,17,19,23,29};
             global flag index of v is 8*(v//30) + RES_IDX[v % 30];
             each prime marks along 8 residue-class progressions with
             bit stride 8p (v += 30p  =>  gidx += 8p)

A layout exposes only *candidate* values; primes it cannot represent
(2 for odds; 2, 3, 5 for wheel30) are ``extra_primes`` handled by the
worker/merge layers. Flags are boolean, True = "still possibly prime";
packed words are uint32 with bit k of word w = flag[32*w + k].
"""

from __future__ import annotations

import numpy as np

WORD_BITS = 32

WHEEL30_RESIDUES = (1, 7, 11, 13, 17, 19, 23, 29)
_W30_IDX = np.full(30, -1, dtype=np.int64)
for _i, _r in enumerate(WHEEL30_RESIDUES):
    _W30_IDX[_r] = _i


class Layout:
    """Candidate-value <-> bit-index map plus the numpy marking recipe."""

    name: str = ""
    extra_primes: tuple[int, ...] = ()
    wheel_primes: tuple[int, ...] = ()  # seed primes that must NOT mark

    # --- candidate/value mapping -------------------------------------------------
    def is_candidate(self, v: int) -> bool:
        raise NotImplementedError

    def gidx(self, v: int) -> int:
        """Global flag index of candidate v (monotonic over candidates)."""
        raise NotImplementedError

    def gidx_np(self, v: np.ndarray) -> np.ndarray:
        """Vectorized gidx over an int64 array of candidate values."""
        raise NotImplementedError

    def first_candidate(self, lo: int) -> int:
        """Smallest candidate value >= lo."""
        raise NotImplementedError

    def nbits(self, lo: int, hi: int) -> int:
        """Number of candidate values in [lo, hi)."""
        f = self.first_candidate(lo)
        if f >= hi:
            return 0
        l = self.last_candidate(hi)
        return self.gidx(l) - self.gidx(f) + 1

    def last_candidate(self, hi: int) -> int:
        """Largest candidate value < hi (requires one to exist)."""
        v = hi - 1
        while not self.is_candidate(v):
            v -= 1
        return v

    def bit_of(self, v: int, lo: int) -> int:
        """Segment-local bit index of candidate v in segment starting at lo."""
        return self.gidx(v) - self.gidx(self.first_candidate(lo))

    def candidates(self, lo: int, hi: int) -> np.ndarray:
        """All candidate values in [lo, hi) — small segments / tests only."""
        v = np.arange(lo, hi, dtype=np.int64)
        return v[[self.is_candidate(int(x)) for x in v]]

    def values_np(self, lo: int, bit_idx: np.ndarray) -> np.ndarray:
        """Candidate values at segment-local bit indices (vectorized inverse
        of bit_of; used by prime enumeration)."""
        raise NotImplementedError

    # --- marking -----------------------------------------------------------------
    def mark_numpy(self, flags: np.ndarray, lo: int, hi: int, p: int) -> None:
        """Clear composite bits for prime p (p not in wheel_primes).

        Marks multiples p*m with m >= p (i.e. from p^2 up), restricted to
        candidates in [lo, hi), from ``start = max(p*p, ceil(lo/p)*p)``.
        """
        raise NotImplementedError

    def extras_in(self, lo: int, hi: int) -> int:
        return sum(1 for p in self.extra_primes if lo <= p < hi)

    def extra_pairs(self, lo: int, hi: int, gap: int = 2) -> int:
        """Prime pairs (v, v+gap) invisible to this packing's flag array
        because a member is a wheel prime (wheel30: (3,5)/(5,7) for twins,
        (3,7) for cousins). Counted when lo <= v and v+gap < hi."""
        return 0

    # --- prime pairs -------------------------------------------------------------
    def pairs_internal(self, flags: np.ndarray, lo: int, hi: int,
                       gap: int = 2) -> int:
        """Pairs (v, v+gap) both prime with v, v+gap in [lo, hi); gap is 2
        (twins) or 4 (cousins). Includes pairs involving extra primes."""
        raise NotImplementedError


class PlainLayout(Layout):
    """One bit per integer. bit b <-> value lo + b."""

    name = "plain"
    extra_primes = ()
    wheel_primes = ()

    def is_candidate(self, v: int) -> bool:
        return v >= 2

    def gidx(self, v: int) -> int:
        return v

    def gidx_np(self, v: np.ndarray) -> np.ndarray:
        return v.astype(np.int64)

    def first_candidate(self, lo: int) -> int:
        return max(lo, 2)

    def last_candidate(self, hi: int) -> int:
        return hi - 1

    def mark_numpy(self, flags: np.ndarray, lo: int, hi: int, p: int) -> None:
        first = self.first_candidate(lo)
        start = max(p * p, -(-lo // p) * p)
        if start >= hi:
            return
        flags[start - first :: p] = False

    def values_np(self, lo: int, bit_idx: np.ndarray) -> np.ndarray:
        return self.first_candidate(lo) + bit_idx.astype(np.int64)

    def pairs_internal(self, flags: np.ndarray, lo: int, hi: int,
                       gap: int = 2) -> int:
        if flags.size <= gap:
            # fall back to direct check on tiny segments
            return _pairs_direct(self, flags, lo, hi, gap)
        return int(np.count_nonzero(flags[:-gap] & flags[gap:]))


class OddsLayout(Layout):
    """One bit per odd integer (the default packing).

    Segment of nbits odd values starting at odd f: bit b <-> value f + 2b.
    """

    name = "odds"
    extra_primes = (2,)
    wheel_primes = (2,)

    def is_candidate(self, v: int) -> bool:
        return v >= 3 and v % 2 == 1

    def gidx(self, v: int) -> int:
        return (v - 3) // 2

    def gidx_np(self, v: np.ndarray) -> np.ndarray:
        return (v.astype(np.int64) - 3) // 2

    def first_candidate(self, lo: int) -> int:
        lo = max(lo, 3)
        return lo if lo % 2 == 1 else lo + 1

    def last_candidate(self, hi: int) -> int:
        v = hi - 1
        return v if v % 2 == 1 else v - 1

    def mark_numpy(self, flags: np.ndarray, lo: int, hi: int, p: int) -> None:
        first = self.first_candidate(lo)
        start = max(p * p, -(-lo // p) * p)
        if start % 2 == 0:
            start += p
        if start >= hi:
            return
        b0 = (start - first) // 2
        flags[b0::p] = False  # stride p in value space == stride p in bit space

    def values_np(self, lo: int, bit_idx: np.ndarray) -> np.ndarray:
        return self.first_candidate(lo) + 2 * bit_idx.astype(np.int64)

    def pairs_internal(self, flags: np.ndarray, lo: int, hi: int,
                       gap: int = 2) -> int:
        b = gap // 2  # value gap 2k == bit gap k in the odds layout
        if flags.size < b + 1:
            return 0
        return int(np.count_nonzero(flags[:-b] & flags[b:]))


class Wheel30Layout(Layout):
    """One bit per v coprime to 30. gidx(v) = 8*(v//30) + RES_IDX[v%30]."""

    name = "wheel30"
    extra_primes = (2, 3, 5)
    wheel_primes = (2, 3, 5)

    def is_candidate(self, v: int) -> bool:
        return v > 1 and _W30_IDX[v % 30] >= 0

    def gidx(self, v: int) -> int:
        return 8 * (v // 30) + int(_W30_IDX[v % 30])

    def gidx_np(self, v: np.ndarray) -> np.ndarray:
        v = v.astype(np.int64)
        return 8 * (v // 30) + _W30_IDX[v % 30]

    def first_candidate(self, lo: int) -> int:
        lo = max(lo, 7)  # 1 is a unit, not a candidate; first real candidate is 7
        v = lo
        while not self.is_candidate(v):
            v += 1
        return v

    def mark_numpy(self, flags: np.ndarray, lo: int, hi: int, p: int) -> None:
        first = self.first_candidate(lo)
        g0 = self.gidx(first)
        pinv = pow(p, -1, 30)
        m_lo = max(p, -(-lo // p))
        for r in WHEEL30_RESIDUES:
            c = (r * pinv) % 30  # m residue class whose multiples land on r
            m0 = m_lo + ((c - m_lo) % 30)
            v0 = p * m0
            if v0 >= hi:
                continue
            b0 = self.gidx(v0) - g0
            flags[b0 :: 8 * p] = False  # v += 30p  =>  gidx += 8p

    def values_np(self, lo: int, bit_idx: np.ndarray) -> np.ndarray:
        res = np.array(WHEEL30_RESIDUES, dtype=np.int64)
        g = self.gidx(self.first_candidate(lo)) + bit_idx.astype(np.int64)
        return 30 * (g // 8) + res[g % 8]

    # residue indices whose gidx-NEXT candidate sits exactly `gap` above:
    # gap=2 -> (11,13), (17,19), (29,31); gap=4 -> (7,11), (13,17), (19,23)
    _PAIR_IDX = {2: (2, 4, 7), 4: (1, 3, 5)}

    def pairs_internal(self, flags: np.ndarray, lo: int, hi: int,
                       gap: int = 2) -> int:
        # Candidate pairs differing by `gap` are exactly gidx-adjacent with
        # the left member's residue index in _PAIR_IDX[gap].
        idxset = self._PAIR_IDX[gap]
        total = 0
        if flags.size >= 2:
            first = self.first_candidate(lo)
            g0 = self.gidx(first)
            pos = np.arange(flags.size - 1, dtype=np.int64)
            resind = (g0 + pos) % 8
            pairmask = np.isin(resind, idxset)
            total += int(np.count_nonzero(flags[:-1] & flags[1:] & pairmask))
        return total + self.extra_pairs(lo, hi, gap)

    def extra_pairs(self, lo: int, hi: int, gap: int = 2) -> int:
        # Pairs involving the always-prime wheel primes 3, 5:
        # twins (3,5), (5,7); cousins (3,7).
        total = 0
        if gap == 2:
            if lo <= 3 and 5 < hi:
                total += 1
            if lo <= 5 and 7 < hi:
                total += 1
        elif gap == 4:
            if lo <= 3 and 7 < hi:
                total += 1
        return total


def _pairs_direct(layout: Layout, flags: np.ndarray, lo: int, hi: int,
                  gap: int = 2) -> int:
    """O(candidates) direct pair count for tiny segments."""
    vals = layout.candidates(lo, hi)
    primeset = {int(v) for v, f in zip(vals, flags[: vals.size]) if f}
    primeset |= {p for p in layout.extra_primes if lo <= p < hi}
    return sum(1 for v in primeset if v + gap in primeset)


LAYOUTS: dict[str, Layout] = {
    "plain": PlainLayout(),
    "odds": OddsLayout(),
    "wheel30": Wheel30Layout(),
}


def get_layout(name: str) -> Layout:
    return LAYOUTS[name]


# --- packing -------------------------------------------------------------------


def pack_words(flags: np.ndarray) -> np.ndarray:
    """Pack boolean flags into uint32 words, bit k of word w = flag[32w+k]."""
    nbits = flags.size
    pad = (-nbits) % WORD_BITS
    if pad:
        flags = np.concatenate([flags, np.zeros(pad, dtype=bool)])
    return np.packbits(flags, bitorder="little").view("<u4")


def unpack_words(words: np.ndarray, nbits: int) -> np.ndarray:
    """Inverse of pack_words."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return bits[:nbits].astype(bool)


def boundary_words(flags: np.ndarray) -> tuple[int, int]:
    """(first_word, last_word) of a flag array.

    first_word bit k = flag[k]; last_word bit k = flag[nbits-32+k] for
    nbits >= 32, else last_word == first_word. These are the boundary
    bitwords the coordinator's merge uses for cross-segment pairs.
    """
    nbits = flags.size
    if nbits == 0:
        return 0, 0
    words = pack_words(flags)
    first_word = int(words[0])
    if nbits <= WORD_BITS:
        return first_word, first_word
    start = nbits - WORD_BITS
    w0, sh = divmod(start, WORD_BITS)
    if sh == 0:
        last_word = int(words[w0])
    else:
        hi_part = int(words[w0 + 1]) << (WORD_BITS - sh) if w0 + 1 < words.size else 0
        last_word = ((int(words[w0]) >> sh) | hi_part) & 0xFFFFFFFF
    return first_word, last_word


def popcount_words(words: np.ndarray) -> int:
    """Population count of a uint32 word array (byte lookup)."""
    return int(np.unpackbits(words.view(np.uint8)).sum())


# --- wheel-210 value-space codec ---------------------------------------------
#
# The tiered segment store compresses prime sets in *value* space with a
# mod-210 wheel: 48 of every 210 integers are coprime to 2*3*5*7, so a
# set of primes >= 11 over [lo, hi) costs 48 bits (6 bytes) per
# 210-block regardless of which flag layout materialized it. The four
# wheel primes {2, 3, 5, 7} cannot be represented on the wheel and ride
# in a 4-bit side mask. The codec is the reference's, bit for bit.

WHEEL210_RESIDUES = tuple(
    r for r in range(210)
    if r % 2 and r % 3 and r % 5 and r % 7
)
assert len(WHEEL210_RESIDUES) == 48
_W210_IDX = np.full(210, -1, dtype=np.int64)
for _i, _r in enumerate(WHEEL210_RESIDUES):
    _W210_IDX[_r] = _i
_W210_RES = np.array(WHEEL210_RESIDUES, dtype=np.int64)
_W210_SMALL = (2, 3, 5, 7)


def _w210_nbits(lo: int, hi: int) -> int:
    if hi <= lo:
        return 0
    return 48 * ((hi - 1) // 210 - lo // 210 + 1)


def pack_wheel210(lo: int, hi: int, values: np.ndarray) -> tuple[bytes, int]:
    """Pack a set of prime values in [lo, hi) -> (payload, small_mask).

    ``values`` must all be prime (every value >= 11 must be coprime to
    210 — a composite candidate that survived would be silently lost, so
    this raises instead). ``small_mask`` bit i records the presence of
    ``(2, 3, 5, 7)[i]``. Payload is 6 bytes per 210-block covering
    [lo, hi), bit ``48*(v//210 - lo//210) + idx(v % 210)`` = v present.
    """
    values = np.asarray(values, dtype=np.int64)
    small_mask = 0
    for i, p in enumerate(_W210_SMALL):
        if np.any(values == p):
            small_mask |= 1 << i
    wl = values[values >= 11]
    res_idx = _W210_IDX[wl % 210]
    if res_idx.size and int(res_idx.min()) < 0:
        bad = wl[res_idx < 0][:3]
        raise ValueError(
            f"pack_wheel210: non-prime values {bad.tolist()} share a factor "
            "with 210 and cannot ride the wheel"
        )
    nbits = _w210_nbits(lo, hi)
    bits = np.zeros(nbits, dtype=bool)
    bits[48 * (wl // 210 - lo // 210) + res_idx] = True
    return np.packbits(bits, bitorder="little").tobytes(), small_mask


def unpack_wheel210(lo: int, hi: int, payload: bytes,
                    small_mask: int) -> np.ndarray:
    """Inverse of pack_wheel210: sorted int64 prime values in [lo, hi)."""
    nbits = _w210_nbits(lo, hi)
    need = (nbits + 7) // 8
    if len(payload) < need:
        raise ValueError(
            f"unpack_wheel210: payload {len(payload)}B < {need}B "
            f"for [{lo}, {hi})"
        )
    bits = np.unpackbits(
        np.frombuffer(payload, dtype=np.uint8), bitorder="little"
    )[:nbits]
    g = np.flatnonzero(bits)
    vals = 210 * (lo // 210 + g // 48) + _W210_RES[g % 48]
    small = np.array(
        [p for i, p in enumerate(_W210_SMALL) if small_mask >> i & 1],
        dtype=np.int64,
    )
    if small.size:
        vals = np.concatenate([small, vals])
    return vals[(vals >= lo) & (vals < hi)]
