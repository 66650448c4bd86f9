"""Host-side computation of marking specs (numpy-vectorized, O(#primes)).

A spec (m, r) over a segment's bit space clears every flag bit b with
b % m == r. The device kernels mark start-free: the "start at p^2" bound
is ignored, because every bit below it is a composite a smaller prime
marks anyway — except a seed prime's own bit when the seed lies inside
the segment, which the self-mark corrections re-set afterwards.
``marking_specs`` (and its incremental ``SpecChain``) keeps the start bit
s = max(p^2, lo) for the cpu-native backend's strided loop.

``prepare_tiered`` and its incremental ``TieredChain`` prepare a segment
for the word kernel (kernels/word_mark.py): tier-1 word patterns for the
small strides, tier-2 tables for the rest, corrections and the pair mask.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from sieve_torch.bitset import _W30_IDX, WHEEL30_RESIDUES, get_layout

# modular inverses of the units mod 30 (u * inv == 1 mod 30)
_W30_INV = {1: 1, 7: 13, 11: 11, 13: 7, 17: 23, 19: 19, 23: 17, 29: 29}
_W30_INV_ARR = np.zeros(30, dtype=np.int64)
for _u, _v in _W30_INV.items():
    _W30_INV_ARR[_u] = _v


def _w30_idx(res: np.ndarray) -> np.ndarray:
    return _W30_IDX[res]


@dataclasses.dataclass(frozen=True)
class SpecSet:
    """Marking specs for one segment: clear bits {b % m == r, b >= s}."""

    m: np.ndarray  # int32 [S] moduli (bit-space strides)
    r: np.ndarray  # int32 [S] residues
    s: np.ndarray  # int32 [S] start bits
    nbits: int

    @property
    def count(self) -> int:
        return int(self.m.size)


def marking_specs(
    packing: str, lo: int, hi: int, seeds: np.ndarray
) -> SpecSet:
    """Specs for marking all composites among candidates of [lo, hi):
    start = max(p^2, ceil(lo/p)*p), bumped into the candidate class."""
    layout = get_layout(packing)
    nbits = layout.nbits(lo, hi)
    if nbits >= 2**31:
        raise ValueError(f"segment too large: {nbits} bits >= 2^31")
    if nbits == 0:
        z = np.zeros(0, np.int32)
        return SpecSet(z, z, z, 0)
    p = seeds.astype(np.int64)
    if packing == "plain":
        p = p[p * p < hi]
        first = max(lo, 2)
        start = np.maximum(p * p, -(-lo // p) * p)
        keep = start < hi
        p, start = p[keep], start[keep]
        b0 = start - first
        m = p
    elif packing == "odds":
        p = p[(p > 2) & (p * p < hi)]
        first = layout.first_candidate(lo)
        start = np.maximum(p * p, -(-lo // p) * p)
        start = np.where(start % 2 == 0, start + p, start)
        keep = start < hi
        p, start = p[keep], start[keep]
        b0 = (start - first) // 2
        m = p
    elif packing == "wheel30":
        p = p[(p > 5) & (p * p < hi)]
        g0 = layout.gidx(layout.first_candidate(lo))
        pinv = _W30_INV_ARR[p % 30]
        res = np.array(WHEEL30_RESIDUES, dtype=np.int64)
        # grid over (prime, residue class): m-class c whose multiples hit r
        c = (res[None, :] * pinv[:, None]) % 30
        m_lo = np.maximum(p, -(-lo // p))[:, None]
        m0 = m_lo + (c - m_lo) % 30
        v0 = p[:, None] * m0
        keep = v0 < hi
        v0k = v0[keep]
        pk = np.broadcast_to(p[:, None], v0.shape)[keep]
        gid = 8 * (v0k // 30) + _w30_idx(v0k % 30)
        b0 = gid - g0
        m = 8 * pk
    else:
        raise ValueError(f"unknown packing {packing!r}")
    r = b0 % m
    return SpecSet(
        m=m.astype(np.int32),
        r=r.astype(np.int32),
        s=b0.astype(np.int32),
        nbits=nbits,
    )


class DeltaModCache:
    """``delta % m`` over a fixed stride vector, cached per distinct delta.

    Advancing a bit-space residue vector from one segment origin to the next
    is ``r' = (r - delta) mod m``; once ``delta % m`` is known that is a
    subtract plus one conditional add — no per-seed division. Contiguous
    equal-span segments share a handful of distinct deltas, so steady-state
    advancement costs O(1) vector ops per seed."""

    def __init__(self, m: np.ndarray):
        self.m = np.asarray(m, np.int64)
        self._dm: dict[int, np.ndarray] = {}

    def advance(self, r: np.ndarray, delta: int) -> np.ndarray:
        if delta == 0:
            return r
        dm = self._dm.get(delta)
        if dm is None:
            if len(self._dm) >= 64:  # bound the cache on erratic jump chains
                self._dm.clear()
            dm = self._dm[delta] = delta % self.m  # in [0, m) even for delta<0
        r = r - dm
        return np.where(r < 0, r + self.m, r)


class SpecChain:
    """Incremental ``marking_specs`` over a chain of segments.

    A seed prime's spec changes between segments only through the segment
    origin bit g0 = gidx(first_candidate(lo)): its residue advances as
    ``r' = (r - delta) mod m`` with delta = g0' - g0 (DeltaModCache). The
    start bound max(p^2, lo) is restored exactly from ``g_start``, the
    global bit of each spec's first admissible multiple (>= p^2), which is
    segment-independent and computed once. Each segment's output equals
    a from-scratch ``marking_specs``."""

    def __init__(self, packing: str, seeds: np.ndarray):
        self.packing = packing
        self.layout = get_layout(packing)
        p = seeds.astype(np.int64)
        if packing == "plain":
            self.m = p
            self._g_start = p * p  # gidx(v) == v for plain
        elif packing == "odds":
            p = p[p > 2]
            self.m = p
            self._g_start = (p * p - 3) // 2  # gidx(p^2), p odd => p^2 odd
        elif packing == "wheel30":
            p = p[p > 5]
            pinv = _W30_INV_ARR[p % 30]
            res = np.array(WHEEL30_RESIDUES, dtype=np.int64)
            c = (res[None, :] * pinv[:, None]) % 30
            # first admissible multiple per (prime, class): m0 >= p, m0 == c
            m0 = p[:, None] + (c - p[:, None]) % 30
            v0 = p[:, None] * m0
            gs = 8 * (v0 // 30) + _w30_idx(v0 % 30)
            self.m = np.repeat(8 * p, 8)
            self._g_start = gs.ravel()
        else:
            raise ValueError(f"unknown packing {packing!r}")
        self._dm = DeltaModCache(self.m)
        self._r: np.ndarray | None = None
        self._g0: int | None = None

    def residues(self, lo: int, hi: int) -> tuple[int, np.ndarray, np.ndarray]:
        """(nbits, r, s) over the FULL chain spec set, unfiltered: ``r`` is
        every spec's segment-local residue, ``s`` its start bit. A spec is
        live in this segment iff ``s < nbits``."""
        layout = self.layout
        nbits = layout.nbits(lo, hi)
        if nbits >= 2**31:
            raise ValueError(f"segment too large: {nbits} bits >= 2^31")
        g0 = layout.gidx(layout.first_candidate(lo))
        if self._r is None:
            self._r = (self._g_start - g0) % self.m  # one-time vectorized mod
        else:
            self._r = self._dm.advance(self._r, g0 - self._g0)
        self._g0 = g0
        s = np.where(self._g_start > g0, self._g_start - g0, self._r)
        return nbits, self._r, s

    def specs(self, lo: int, hi: int) -> SpecSet:
        """Drop-in replacement for ``marking_specs(packing, lo, hi, seeds)``."""
        if self.layout.nbits(lo, hi) == 0:
            z = np.zeros(0, np.int32)
            return SpecSet(z, z, z, 0)
        nbits, r, s = self.residues(lo, hi)
        keep = s < nbits
        return SpecSet(
            m=self.m[keep].astype(np.int32),
            r=r[keep].astype(np.int32),
            s=s[keep].astype(np.int32),
            nbits=nbits,
        )


# ---------------------------------------------------------------------------
# Tiered preparation for the word kernel (sieve_torch/kernels/word_mark.py).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TieredSegment:
    """Everything the word kernel needs for one segment, host-prepared."""

    nbits: int
    Wpad: int
    periods: tuple[int, ...]          # tier-1 pattern lengths (words)
    patterns: tuple[np.ndarray, ...]  # uint32, one per period, phase baked in
    m2: np.ndarray                    # int32 [S2] tier-2 moduli
    r2: np.ndarray                    # int32 [S2] tier-2 residues
    K2: np.ndarray                    # int32 [S2] y-offset multipliers
    rcp2: np.ndarray                  # float32 [S2] 1/m
    act2: np.ndarray                  # uint32 [S2] 0xFFFFFFFF real / 0 padding
    corr_idx: np.ndarray              # int32 [C] self-mark correction words
    corr_mask: np.ndarray             # uint32 [C] bits to re-set
    pair_mask: int                    # uint32 scalar: twin pairability

    def with_spec_count(self, target: int) -> "TieredSegment":
        """Re-pad the tier-2 spec arrays to `target` (shape bucketing)."""
        S = self.m2.size
        if target == S:
            return self
        if target < S:
            raise ValueError(f"cannot shrink {S} specs to {target}")
        pad = target - S
        K_pad = -(-32 * self.Wpad // _PAD_M)
        return dataclasses.replace(
            self,
            m2=np.concatenate([self.m2, np.full(pad, _PAD_M, np.int32)]),
            r2=np.concatenate([self.r2, np.zeros(pad, np.int32)]),
            K2=np.concatenate([self.K2, np.full(pad, K_pad, np.int32)]),
            rcp2=np.concatenate(
                [self.rcp2, np.full(pad, 1.0 / _PAD_M, np.float32)]
            ),
            act2=np.concatenate([self.act2, np.zeros(pad, np.uint32)]),
        )


_PAD_M = 1 << 20  # tier-2 padding modulus (inert: act2 == 0 masks its hits)

# Segment-size ceiling for the word kernel: 32*Wpad stays < 2^30, the
# reference's bound for its f32 reciprocal mod (the port's tier 2 keeps
# it so both packages refuse the same segments).
MAX_WORDS = 1 << 25


def tier1_specs(
    packing: str, lo: int, seeds: np.ndarray, tier1_max: int
) -> tuple[np.ndarray, np.ndarray]:
    """(m, r) for every seed prime with stride m <= tier1_max,
    *unconditionally* (no p^2 < hi cut): a prime with no crossings in the
    segment marks nothing in range, so including it is harmless and keeps
    the spec set identical for every segment of a run."""
    layout = get_layout(packing)
    f = layout.first_candidate(lo)
    p = seeds.astype(np.int64)
    if packing == "plain":
        p = p[p <= tier1_max]
        m = p
        r = (p - f % p) % p  # f + b == 0 (mod p)
    elif packing == "odds":
        p = p[(p > 2) & (p <= tier1_max)]
        m = p
        inv2 = (p + 1) // 2
        r = ((p - f % p) % p) * inv2 % p  # f + 2b == 0 (mod p)
    elif packing == "wheel30":
        p = p[(p > 5) & (8 * p <= tier1_max)]
        g0 = layout.gidx(f)
        pinv = _W30_INV_ARR[p % 30]
        res = np.array(WHEEL30_RESIDUES, dtype=np.int64)
        c = (res[None, :] * pinv[:, None]) % 30
        m_lo = np.maximum(1, -(-lo // p))[:, None]
        m0 = m_lo + (c - m_lo) % 30
        v0 = p[:, None] * m0  # smallest candidate multiple >= lo, per class
        gid = 8 * (v0 // 30) + _w30_idx(v0 % 30)
        b0 = (gid - g0).ravel()
        m = np.repeat(8 * p, 8)
        r = b0 % m
    else:
        raise ValueError(f"unknown packing {packing!r}")
    return m, r


def _tier1_patterns(
    m: np.ndarray, r: np.ndarray
) -> tuple[tuple[int, ...], tuple[np.ndarray, ...]]:
    """Periodic word patterns (marks=1) for small-stride specs, merged by
    period. Pattern word w covers bits [32w, 32w+32) of a buffer that tiles
    the segment exactly because 32*period == lcm(m, 32) == 0 (mod m)."""
    by_period: dict[int, np.ndarray] = {}
    for mi, ri in zip(m.tolist(), r.tolist()):
        period = mi // np.gcd(mi, 32)
        bits = np.zeros(32 * period, dtype=bool)
        bits[ri % mi :: mi] = True
        pat = np.packbits(bits, bitorder="little").view("<u4")
        if period in by_period:
            by_period[period] = by_period[period] | pat
        else:
            by_period[period] = pat
    periods = tuple(sorted(by_period))
    return periods, tuple(by_period[p] for p in periods)


def _merge_word_masks(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Merge non-negative bit indices into sorted per-word
    (word_idx, OR-mask) pairs: one argsort + ``np.bitwise_or.reduceat``,
    no python loop. Shared by ``_corrections`` and ``flat_crossings``."""
    words = bits >> 5
    masks = np.uint32(1) << (bits & 31).astype(np.uint32)
    order = np.argsort(words, kind="stable")
    ws, ms = words[order], masks[order]
    new = np.empty(ws.size, bool)
    new[0] = True
    new[1:] = ws[1:] != ws[:-1]
    grp = np.flatnonzero(new)
    return ws[grp].astype(np.int32), np.bitwise_or.reduceat(ms, grp)


def _corrections(
    packing: str, lo: int, hi: int, seeds: np.ndarray, pad_to: int = 32
) -> tuple[np.ndarray, np.ndarray]:
    """(word_idx, bitmask) pairs re-setting seed primes' own bits — the only
    bits start-free marking can wrongly clear. Grouped by word, padded
    with (0, 0) entries to a multiple of ``pad_to``."""
    layout = get_layout(packing)
    p = seeds[(seeds >= lo) & (seeds < hi)]
    for wp in layout.wheel_primes:
        p = p[p != wp]
    if p.size:
        g0 = layout.gidx(layout.first_candidate(lo))
        bits = layout.gidx_np(p) - g0
        idx, msk = _merge_word_masks(bits)
    else:
        idx = np.zeros(0, np.int32)
        msk = np.zeros(0, np.uint32)
    C = max(pad_to, -(-idx.size // pad_to) * pad_to)
    pad = C - idx.size
    return (
        np.concatenate([idx, np.zeros(pad, np.int32)]),
        np.concatenate([msk, np.zeros(pad, np.uint32)]),
    )


def flat_crossings(
    m: np.ndarray, r: np.ndarray, nbits: int, pad_to: int = 128
) -> tuple[np.ndarray, np.ndarray]:
    """Host-enumerated crossing list for very wide strides: every bit
    {r, r+m, r+2m, ...} < nbits of every spec, merged into per-word
    (word_idx, clear_mask) pairs. Same start-free contract as the kernel's
    stride groups (the seed's own bit is re-set by the corrections, which
    run after these clears).

    Padded with (0, 0) entries: a zero mask clears nothing.
    """
    m = np.asarray(m, np.int64)
    r = np.asarray(r, np.int64)
    counts = np.maximum(0, -(-(nbits - r) // np.maximum(m, 1)))
    tot = int(counts.sum())
    if tot:
        spec = np.repeat(np.arange(m.size), counts)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        offs = np.arange(tot) - np.repeat(starts, counts)
        bits = r[spec] + offs * m[spec]
        idx, msk = _merge_word_masks(bits)
    else:
        idx = np.zeros(0, np.int32)
        msk = np.zeros(0, np.uint32)
    F = max(pad_to, -(-idx.size // pad_to) * pad_to)
    pad = F - idx.size
    return (
        np.concatenate([idx, np.zeros(pad, np.int32)]),
        np.concatenate([msk, np.zeros(pad, np.uint32)]),
    )


# wheel30 residue indices whose gidx-NEXT neighbor sits `gap` above it:
# gap=2 -> (11,13), (17,19), (29,31); gap=4 -> (7,11), (13,17), (19,23).
_W30_PAIR_IDX = {2: (2, 4, 7), 4: (1, 3, 5)}


def _pair_mask(packing: str, lo: int, gap: int = 2) -> int:
    """uint32 mask of bit positions whose (b, b+shift) splice pair is a
    prime pair with difference ``gap`` (2 = twins, 4 = cousins)."""
    if packing != "wheel30":
        return 0xFFFFFFFF
    idxset = _W30_PAIR_IDX[gap]
    layout = get_layout(packing)
    g0 = layout.gidx(layout.first_candidate(lo))
    mask = 0
    for j in range(32):
        if (g0 + j) % 8 in idxset:
            mask |= 1 << j
    return mask


def _tier1_strides(packing: str, seeds: np.ndarray, tier1_max: int) -> np.ndarray:
    """The stride column of ``tier1_specs`` — lo-independent."""
    p = seeds.astype(np.int64)
    if packing == "plain":
        return p[p <= tier1_max]
    if packing == "odds":
        return p[(p > 2) & (p <= tier1_max)]
    if packing == "wheel30":
        p = p[(p > 5) & (8 * p <= tier1_max)]
        return np.repeat(8 * p, 8)
    raise ValueError(f"unknown packing {packing!r}")


def prepare_tiered(
    packing: str,
    lo: int,
    hi: int,
    seeds: np.ndarray,
    tier1_max: int,
    spec_block: int,
    word_bucket: int,
    pair_gap: int = 2,
) -> TieredSegment:
    """Host-side preparation of one segment for the word kernel."""
    specs = marking_specs(packing, lo, hi, seeds)
    nbits = specs.nbits
    W = -(-nbits // 32)
    Wpad = -(-(W + 1) // word_bucket) * word_bucket
    if Wpad > MAX_WORDS:
        raise ValueError(
            f"segment too large for word kernel: {nbits} bits "
            f"(> {32 * MAX_WORDS}); use more segments/rounds"
        )

    t1m, t1r = tier1_specs(packing, lo, seeds, tier1_max)
    periods, patterns = _tier1_patterns(t1m, t1r)

    big = specs.m > tier1_max
    m2 = specs.m[big].astype(np.int64)
    r2 = specs.r[big].astype(np.int64)
    S2 = int(m2.size)
    S2p = max(spec_block, -(-S2 // spec_block) * spec_block)
    pad = S2p - S2
    m2 = np.concatenate([m2, np.full(pad, _PAD_M, np.int64)])
    r2 = np.concatenate([r2, np.zeros(pad, np.int64)])
    act2 = np.concatenate(
        [np.full(S2, 0xFFFFFFFF, np.uint32), np.zeros(pad, np.uint32)]
    )
    K2 = -(-32 * Wpad // m2)
    rcp2 = (1.0 / m2).astype(np.float32)

    corr_idx, corr_mask = _corrections(packing, lo, hi, seeds)
    return TieredSegment(
        nbits=nbits,
        Wpad=Wpad,
        periods=periods,
        patterns=patterns,
        m2=m2.astype(np.int32),
        r2=r2.astype(np.int32),
        K2=K2.astype(np.int32),
        rcp2=rcp2,
        act2=act2,
        corr_idx=corr_idx,
        corr_mask=corr_mask,
        pair_mask=_pair_mask(packing, lo, pair_gap),
    )


class TieredChain:
    """Incremental ``prepare_tiered`` over a chain of segments.

    Stride-dependent structure is built once: the full spec stride vector
    and its tier-2 membership, the f32 reciprocals, the tier-1 stride set
    (so ``periods`` is known before any segment is prepared). Per segment
    only the residues advance (SpecChain / DeltaModCache) and the
    per-segment pieces are rebuilt: tier-1 patterns, the K2 column for the
    segment's Wpad (cached per Wpad), corrections, pair_mask. Output is
    identical to from-scratch ``prepare_tiered``."""

    def __init__(
        self,
        packing: str,
        seeds: np.ndarray,
        tier1_max: int,
        spec_block: int,
        word_bucket: int,
        pair_gap: int = 2,
    ):
        self.packing = packing
        self.seeds = seeds
        self.tier1_max = tier1_max
        self.spec_block = spec_block
        self.word_bucket = word_bucket
        self.pair_gap = pair_gap
        self.layout = get_layout(packing)
        self._spec = SpecChain(packing, seeds)
        self._big_idx = np.flatnonzero(self._spec.m > tier1_max)
        m2_all = self._spec.m[self._big_idx]
        self._m2_all = m2_all
        self.n_tier2 = int(m2_all.size)  # upper bound on any segment's live set
        self.phase_seconds = {"residue": 0.0, "group": 0.0, "corrections": 0.0}
        self.segments_prepared = 0
        self._rcp_all = (1.0 / m2_all).astype(np.float32)
        self._t1_m = _tier1_strides(packing, seeds, tier1_max)
        self.periods, _ = _tier1_patterns(
            self._t1_m, np.zeros_like(self._t1_m)
        )
        self._t1_r: np.ndarray | None = None
        self._t1_g0: int | None = None
        self._t1_dm = DeltaModCache(self._t1_m)
        self._K2_cache: dict[int, np.ndarray] = {}

    def _tier1_residues(self, lo: int) -> np.ndarray:
        g0 = self.layout.gidx(self.layout.first_candidate(lo))
        if self._t1_r is None:
            m1, self._t1_r = tier1_specs(
                self.packing, lo, self.seeds, self.tier1_max
            )
            assert m1.shape == self._t1_m.shape
        else:
            self._t1_r = self._t1_dm.advance(self._t1_r, g0 - self._t1_g0)
        self._t1_g0 = g0
        return self._t1_r

    def prepare(self, lo: int, hi: int) -> TieredSegment:
        t0 = time.perf_counter()
        nbits, r_full, s_full = self._spec.residues(lo, hi)
        W = -(-nbits // 32)
        Wpad = -(-(W + 1) // self.word_bucket) * self.word_bucket
        if Wpad > MAX_WORDS:
            raise ValueError(
                f"segment too large for word kernel: {nbits} bits "
                f"(> {32 * MAX_WORDS}); use more segments/rounds"
            )

        r1 = self._tier1_residues(lo)
        t1 = time.perf_counter()
        periods, patterns = _tier1_patterns(self._t1_m, r1)

        K_all = self._K2_cache.get(Wpad)
        if K_all is None:
            K_all = self._K2_cache[Wpad] = -(
                -32 * Wpad // self._m2_all.astype(np.int64)
            )
        live = s_full[self._big_idx] < nbits
        m2 = self._m2_all[live]
        S2 = int(m2.size)
        S2p = max(self.spec_block, -(-S2 // self.spec_block) * self.spec_block)
        pad = S2p - S2
        K_pad = -(-32 * Wpad // _PAD_M)
        m2 = np.concatenate([m2, np.full(pad, _PAD_M, np.int64)])
        r2 = np.concatenate([r_full[self._big_idx][live], np.zeros(pad, np.int64)])
        K2 = np.concatenate([K_all[live], np.full(pad, K_pad, np.int64)])
        rcp2 = np.concatenate(
            [self._rcp_all[live], np.full(pad, 1.0 / _PAD_M, np.float32)]
        )
        act2 = np.concatenate(
            [np.full(S2, 0xFFFFFFFF, np.uint32), np.zeros(pad, np.uint32)]
        )
        t2 = time.perf_counter()

        corr_idx, corr_mask = _corrections(self.packing, lo, hi, self.seeds)
        ph = self.phase_seconds
        ph["residue"] += t1 - t0
        ph["group"] += t2 - t1
        ph["corrections"] += time.perf_counter() - t2
        self.segments_prepared += 1
        return TieredSegment(
            nbits=nbits,
            Wpad=Wpad,
            periods=periods,
            patterns=patterns,
            m2=m2.astype(np.int32),
            r2=r2.astype(np.int32),
            K2=K2.astype(np.int32),
            rcp2=rcp2,
            act2=act2,
            corr_idx=corr_idx,
            corr_mask=corr_mask,
            pair_mask=_pair_mask(self.packing, lo, self.pair_gap),
        )
