"""Host-side computation of marking specs (numpy-vectorized, O(#primes)).

A spec (m, r) over a segment's bit space clears every flag bit b with
b % m == r. Marking is start-free: the "start at p^2" bound is ignored,
because every bit below it is a composite a smaller prime marks anyway —
except a seed prime's own bit when the seed lies inside the segment,
which the self-mark corrections re-set afterwards.
"""

from __future__ import annotations

import numpy as np

from sieve_torch.bitset import _W30_IDX, WHEEL30_RESIDUES, get_layout

# modular inverses of the units mod 30 (u * inv == 1 mod 30)
_W30_INV = {1: 1, 7: 13, 11: 11, 13: 7, 17: 23, 19: 19, 23: 17, 29: 29}
_W30_INV_ARR = np.zeros(30, dtype=np.int64)
for _u, _v in _W30_INV.items():
    _W30_INV_ARR[_u] = _v


def _w30_idx(res: np.ndarray) -> np.ndarray:
    return _W30_IDX[res]


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
