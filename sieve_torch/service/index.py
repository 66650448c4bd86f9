"""Hot index tier: the checkpoint ledger as a queryable store.

The reference's ``sieve/service/index.py``, on the port's own numpy
marking (``sieve_torch.backends.cpu_numpy``); like the reference it keeps
this plane on the host.

A sieved checkpoint dir holds one :class:`SegmentResult` per completed
segment — per-segment prime counts keyed on segment boundaries. Sorted,
that is a prefix-sum index: ``pi(boundary)`` is O(log segments) with no
bitset touched. Values strictly inside a segment need flags for the
partial chunk only; those are materialized by the local numpy marking in
bounded chunks and kept in an LRU so a repeated hot query re-sieves
nothing (lru_hits vs materialized counters make that provable).

Only the *contiguous* prefix of segments starting at ``base`` (2 for a
whole-range server, the shard's lower bound for a range-sharded one)
is indexed: a partially-sieved ledger may have holes (cluster
runs complete segments out of order), and a prefix count across a hole
would be wrong. Ranges past :attr:`SieveIndex.covered_hi` are the
server's cold tier.

Per-query bookkeeping travels in a :class:`QueryCtx`: which tiers were
touched (drives the ``source`` field and the index-hit counter), the
prefix answered so far (drives typed ``deadline_exceeded`` partials),
and the deadline hook called before every chunk of real work.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from sieve_torch import trace
from sieve_torch.analysis.lockdebug import named_lock
from sieve_torch.backends.cpu_numpy import sieve_segment_flags
from sieve_torch.bitset import get_layout
from sieve_torch.seed import seed_primes
from sieve_torch.worker import SegmentResult

# Materialization chunk: matches enumerate._SLICE so one chunk is always
# a modest allocation no matter how large the ledger's segments are.
INDEX_CHUNK = 1 << 24


@dataclasses.dataclass
class QueryCtx:
    """Per-request bookkeeping threaded through index and cold tiers."""

    # deadline hook: called before each chunk of real work; raises
    # DeadlineExceeded (server-defined) reading answered_hi/count_so_far
    check: Callable[[], None] | None = None
    # tier provenance for the reply's "source" and the hit counters
    index: bool = False
    lru_hit: bool = False
    store_hit: bool = False
    materialized: bool = False
    cold: bool = False
    cold_cached: bool = False
    # progress for typed partial answers (prefix [2, answered_hi) done)
    answered_hi: int = 2
    count_so_far: int = 0
    # admission lane: "hot" requests demote to the cold lane
    # when they discover a chunk needing a backend dispatch; "cold" (the
    # default) never demotes, so contexts built outside the server's
    # admission path are unaffected
    lane: str = "cold"

    def tick(self) -> None:
        if self.check is not None:
            self.check()

    def source(self) -> str:
        hot = (self.index or self.lru_hit or self.store_hit
               or self.materialized or self.cold_cached)
        if self.cold:
            return "mixed" if hot else "cold"
        return "index" if hot else "none"


class BitsetLRU:
    """Bounded cache of materialized flag arrays keyed on (lo, hi).

    ``on_evict(lo, hi, arr)`` fires for every capacity eviction — the
    tiered segment store's demotion hook: work leaves the
    cache, not the process. It is invoked *outside* the cache lock (so
    the store's own lock never nests under it) and must not raise (the
    index wraps it with an error counter)."""

    def __init__(self, capacity: int, on_evict=None):
        self.capacity = capacity
        self.on_evict = on_evict  # guard: none(reference swap only; the
        # follower re-points it at each new index's demoter — any
        # snapshot's demoter writes identical bytes for a given key)
        self._lock = named_lock("BitsetLRU._lock")
        self._cache: "collections.OrderedDict[tuple[int, int], np.ndarray]" = (
            collections.OrderedDict()
        )

    def get(self, lo: int, hi: int) -> np.ndarray | None:
        with self._lock:
            flags = self._cache.get((lo, hi))
            if flags is not None:
                self._cache.move_to_end((lo, hi))
            return flags

    def put(self, lo: int, hi: int, flags: np.ndarray) -> None:
        flags.setflags(write=False)
        evicted = []
        with self._lock:
            self._cache[(lo, hi)] = flags
            self._cache.move_to_end((lo, hi))
            while len(self._cache) > self.capacity:
                evicted.append(self._cache.popitem(last=False))
        on_evict = self.on_evict
        if on_evict is not None:
            for (elo, ehi), arr in evicted:
                on_evict(elo, ehi, arr)

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)


class SieveIndex:
    """Sorted segment-boundary index over a read-only ledger snapshot."""

    def __init__(
        self,
        packing: str,
        entries: dict[int, SegmentResult] | Sequence[SegmentResult],
        lru_segments: int = 32,
        lru: BitsetLRU | None = None,
        base: int = 2,
        store=None,
    ):
        self.packing = packing
        self.layout = get_layout(packing)
        # range-sharded servers anchor their contiguous prefix
        # at the shard's lower bound instead of 2; counts are then "primes
        # in [base, v)" and nth is "k-th prime >= base" — exactly the
        # shard-local semantics the router composes from cumulative totals
        self.base = max(2, int(base))
        segs = sorted(
            entries.values() if isinstance(entries, dict) else entries,
            key=lambda r: r.lo,
        )
        # contiguous prefix from base only — counts across a hole are wrong
        self.segments: list[SegmentResult] = []
        want_lo = self.base
        for r in segs:
            if r.lo != want_lo:
                break
            self.segments.append(r)
            want_lo = r.hi
        self.dropped_segments = len(segs) - len(self.segments)
        self._his = [r.hi for r in self.segments]
        self._prefix = np.cumsum(
            [r.count for r in self.segments], dtype=np.int64
        )
        # vectorized twins of _his / segment los for count_upto_batch:
        # one searchsorted row answers M boundaries at once
        self._his_np = np.asarray(self._his, dtype=np.int64)
        self._los_np = np.asarray(
            [r.lo for r in self.segments], dtype=np.int64
        )
        self.covered_hi = self._his[-1] if self.segments else self.base
        self.total_primes = int(self._prefix[-1]) if self.segments else 0
        self.bounds: list[int] = [r.lo for r in self.segments] + (
            [self.covered_hi] if self.segments else []
        )
        # live-follow: a refreshed index is handed the previous
        # snapshot's LRU so hot queries stay hot across swaps — flags
        # content depends only on (packing, lo, hi), never on ledger
        # entries, so cached chunks are exact under any snapshot
        self.lru = lru if lru is not None else BitsetLRU(lru_segments)
        # chunk prime-value arrays for count_upto_batch: same
        # (lo, hi) keys as the flags LRU, content equally snapshot-free
        self._pv = BitsetLRU(lru_segments)
        # tiered segment store: consulted on LRU misses
        # before sieving, fed by LRU evictions. Shared across snapshot
        # swaps exactly like the LRU (content keys on (packing, lo, hi))
        self.store = store  # guard: none(reference set at construction;
        # the follower hands every new index the same store object)
        self._stat_lock = named_lock("SieveIndex._stat_lock")
        self.lru_hits = 0  # guard: _stat_lock
        self.materialized = 0  # guard: _stat_lock
        self.store_hits = 0  # guard: _stat_lock
        self.store_errors = 0  # guard: _stat_lock
        if store is not None:
            self.lru.on_evict = self._demote_flags
            self._pv.on_evict = self._demote_values

    # --- store demotion ---------------------------------------

    def _demote_flags(self, lo: int, hi: int, flags: np.ndarray) -> None:
        """Eviction hook: a flag array leaves the LRU -> tier 2."""
        try:
            self.store.put_flags(lo, hi, flags, self.layout)
        except Exception:
            with self._stat_lock:
                self.store_errors += 1

    def _demote_values(self, lo: int, hi: int, values: np.ndarray) -> None:
        """Eviction hook for the prime-value cache (``_pv``)."""
        try:
            self.store.put_values(lo, hi, values, self.layout)
        except Exception:
            with self._stat_lock:
                self.store_errors += 1

    # --- flags -----------------------------------------------------------

    def get_flags(self, lo: int, hi: int, ctx: QueryCtx) -> np.ndarray:
        """Candidate flags for [lo, hi): LRU, else local sieve + cache.

        [lo, hi) must fit one materialization chunk; callers chunk via
        :meth:`chunks`. The deadline hook fires before a fresh sieve
        (cache hits are always allowed through — they are the point)."""
        flags = self.lru.get(lo, hi)
        if flags is not None:
            ctx.lru_hit = True
            with self._stat_lock:
                self.lru_hits += 1
            return flags
        if self.store is not None:
            flags = self.store.load_flags(lo, hi, self.layout)
            if flags is not None:
                ctx.store_hit = True
                with self._stat_lock:
                    self.store_hits += 1
                self.lru.put(lo, hi, flags)
                return flags
        ctx.tick()
        with trace.span("query.materialize", lo=lo, hi=hi):
            seeds = seed_primes(math.isqrt(hi - 1))
            flags = sieve_segment_flags(self.packing, lo, hi, seeds)
        ctx.materialized = True
        with self._stat_lock:
            self.materialized += 1
        self.lru.put(lo, hi, flags)
        return flags

    @staticmethod
    def chunks(lo: int, hi: int, chunk: int = INDEX_CHUNK):
        for clo in range(lo, hi, chunk):
            yield clo, min(clo + chunk, hi)

    def flags_for_slice(self, slo: int, shi: int, ctx: QueryCtx) -> np.ndarray | None:
        """enumerate.primes_in_range ``flags_fn``: serve a slice from the
        hot tier, or None when it lies past the covered range (the
        caller's cold tier takes over). Slices never straddle a segment
        boundary (the enumerate ``bounds`` contract), so a cached
        enclosing range can be bit-sliced exactly."""
        if shi > self.covered_hi or not self.segments:
            return None
        flags = self.lru.get(slo, shi)
        if flags is not None:
            ctx.lru_hit = True
            with self._stat_lock:
                self.lru_hits += 1
            return flags
        j = bisect.bisect_right(self.bounds, slo) - 1
        seg = self.segments[min(j, len(self.segments) - 1)]
        # materialize on the segment-aligned chunk grid count_upto uses:
        # one LRU/store key per chunk serves pi, count, and primes alike.
        # A per-query slice key would miss the tiered store (demotions
        # are chunk-keyed) and re-sieve ranges it already holds
        clo = seg.lo + (slo - seg.lo) // INDEX_CHUNK * INDEX_CHUNK
        chi = min(clo + INDEX_CHUNK, seg.hi)
        if shi <= chi:
            whole = self.get_flags(clo, chi, ctx)
            off = self.layout.nbits(clo, slo)
            return whole[off : off + self.layout.nbits(slo, shi)]
        if shi - slo > INDEX_CHUNK:
            return None  # oversized ask; let the caller sub-chunk
        return self.get_flags(slo, shi, ctx)  # chunk-straddling slice

    # --- prefix counts ---------------------------------------------------

    def count_upto(self, v: int, ctx: QueryCtx) -> int:
        """Primes in [base, v), for base <= v <= covered_hi.

        Boundary hits are pure O(log segments); interior values add a
        partial in-segment count over materialized chunks."""
        if v <= self.base:
            ctx.answered_hi = max(ctx.answered_hi, self.base)
            return 0
        if v > self.covered_hi:
            raise ValueError(
                f"count_upto({v}) beyond covered_hi={self.covered_hi}"
            )
        ctx.index = True
        j = bisect.bisect_right(self._his, v)
        base = int(self._prefix[j - 1]) if j else 0
        if j == len(self.segments) or v == self.segments[j].lo:
            ctx.answered_hi = max(ctx.answered_hi, v)
            ctx.count_so_far = max(ctx.count_so_far, base)
            return base
        seg = self.segments[j]
        ctx.count_so_far = max(ctx.count_so_far, base)
        # partial in-segment count: chunks are aligned from seg.lo so a
        # repeated hot query hits the same LRU keys. The final chunk is
        # materialized whole (up to the segment end, capped at one chunk)
        # and bit-sliced to v, again for key stability.
        total = base + self.layout.extras_in(seg.lo, v)
        for clo, chi in self.chunks(seg.lo, seg.hi):
            if clo >= v:
                break
            flags = self.get_flags(clo, chi, ctx)
            if chi > v:
                nb = self.layout.nbits(clo, v)
                total += int(np.count_nonzero(flags[:nb]))
            else:
                total += int(np.count_nonzero(flags))
            ctx.answered_hi = max(ctx.answered_hi, min(chi, v))
            ctx.count_so_far = max(ctx.count_so_far, total)
        return total

    def count_upto_batch(self, vs, ctx: QueryCtx) -> np.ndarray:
        """Prefix counts for MANY boundaries in one vectorized row
        (the batch op): ``out[i]`` = primes in [base, vs[i]).

        One ``np.searchsorted`` over the segment boundaries plus one
        gather over ``_prefix`` answers every segment-boundary hit —
        the per-value bisect/branch cost of M scalar ``count_upto``
        calls collapses into two array ops. Values that land strictly
        inside a segment are grouped by segment and answered one chunk
        at a time with a single searchsorted against the chunk's cached
        prime values (:meth:`_count_interior`) — no per-value popcount
        walk. Same domain contract as ``count_upto``: every value in
        [base, covered_hi]."""
        arr = np.asarray(list(vs), dtype=np.int64)
        out = np.zeros(arr.size, dtype=np.int64)
        if arr.size == 0:
            return out
        if int(arr.min()) < self.base:
            raise ValueError(
                f"count_upto_batch: value below base={self.base}"
            )
        if int(arr.max()) > self.covered_hi:
            raise ValueError(
                f"count_upto_batch: value beyond covered_hi="
                f"{self.covered_hi}"
            )
        if not self.segments:
            return out  # empty index: every legal v equals base
        ctx.index = True
        nseg = len(self.segments)
        j = np.searchsorted(self._his_np, arr, side="right")
        bases = np.where(j > 0, self._prefix[np.maximum(j - 1, 0)], 0)
        # boundary hit: v == covered_hi (j == nseg) or v == segments[j].lo
        lo_j = np.where(j >= nseg, np.int64(self.covered_hi),
                        self._los_np[np.minimum(j, nseg - 1)])
        boundary = (j >= nseg) | (arr == lo_j)
        out[boundary] = bases[boundary]
        hi_seen = int(arr[boundary].max()) if bool(boundary.any()) else 0
        ctx.answered_hi = max(ctx.answered_hi, hi_seen, self.base)
        if bool(boundary.any()):
            ctx.count_so_far = max(ctx.count_so_far,
                                   int(out[boundary].max()))
        interior = np.nonzero(~boundary)[0]
        if interior.size:
            ji = j[interior]
            for sj in np.unique(ji):
                sel = interior[ji == sj]
                self._count_interior(int(sj), arr[sel], out, sel, ctx)
        return out

    def _count_interior(self, sj: int, varr: np.ndarray, out: np.ndarray,
                        sel: np.ndarray, ctx: QueryCtx) -> None:
        """Answer a batch of strictly-interior values of segment ``sj``
        in one vectorized row per chunk.

        The scalar fallback (one :meth:`count_upto` per value) repeats a
        full-chunk popcount walk for every value — the dominant cost of
        a hot batch. Instead the chunk's set bits are mapped
        to their candidate *values* once (:meth:`_chunk_primes`, LRU'd),
        and every value landing in the chunk is answered by a single
        ``np.searchsorted`` against that sorted array. Chunk keys stay
        aligned from seg.lo exactly as in the scalar path, so the two
        paths share LRU entries and deadline/demotion semantics (the
        tick still fires inside :meth:`get_flags` before a fresh sieve).
        """
        seg = self.segments[sj]
        base = int(self._prefix[sj - 1]) if sj else 0
        totals = np.full(varr.size, base, dtype=np.int64)
        for p in self.layout.extra_primes:  # extras_in(seg.lo, v), vectorized
            if p >= seg.lo:
                totals += varr > p
        ci = (varr - seg.lo) // INDEX_CHUNK
        vmax = int(varr.max())
        running = 0  # popcount of full chunks already walked
        for c, (clo, chi) in enumerate(self.chunks(seg.lo, seg.hi)):
            if clo >= vmax:
                break
            pv = self._chunk_primes(clo, chi, ctx)
            msk = ci == c
            if bool(msk.any()):
                totals[msk] += running + np.searchsorted(
                    pv, varr[msk], side="left"
                )
                out[sel[msk]] = totals[msk]
                ctx.answered_hi = max(ctx.answered_hi, int(varr[msk].max()))
                ctx.count_so_far = max(ctx.count_so_far,
                                       int(totals[msk].max()))
            if chi <= vmax:  # later chunk still holds values: roll prefix
                running += pv.size
                ctx.answered_hi = max(ctx.answered_hi, chi)
                ctx.count_so_far = max(
                    ctx.count_so_far,
                    base + self.layout.extras_in(seg.lo, chi) + running,
                )

    def _chunk_primes(self, clo: int, chi: int, ctx: QueryCtx) -> np.ndarray:
        """Sorted prime values in chunk [clo, chi) (layout extras excluded):
        the chunk's set bits mapped through ``values_np``. Cached in a
        second LRU so a hot batch costs one searchsorted, not a popcount
        walk; a hit here is an LRU hit for provenance purposes."""
        pv = self._pv.get(clo, chi)
        if pv is not None:
            ctx.lru_hit = True
            with self._stat_lock:
                self.lru_hits += 1
            return pv
        flags = self.get_flags(clo, chi, ctx)
        pv = self.layout.values_np(clo, np.flatnonzero(flags))
        self._pv.put(clo, chi, pv)
        return pv

    # --- selection -------------------------------------------------------

    def nth(self, k: int, ctx: QueryCtx) -> int:
        """Value of the k-th prime (1-indexed), for 1 <= k <= total_primes."""
        if not 1 <= k <= self.total_primes:
            raise ValueError(f"nth({k}) outside indexed range")
        ctx.index = True
        j = int(np.searchsorted(self._prefix, k, side="left"))
        base = int(self._prefix[j - 1]) if j else 0
        seg = self.segments[j]
        r = k - base  # r-th prime within segment j
        # layout extras (2/3/5) always precede every candidate (>= 7 for
        # wheel30, >= 3 for odds) in any segment that contains them
        extras = [p for p in self.layout.extra_primes if seg.lo <= p < seg.hi]
        if r <= len(extras):
            return extras[r - 1]
        r -= len(extras)
        ctx.count_so_far = max(ctx.count_so_far, base + len(extras))
        for clo, chi in self.chunks(seg.lo, seg.hi):
            flags = self.get_flags(clo, chi, ctx)
            c = int(np.count_nonzero(flags))
            if r <= c:
                pos = np.nonzero(flags)[0][r - 1]
                return int(self.layout.values_np(clo, np.array([pos]))[0])
            r -= c
            ctx.count_so_far += c
            ctx.answered_hi = max(ctx.answered_hi, chi)
        raise AssertionError(
            f"segment {seg.seg_id} count={seg.count} disagrees with its "
            f"materialized flags — ledger/compute mismatch"
        )

    def stats(self) -> dict:
        with self._stat_lock:
            return {
                "segments": len(self.segments),
                "dropped_segments": self.dropped_segments,
                "covered_hi": self.covered_hi,
                "total_primes": self.total_primes,
                "lru_hits": self.lru_hits,
                "materialized": self.materialized,
                "store_hits": self.store_hits,
                "store_errors": self.store_errors,
                "lru_entries": len(self.lru),
            }
