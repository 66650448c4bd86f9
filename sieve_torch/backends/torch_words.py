"""torch backend: the word kernel (kernels/word_mark.py) on one device.

The counterpart of the reference's jax backend (sieve/backends/jax_backend.py).
It runs on ``config.device``: the card unless the caller asks for the
CPU, and a card that is not there raises (``resolve_device``). Segments
under MIN_DEVICE_BITS candidate bits go to the numpy backend, as in the
reference: their boundary words are a host-side concern, not a device
fallback.

``process_segments`` prepares every segment on the host, groups them by
the reference's shape key (Wpad, periods, S2, C bucket) and runs one
``mark_words_batch`` per group, so equal-span segments cost one batched
call.
"""

from __future__ import annotations

import time

import numpy as np

from sieve_torch import trace
from sieve_torch.backends.cpu_numpy import CpuNumpyWorker
from sieve_torch.backends.cuda import resolve_device
from sieve_torch.bitset import get_layout
from sieve_torch.kernels.pairs import MIN_DEVICE_BITS, pair_kind
from sieve_torch.kernels.specs import TieredChain, TieredSegment, prepare_tiered
from sieve_torch.kernels.word_mark import (
    SPEC_BLOCK,
    TIER1_MAX,
    WORD_BUCKET,
    mark_words,
    mark_words_batch,
    next_pow2,
)
from sieve_torch.worker import SegmentResult, SieveWorker

_TIER2 = ("m2", "r2", "K2", "rcp2", "act2")


def prepare_segment(packing: str, lo: int, hi: int, seeds: np.ndarray):
    """Host prep with bucketed shapes; returns a TieredSegment."""
    ts = prepare_tiered(
        packing, lo, hi, seeds,
        tier1_max=TIER1_MAX, spec_block=SPEC_BLOCK, word_bucket=WORD_BUCKET,
    )
    # bucket the tier-2 spec count to a power of two, as the reference does
    return ts.with_spec_count(max(SPEC_BLOCK, next_pow2(ts.m2.size)))


def stack_tables(rows: list[TieredSegment], periods: tuple, c_pad: int) -> tuple:
    """The batched call's tables, each with a leading axis over ``rows``:
    nbits, patterns, the tier-2 columns, corrections padded to ``c_pad``
    and pair masks."""
    return (
        np.array([ts.nbits for ts in rows], np.int64),
        tuple(np.stack([ts.patterns[i] for ts in rows])
              for i in range(len(periods))),
        *(np.stack([getattr(ts, f) for ts in rows]) for f in _TIER2),
        np.stack([_pad_to(ts.corr_idx, c_pad, 0) for ts in rows]),
        np.stack([_pad_to(ts.corr_mask, c_pad, 0) for ts in rows]),
        np.array([ts.pair_mask for ts in rows], np.int64),
    )


class TorchWorker(SieveWorker):
    name = "torch"

    def __init__(self, config):
        super().__init__(config)
        self.device = resolve_device(config.device)
        self._cpu_fallback = CpuNumpyWorker(config)
        self._chain: TieredChain | None = None
        self._chain_seeds: np.ndarray | None = None

    def _prepare(self, packing: str, lo: int, hi: int, seeds: np.ndarray):
        """Incremental prepare: segments of one run arrive in order, so
        residues advance O(1) per seed (exact for any jump)."""
        if self._chain is None or self._chain_seeds is not seeds:
            self._chain = TieredChain(
                packing, seeds,
                tier1_max=TIER1_MAX, spec_block=SPEC_BLOCK,
                word_bucket=WORD_BUCKET,
                pair_gap=self.config.pair_gap or 2,
            )
            self._chain_seeds = seeds
            self.phase_seconds = self._chain.phase_seconds
        ts = self._chain.prepare(lo, hi)
        return ts.with_spec_count(max(SPEC_BLOCK, next_pow2(ts.m2.size)))

    def _result(self, seg_id: int, lo: int, hi: int, nbits: int, row,
                t0: float) -> SegmentResult:
        """A SegmentResult from one packed (count, pairs, first32, last32)."""
        layout = get_layout(self.config.packing)
        count, twins, first32, last32 = (int(v) for v in row)
        return SegmentResult(
            seg_id=seg_id,
            lo=lo,
            hi=hi,
            count=count + layout.extras_in(lo, hi),
            twin_count=(
                twins + layout.extra_pairs(lo, hi, self.config.pair_gap or 2)
                if self.config.twins else 0
            ),
            first_word=first32,
            last_word=last32,
            nbits=nbits,
            elapsed_s=time.perf_counter() - t0,
        )

    def process_segment(
        self, lo: int, hi: int, seed_primes: np.ndarray, seg_id: int = 0
    ) -> SegmentResult:
        t0 = time.perf_counter()
        packing = self.config.packing
        nbits = get_layout(packing).nbits(lo, hi)
        if nbits < MIN_DEVICE_BITS:
            return self._cpu_fallback.process_segment(lo, hi, seed_primes, seg_id)
        with trace.span("segment.prepare", backend=self.name, seg=seg_id):
            ts = self._prepare(packing, lo, hi, seed_primes)
        with trace.span("segment.device", backend=self.name, seg=seg_id):
            packed = mark_words(
                ts.Wpad, pair_kind(self.config), ts.periods, nbits, ts.patterns,
                ts.m2, ts.r2, ts.K2, ts.rcp2, ts.act2, ts.corr_idx, ts.corr_mask,
                ts.pair_mask, device=self.device,
            ).cpu()  # one int64[4] fetch: count, pairs, first32, last32
        return self._result(seg_id, lo, hi, nbits, packed.tolist(), t0)

    def _run_group(self, Wpad: int, periods: tuple, c_pad: int,
                   rows: list[TieredSegment]) -> np.ndarray:
        """One shape group's rows through one batched call: [B, 4]."""
        with trace.span("segment.device", backend=self.name, batch=len(rows)):
            return mark_words_batch(
                Wpad, pair_kind(self.config), periods,
                *stack_tables(rows, periods, c_pad), device=self.device,
            ).cpu().numpy()

    def process_segments(
        self,
        segments: list[tuple[int, int]],
        seed_primes: np.ndarray,
        seg_ids: list[int] | None = None,
    ) -> list[SegmentResult]:
        """Prepare every segment on the host, group by kernel shape, and
        run each group as ONE batched call. Equal to the sequential path
        by the shared marking code; sub-64-bit slivers go to the numpy
        backend exactly as ``process_segment`` sends them."""
        if seg_ids is None:
            seg_ids = list(range(len(segments)))
        if len(seg_ids) != len(segments):
            raise ValueError(
                f"process_segments: {len(segments)} segments but "
                f"{len(seg_ids)} seg_ids"
            )
        packing = self.config.packing
        layout = get_layout(packing)
        out: list[SegmentResult | None] = [None] * len(segments)
        # (Wpad, periods, S2, C bucket) -> [(pos, ts, t_start)]
        groups: dict[tuple, list[tuple[int, TieredSegment, float]]] = {}
        for pos, (lo, hi) in enumerate(segments):
            t0 = time.perf_counter()
            if layout.nbits(lo, hi) < MIN_DEVICE_BITS:
                out[pos] = self._cpu_fallback.process_segment(
                    lo, hi, seed_primes, seg_ids[pos]
                )
                continue
            with trace.span("segment.prepare", backend=self.name,
                            seg=seg_ids[pos]):
                ts = self._prepare(packing, lo, hi, seed_primes)
            c_pad = max(1, next_pow2(ts.corr_idx.size))
            key = (ts.Wpad, ts.periods, ts.m2.size, c_pad)
            groups.setdefault(key, []).append((pos, ts, t0))
        for (Wpad, periods, _s2, c_pad), members in groups.items():
            packed = self._run_group(Wpad, periods, c_pad,
                                     [ts for _, ts, _ in members])
            for (pos, ts, t0), row in zip(members, packed):
                lo, hi = segments[pos]
                out[pos] = self._result(seg_ids[pos], lo, hi, ts.nbits, row, t0)
        return out


def _pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    """Right-pad ``a`` to length ``n`` with ``fill``: correction pads are
    (idx=0, mask=0), whose scatter-max ``cur | 0`` at word 0 is a no-op."""
    if a.size == n:
        return a
    return np.concatenate([a, np.full(n - a.size, fill, a.dtype)])
