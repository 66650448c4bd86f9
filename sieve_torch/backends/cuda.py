"""cuda backend: the hand-written mark kernels on the card.

The counterpart of the reference's tpu-pallas backend: the same
SieveWorker contract and result assembly; only the device path differs
(sieve_torch/kernels/cuda_mark.py). Per segment the host prepares the
spec tables incrementally (one CudaChain per padded width), the tables go
to ``config.device`` in one copy, the fused kernel (or, under
SIEVE_PALLAS_FUSED=0, the split kernel and its postlude) runs, and one
uint32[4] comes back. With ``device="cpu"`` the kernels' plain PyTorch
versions run instead.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sieve_torch import trace
from sieve_torch.backends.cpu_numpy import CpuNumpyWorker
from sieve_torch.bitset import get_layout
from sieve_torch.kernels.cuda_mark import (
    CudaChain,
    _padded_words,
    fused_enabled,
    mark_cuda,
)
from sieve_torch.kernels.pairs import MIN_DEVICE_BITS, pair_kind
from sieve_torch.worker import SegmentResult, SieveWorker


def resolve_device(name: str) -> torch.device:
    """The torch device a config names; a CUDA device must exist — there is
    no silent fall back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch sees no CUDA device; "
            "pass --device cpu (device='cpu') to run the kernel's plain "
            "version on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return dev


class CudaWorker(SieveWorker):
    name = "cuda"

    def __init__(self, config):
        super().__init__(config)
        self.device = resolve_device(config.device)
        self._cpu_fallback = CpuNumpyWorker(config)
        self._chains: dict[int, CudaChain] = {}  # keyed by padded width
        self._chain_seeds: np.ndarray | None = None
        # device mark+reduce time (the ``segment.device`` spans), reported
        # through SieveResult.host_phases
        self.reduce_seconds: dict[str, float] = {}
        # segments under MIN_DEVICE_BITS candidate bits, answered on the
        # host as the reference's device backends do: no kernel launch
        self.host_segments = 0

    def _prepare(self, lo: int, hi: int, seeds: np.ndarray, seg_id: int):
        """Incremental prepare: a run's equal-sized segments share one
        chain, so residues advance O(1) per seed."""
        if self._chain_seeds is not seeds:
            self._chains.clear()
            self._chain_seeds = seeds
        packing = self.config.packing
        wpad = _padded_words(get_layout(packing).nbits(lo, hi))
        chain = self._chains.get(wpad)
        if chain is None:
            with trace.span("prepare.chain", backend=self.name, seg=seg_id):
                chain = self._chains[wpad] = CudaChain(
                    packing, seeds, wpad, pair_gap=self.config.pair_gap or 2,
                )
        seg = chain.prepare(lo, hi, seg_id)
        agg: dict[str, float] = {}
        for c in self._chains.values():
            for k, v in c.phase_seconds.items():
                agg[k] = agg.get(k, 0.0) + v
        self.phase_seconds = agg
        return seg

    def process_segment(
        self, lo: int, hi: int, seed_primes: np.ndarray, seg_id: int = 0
    ) -> SegmentResult:
        t0 = time.perf_counter()
        layout = get_layout(self.config.packing)
        nbits = layout.nbits(lo, hi)
        if nbits < MIN_DEVICE_BITS:
            self.host_segments += 1
            return self._cpu_fallback.process_segment(lo, hi, seed_primes, seg_id)
        with trace.span("segment.prepare", backend=self.name, seg=seg_id):
            seg = self._prepare(lo, hi, seed_primes, seg_id)
        self.reduction_mode = "fused" if fused_enabled() else "split"
        key = "postlude_" + self.reduction_mode
        with trace.span("segment.device", backend=self.name, seg=seg_id,
                        mode=key) as sp:
            count, pairs, first_word, last_word = mark_cuda(
                seg, pair_kind(self.config), device=self.device
            )
        self.reduce_seconds[key] = self.reduce_seconds.get(key, 0.0) + sp.elapsed
        with trace.span("segment.result", seg=seg_id):
            count += layout.extras_in(lo, hi)
            twin_count = (
                pairs + layout.extra_pairs(lo, hi, self.config.pair_gap or 2)
                if self.config.twins else 0
            )
            return SegmentResult(
                seg_id=seg_id,
                lo=lo,
                hi=hi,
                count=count,
                twin_count=twin_count,
                first_word=first_word,
                last_word=last_word,
                nbits=nbits,
                elapsed_s=time.perf_counter() - t0,
            )
