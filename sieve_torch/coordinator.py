"""Coordinator (control plane): seed sieve, partition, dispatch, merge.

Computes the seed primes once on the host, cuts [2, n+1) into contiguous
segments, runs them through one worker, and merges the per-segment counts
plus boundary bitwords into the final result. ``merge_results`` is a
standalone pure function with the reference's merge semantics. With a
checkpoint dir every finished segment is recorded in the ledger
(sieve_torch/checkpoint.py), and ``resume`` skips the ones it holds.
The run emits the reference's metrics events (one per segment, the
summary, resume and ledger salvage; sieve_torch/metrics.py) and its
``run.seed``, ``run.plan``, ``run.worker``, ``segment.process``,
``segment.record``, ``run.merge`` and ``run.summary`` spans
(sieve_torch/trace.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

from sieve_torch import trace
from sieve_torch.bitset import get_layout
from sieve_torch.checkpoint import Ledger
from sieve_torch.config import SieveConfig
from sieve_torch.metrics import MetricsLogger
from sieve_torch.seed import seed_primes
from sieve_torch.segments import Segment, plan_segments, validate_plan
from sieve_torch.twins import straddle_pairs
from sieve_torch.worker import SegmentResult, SieveWorker


@dataclasses.dataclass
class SieveResult:
    n: int
    pi: int
    twin_pairs: int | None
    backend: str
    packing: str
    n_segments: int
    elapsed_s: float
    values_per_sec: float
    segments: list[SegmentResult] = dataclasses.field(default_factory=list)
    # host prepare phase totals and the device reduction time of the worker
    host_phases: dict | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["segments"] = [s.to_dict() for s in self.segments]
        return d


def merge_results(
    config: SieveConfig, results: Iterable[SegmentResult]
) -> tuple[int, int | None]:
    """Merge per-segment results into (pi, pairs).

    Validates that the results tile [2, n+1) exactly, sums counts, and
    resolves cross-boundary pairs from boundary bitwords.
    """
    layout = get_layout(config.packing)
    segs = sorted(results, key=lambda r: r.lo)
    if not segs:
        raise ValueError("no segment results to merge")
    if segs[0].lo != 2 or segs[-1].hi != config.n + 1:
        raise ValueError(
            f"results cover [{segs[0].lo}, {segs[-1].hi}), "
            f"expected [2, {config.n + 1})"
        )
    for a, b in zip(segs, segs[1:]):
        if a.hi != b.lo:
            raise ValueError(f"results gap/overlap at {a.hi} vs {b.lo}")
    pi = sum(r.count for r in segs)
    pairs: int | None = None
    if config.twins:
        gap = config.pair_gap or 2
        pairs = sum(r.twin_count for r in segs)
        for a, b in zip(segs, segs[1:]):
            pairs += straddle_pairs(layout, a, b, config.n, gap)
    return pi, pairs


def _host_phases(worker: SieveWorker) -> dict | None:
    """The reference's host_phases keys: prep totals per phase, the
    reduction mode, and the device reduction time."""
    phases = worker.phase_seconds or None
    out = (
        {
            "prep_s": round(sum(phases.values()), 6),
            **{f"prep_{k}_s": round(v, 6) for k, v in phases.items()},
        }
        if phases
        else None
    )
    mode = getattr(worker, "reduction_mode", None)
    if mode is not None:
        out = dict(out or {})
        out["reduction_mode"] = mode
    reduce_s = getattr(worker, "reduce_seconds", None)
    if reduce_s:
        out = dict(out or {})
        out.update({f"{k}_s": round(v, 6) for k, v in reduce_s.items()})
    return out


class Coordinator:
    """Single-process coordinator: runs segments through one worker."""

    def __init__(
        self,
        config: SieveConfig,
        worker_factory: Callable[[SieveConfig], SieveWorker] | None = None,
    ):
        self.config = config
        if worker_factory is None:
            from sieve_torch.backends import make_worker

            worker_factory = make_worker
        self._worker_factory = worker_factory
        self.metrics = MetricsLogger(config)

    def plan(self) -> list[Segment]:
        segs = plan_segments(
            self.config.n,
            self.config.resolved_n_segments(),
            n_workers=self.config.workers,
        )
        validate_plan(segs, self.config.n)
        return segs

    def run(self) -> SieveResult:
        cfg = self.config
        t0 = time.perf_counter()
        with trace.span("run.seed", backend=cfg.backend):
            seeds = seed_primes(cfg.seed_limit)
        with trace.span("run.plan"):
            segs = self.plan()
        ledger = Ledger.open(cfg) if cfg.checkpoint_dir else None
        if ledger is not None and ledger.salvaged:
            self.metrics.event("ledger_salvaged", salvaged=ledger.salvaged,
                               quarantined=ledger.quarantined)
        done: dict[int, SegmentResult] = {}
        if ledger is not None and cfg.resume:
            done = ledger.completed()
            self.metrics.event("resume", restored=len(done))
        with trace.span("run.worker", backend=cfg.backend):
            worker = self._worker_factory(cfg)
        try:
            for seg in segs:
                if seg.seg_id in done:
                    continue
                with trace.span("segment.process", seg=seg.seg_id,
                                backend=cfg.backend):
                    res = worker.process_segment(seg.lo, seg.hi, seeds, seg.seg_id)
                with trace.span("segment.record", seg=seg.seg_id):
                    done[seg.seg_id] = res
                    if ledger is not None:
                        ledger.record(res)
                    self.metrics.segment(res)
        finally:
            worker.close()
        results = [done[s.seg_id] for s in segs]
        with trace.span("run.merge"):
            pi, pairs = merge_results(cfg, results)
        elapsed = time.perf_counter() - t0
        with trace.span("run.summary"):
            result = SieveResult(
                n=cfg.n,
                pi=pi,
                twin_pairs=pairs,
                backend=cfg.backend,
                packing=cfg.packing,
                n_segments=len(segs),
                elapsed_s=elapsed,
                values_per_sec=(cfg.n - 1) / elapsed if elapsed > 0 else float("inf"),
                segments=results,
                host_phases=_host_phases(worker),
            )
            self.metrics.run_summary(result)
        return result


def run_local(config: SieveConfig) -> SieveResult:
    """Single-process run: the counting run's entry point."""
    return Coordinator(config).run()
