"""The rounds path: each round's shards on their own devices, one process.

The counterpart of the reference's ``run_mesh`` (sieve/parallel/mesh.py)
on tpu-pallas. The run is cut into ``workers * rounds`` segments; round k
gives segment k*workers + d to shard d. As in the reference, one process
drives every device (the reference's single controller drives its whole
mesh): shard d runs on ``cuda:d`` when ``device="cuda"``, and every shard
runs on the CPU with ``device="cpu"``. A run that asks for more shards
than there are cards raises; nothing falls back to fewer cards or to the
CPU.

Per round each shard runs, on its own device, the backend's device code:
for ``cuda`` the fused kernel, or under SIEVE_PALLAS_FUSED=0 the split
kernel and its postlude (fixed once per run); for ``torch`` the word
kernel (kernels/word_mark.py), at one padded width for every shard and
round, bucketed by the reference's WORD_BUCKET rule. The shards'
uint32[4] results meet on the first shard's device, where
``_collective_merge`` sums the counts and the pairs plus the odds twins
that straddle two shards (the reference's psum and ppermute), and packs
one vector, which crosses to the host in one copy per round. The host
then cross-checks it against its own sums and merges with the same
``merge_results`` as the local run.

Rounds overlap: background threads prepare round k+window
(pipeline.PrepPipeline) while round k runs, round k is dispatched while
round k-1 runs, and each round's vector is read at most
``SIEVE_ROUND_WINDOW`` (default 2) rounds late. With a checkpoint dir
every drained segment is recorded, and ``resume`` prepares nothing for
the rounds the ledger holds.

With ``multihost`` the shards of a round are spread over the ranks of a
torch.distributed group (sieve_torch/parallel/dist.py): each rank
launches its own, the ranks all-gather the per-shard rows, and each runs
the merge and the cross-check on the whole round. Rank 0 records the
ledger, and its view of the ledger decides what every rank skips.

The phases are spans (``round.prep_wait``, ``round.stack``,
``round.dispatch``, ``round.drain``, ``round.device_idle`` and, across
ranks, ``round.gather``; sieve_torch/trace.py), and ``host_phases`` sums
this run's spans as the reference does.

The reference pads every shard's tables to one shape per round
(``pad_pallas``, ``ND_BUCKET``, and the word kernel's tier-2 and
correction padding), because its compiled step is specialised to array
shapes. A CUDA launch and a torch op take the table sizes as they come,
so here each shard runs with its own tables and nothing is padded (the
padding is inert in the reference too).
"""

from __future__ import annotations

import numpy as np
import torch

from sieve_torch import env, trace
from sieve_torch.backends.cuda import resolve_device
from sieve_torch.bitset import get_layout
from sieve_torch.checkpoint import Ledger
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import SieveResult, merge_results, run_local
from sieve_torch.kernels.cuda_mark import (
    TILE_WORDS,
    CudaChain,
    fused_enabled,
    fused_inputs,
    fused_reduce,
    split_reduce,
    warm,
)
from sieve_torch.kernels.pairs import pair_kind
from sieve_torch.kernels.specs import TieredChain
from sieve_torch.kernels.word_mark import (
    SPEC_BLOCK,
    TIER1_MAX,
    WORD_BUCKET,
    mark_words,
)
from sieve_torch.metrics import MetricsLogger
from sieve_torch.parallel.pipeline import PrepPipeline
from sieve_torch.seed import seed_primes
from sieve_torch.segments import plan_segments, validate_plan
from sieve_torch.twins import straddle_twins
from sieve_torch.worker import SegmentResult

MIN_SHARD_BITS = 64
_U32 = 0xFFFFFFFF


class MeshCrossCheckError(RuntimeError):
    """The merged totals (count sum, straddling twins) disagree with the
    host-side merge semantics: data corruption or a merge bug. A real
    exception (not an assert) so the check survives ``python -O``."""


def shard_devices(device: str, n: int) -> list[torch.device]:
    """The devices of n shards: n cards from ``device``'s index on, or the
    CPU for every shard. Fewer cards than shards is an error."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    first = dev.index or 0
    have = torch.cuda.device_count()
    if first + n > have:
        raise ValueError(
            f"{n} shards need CUDA devices {first}..{first + n - 1}, but torch "
            f"sees {have}; the rounds path runs one shard per card and does "
            "not fall back to fewer cards or to the CPU"
        )
    return [torch.device("cuda", first + i) for i in range(n)]


def _stack_rows(results: list[torch.Tensor], dev0: torch.device) -> torch.Tensor:
    """The shards' int64[4] results as one [n, 4] tensor on dev0, each
    read only after its producer on its own card has finished."""
    if dev0.type == "cuda":
        here = torch.cuda.current_stream(dev0)
        for r in results:
            if r.device != dev0:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(r.device))
                here.wait_event(ev)
    return torch.stack([r.to(dev0) for r in results])


def _collective_merge(rows: torch.Tensor, gap_ok: np.ndarray) -> torch.Tensor:
    """The reference's collectives on one round's [ndev, 4] rows (count,
    pairs, first32, last32 per shard), on the rows' device: the count sum;
    the left neighbour's first flag bit against each shard's last for the
    odds twins that straddle two shards (on where gap_ok says the two
    candidates differ by 2); the per-shard vectors gathered. Returns ONE
    int64[2 + 4*ndev] of uint32 values: [total, total_twins, counts...,
    twins..., first32..., last32...]."""
    dev = rows.device
    count, twins, first32, last32 = rows.unbind(1)
    total = count.sum()
    recv = torch.cat([first32[1:] & 1, first32.new_zeros(1)])  # shard i+1 -> i
    gap = torch.from_numpy(gap_ok)
    if dev.type == "cuda":
        # pinned, so the copy is queued and the host does not wait for the
        # round's kernels (a pageable copy synchronises the stream)
        gap = gap.pin_memory()
    gap = gap.to(dev, non_blocking=True)
    total_twins = (twins + (last32 >> 31) * recv * gap).sum()
    return torch.cat([torch.stack([total, total_twins]) & _U32,
                      count, twins, first32, last32])


def _fetch_async(packed: torch.Tensor):
    """Queue the device-to-host copy of a tensor right behind the round's
    work; returns (host tensor, event to wait on or None)."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(packed.device))
    return host, ev


def _reader(packed: torch.Tensor):
    """A call that returns the round's vector as numpy, its copy queued now."""
    host, ev = _fetch_async(packed)

    def read() -> np.ndarray:
        if ev is not None:
            ev.synchronize()
        return host.numpy()
    return read


def _gathered_reader(group, rows: torch.Tensor, gap_ok: np.ndarray, rnd: int):
    """The round's vector across ranks: every rank's rows all-gathered,
    then merged here. NCCL gathers on the card, queued behind the round's
    kernels, and its time is read by CUDA events on the stream; gloo
    gathers host copies, started at once when the rows are on the host
    and at drain, behind the round's event, when they are on a card."""
    if group.backend == "nccl":
        t_issue = trace.now_s()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        work, parts = group.all_gather(rows)
        work.wait()  # the stream waits, the host does not
        end.record()
        read = _reader(_collective_merge(torch.cat(parts), gap_ok))

        def read_nccl() -> np.ndarray:
            vals = read()
            trace.add_device_span("round.gather", rows.device, t_issue,
                                  start.elapsed_time(end) / 1e3, round=rnd,
                                  clock="device")
            return vals
        return read_nccl
    host_rows, ev = _fetch_async(rows)
    started = group.all_gather(host_rows) if ev is None else None

    def read_gloo() -> np.ndarray:
        with trace.span("round.gather", round=rnd):
            if ev is not None:
                ev.synchronize()
            work, parts = started or group.all_gather(host_rows)
            work.wait()
        return _collective_merge(torch.cat(parts), gap_ok).numpy()
    return read_gloo


def run_mesh(config: SieveConfig) -> SieveResult:
    """Run the sieve one segment per shard per round. Falls back to the
    local coordinator for ranges too small to shard meaningfully. With
    ``multihost`` the calling process is one rank of a joined group and
    runs its share of the shards (sieve_torch/parallel/dist.py)."""
    cfg = config
    if cfg.backend not in ("cuda", "torch"):
        raise ValueError(f"the rounds path runs the cuda backend or the torch "
                         f"backend, not {cfg.backend!r}")
    metrics = MetricsLogger(cfg)
    t0 = trace.now_s()
    # host_phases sums this run's spans: the delta from this snapshot
    tsnap = trace.snapshot()
    ndev = cfg.workers
    group = None
    if cfg.multihost:
        from sieve_torch.parallel.dist import Group, local_shards

        group = Group()
        nlocal = local_shards(ndev, group.world)
        first = group.rank * nlocal
    else:
        nlocal, first = ndev, 0
    devices = shard_devices(cfg.device, nlocal)

    n_segs = ndev * max(1, cfg.rounds)
    if cfg.n_segments is not None and cfg.n_segments != n_segs:
        raise ValueError(
            f"mesh path segments by workers*rounds = {n_segs}; "
            f"--segments {cfg.n_segments} conflicts (drop it or match)"
        )
    if cfg.segment_values is not None:
        raise ValueError(
            "mesh path segments by workers*rounds; --segment-size is not "
            "honored here — use --rounds to control per-dispatch size"
        )
    segs = plan_segments(cfg.n, n_segs)
    layout = get_layout(cfg.packing)
    if len(segs) != n_segs or any(
        layout.nbits(s.lo, s.hi) < MIN_SHARD_BITS for s in segs
    ):
        return run_local(SieveConfig(**{**cfg.to_dict(), "workers": 1}))
    validate_plan(segs, cfg.n)
    # the ledger must describe the segmentation actually used, so a resume
    # with other workers/rounds (or the local run's default plan) is
    # refused by the config-hash guard rather than mis-merged
    cfg = SieveConfig(**{**cfg.to_dict(), "n_segments": n_segs})

    with trace.span("run.seed", backend=cfg.backend):
        seeds = seed_primes(cfg.seed_limit)
    twin_kind = pair_kind(cfg)
    pgap = cfg.pair_gap or 2
    Wseg = [-(-layout.nbits(s.lo, s.hi) // 32) for s in segs]
    if cfg.backend == "cuda":
        # one padded width for every shard and round: it is baked into
        # every spec's rK offset, so it is fixed before any grouping
        Wpad = -(-(max(Wseg) + 1) // TILE_WORDS) * TILE_WORDS
        # the reduction mode is fixed once per run, so every round runs
        # and cross-checks the same path
        fused = fused_enabled()
        reduce = fused_reduce if fused else split_reduce

        def make_chain():
            return CudaChain(cfg.packing, seeds, Wpad, pair_gap=pgap)

        stage = fused_inputs    # the tables to the shard's card

        def launch(x):
            return reduce(x, twin_kind)
    else:
        # the reference's word-kernel width: the largest segment's, by
        # WORD_BUCKET; each shard's torch ops copy their own tables
        Wpad = max(-(-(W + 1) // WORD_BUCKET) * WORD_BUCKET for W in Wseg)

        def make_chain():
            return TieredChain(cfg.packing, seeds, TIER1_MAX, SPEC_BLOCK,
                               WORD_BUCKET, pair_gap=pgap)

        def stage(prep, dev):
            return prep, dev

        def launch(x):
            ts, dev = x
            return mark_words(Wpad, twin_kind, ts.periods, ts.nbits,
                              ts.patterns, ts.m2, ts.r2, ts.K2, ts.rcp2,
                              ts.act2, ts.corr_idx, ts.corr_mask,
                              ts.pair_mask, device=dev)

    def open_ledger():
        led = Ledger.open(cfg) if cfg.checkpoint_dir else None
        return led, (led.completed() if led is not None and cfg.resume else {})

    if group is None:
        ledger, done = open_ledger()
    else:
        # rank 0's view decides every rank's skips; rank 0 alone records
        ledger, done = group.agree_done(open_ledger)
        if group.rank != 0:
            ledger = None
    if ledger is not None and ledger.salvaged:
        metrics.event("ledger_salvaged", salvaged=ledger.salvaged,
                      quarantined=ledger.quarantined)
    if cfg.resume and cfg.checkpoint_dir:
        metrics.event("resume", restored=len(done))

    window = max(0, env.env_int("SIEVE_ROUND_WINDOW", 2))
    pending: list = []

    def _drain_one():
        batch, read, rt0 = pending.pop(0)
        with trace.span("round.drain", round=batch[0].seg_id // ndev):
            vals = read()                   # the round's one fetched vector
            trace.flush_device_spans()
        total = int(vals[0])
        total_twins = int(vals[1])
        counts = vals[2 : 2 + ndev]
        twins_v = vals[2 + ndev : 2 + 2 * ndev]
        fw = vals[2 + 2 * ndev : 2 + 3 * ndev]
        lw = vals[2 + 3 * ndev : 2 + 4 * ndev]
        # dispatch-to-fetch time; with a nonzero window this includes
        # overlapped rounds, so it bounds rather than equals device time
        elapsed_round = trace.now_s() - rt0
        for i, s in enumerate(batch):
            res = SegmentResult(
                seg_id=s.seg_id,
                lo=s.lo,
                hi=s.hi,
                count=int(counts[i]) + layout.extras_in(s.lo, s.hi),
                twin_count=(
                    int(twins_v[i]) + layout.extra_pairs(s.lo, s.hi, pgap)
                    if cfg.twins
                    else 0
                ),
                first_word=int(fw[i]),
                last_word=int(lw[i]),
                nbits=layout.nbits(s.lo, s.hi),
                elapsed_s=elapsed_round / ndev,
            )
            done[s.seg_id] = res
            if ledger is not None:
                ledger.record(res)
            metrics.segment(res)
        # cross-check: the merged totals agree with the host-side merge
        # semantics (the count sum; the sum plus the straddles for odds
        # twins)
        if total != int(counts.sum()):
            raise MeshCrossCheckError(
                f"count merge mismatch: merged total {total} != "
                f"host sum {int(counts.sum())}"
            )
        if cfg.twins and cfg.packing == "odds" and pgap == 2:
            batch_res = [done[s.seg_id] for s in batch]
            expect = int(twins_v.sum()) + sum(
                straddle_twins(layout, a, b, cfg.n)
                for a, b in zip(batch_res, batch_res[1:])
            )
            if total_twins != expect:
                raise MeshCrossCheckError(
                    f"straddle twin merge diverged: {total_twins} != {expect}"
                )

    # only rounds NOT restored from the ledger enter the pipeline, and at
    # most window+1 rounds of preps are resident at once; a rank prepares
    # its own shards of each round
    todo = [
        rnd
        for rnd in range(max(1, cfg.rounds))
        if not all(s.seg_id in done for s in segs[rnd * ndev : (rnd + 1) * ndev])
    ]
    pipeline = PrepPipeline(
        todo,
        make_chain,
        lambda chain, rnd: [
            chain.prepare(s.lo, s.hi, s.seg_id)
            for s in segs[rnd * ndev + first : rnd * ndev + first + nlocal]
        ],
        window,
    )
    try:
        if cfg.backend == "cuda" and todo and devices[0].type == "cuda":
            # a fresh process loads the kernels while round 0 prepares,
            # not in round 0's dispatch after it; like the reference's
            # compile, this one-time load is not device idle
            with trace.span("round.warm"):
                warm(devices)
        for rnd in todo:
            batch = segs[rnd * ndev : (rnd + 1) * ndev]
            rt0 = trace.now_s()
            # nothing dispatched and undrained: the device sits idle for
            # exactly the host time until the dispatch below
            device_starved = not pending
            preps = pipeline.take(rnd)
            t_prep = trace.now_s()
            trace.add_span("round.prep_wait", rt0, t_prep - rt0, round=rnd)
            # gap_ok[d] = 1 iff (last candidate of seg d, first of seg d+1)
            # is a potential twin pair: the odds on-device straddle.
            # Cousins resolve their straddles host-side in merge_results.
            gap_ok = np.zeros(ndev, np.int64)
            if cfg.packing == "odds" and cfg.twins and pgap == 2:
                for i in range(len(batch) - 1):
                    lv = layout.last_candidate(batch[i].hi)
                    fv = layout.first_candidate(batch[i + 1].lo)
                    if fv - lv == 2 and fv <= cfg.n:
                        gap_ok[i] = 1
            inputs = [stage(p, d) for p, d in zip(preps, devices)]
            t_stack = trace.now_s()
            trace.add_span("round.stack", t_prep, t_stack - t_prep, round=rnd)
            if device_starved:
                trace.add_span("round.device_idle", rt0, t_stack - rt0, round=rnd)
            with trace.span("round.dispatch", round=rnd):
                rows = _stack_rows([launch(x) for x in inputs], devices[0])
                if group is None:
                    read = _reader(_collective_merge(rows, gap_ok))
                else:
                    read = _gathered_reader(group, rows, gap_ok, rnd)
            pending.append((batch, read, rt0))
            while len(pending) > window:
                _drain_one()
        while pending:
            _drain_one()
    finally:
        pipeline.close()

    results = [done[s.seg_id] for s in segs]
    with trace.span("run.merge"):
        pi, twin_pairs = merge_results(cfg, results)
    elapsed = trace.now_s() - t0

    chain_phases: dict[str, float] = {}
    for st in pipeline.states:
        for k, v in st.phase_seconds.items():
            chain_phases[k] = chain_phases.get(k, 0.0) + v
    agg = trace.since(tsnap)

    def _tot(name: str) -> float:
        return agg.get(name, (0.0, 0))[0]

    prep_s = pipeline.stats["prep_seconds"]
    values_prepared = sum(
        s.hi - s.lo for rnd in todo
        for s in segs[rnd * ndev + first : rnd * ndev + first + nlocal]
    )
    device_idle_s = _tot("round.device_idle")
    idle_frac = device_idle_s / elapsed if elapsed > 0 else 0.0
    host_phases = {
        "prep_s": round(prep_s, 6),
        "prep_wait_s": round(_tot("round.prep_wait"), 6),
        "stack_s": round(_tot("round.stack"), 6),
        "dispatch_s": round(_tot("round.dispatch"), 6),
        "drain_s": round(_tot("round.drain"), 6),
        "device_idle_s": round(device_idle_s, 6),
        "device_idle_frac": round(idle_frac, 6),
        "overlap_efficiency": round(1.0 - idle_frac, 6),
        "rounds_prepared": pipeline.stats["rounds_prepared"],
        "peak_resident_rounds": pipeline.stats["peak_resident"],
        "prep_values_per_sec": (
            round(values_prepared / prep_s, 1) if prep_s > 0 else None
        ),
        **{f"prep_{k}_s": round(v, 6) for k, v in chain_phases.items()},
    }
    if cfg.backend == "cuda":
        host_phases["reduction_mode"] = "fused" if fused else "split"
    if group is not None:
        # the rounds' all-gathers: CUDA-event time on the stream under
        # NCCL, host time waiting under gloo (inside drain_s)
        host_phases.update(gather_s=round(_tot("round.gather"), 6),
                           dist_backend=group.backend, rank=group.rank,
                           world=group.world)
    metrics.event("host_prepare", **host_phases)
    result = SieveResult(
        n=cfg.n,
        pi=pi,
        twin_pairs=twin_pairs,
        backend=cfg.backend,
        packing=cfg.packing,
        n_segments=len(segs),
        elapsed_s=elapsed,
        values_per_sec=(cfg.n - 1) / elapsed if elapsed > 0 else float("inf"),
        segments=results,
        host_phases=host_phases,
    )
    metrics.run_summary(result)
    return result
