"""The rounds path: each round's shards on their own devices, one process.

The counterpart of the reference's ``run_mesh`` (sieve/parallel/mesh.py)
on tpu-pallas. The run is cut into ``workers * rounds`` segments; round k
gives segment k*workers + d to shard d. As in the reference, one process
drives every device (the reference's single controller drives its whole
mesh): shard d runs on ``cuda:d`` when ``device="cuda"``, and every shard
runs on the CPU with ``device="cpu"``. A run that asks for more shards
than there are cards raises; nothing falls back to fewer cards or to the
CPU.

Per round each shard runs the fused kernel, or under SIEVE_PALLAS_FUSED=0
the split kernel and its postlude, on its own device (fixed once per
run). The shards' uint32[4] results meet on the first shard's device,
where ``_collective_merge`` sums the counts and the pairs plus the odds
twins that straddle two shards (the reference's psum and ppermute), and
packs one vector, which crosses to the host in one copy per round. The
host then cross-checks it against its own sums and merges with the same
``merge_results`` as the local run.

Rounds overlap: background threads prepare round k+window
(pipeline.PrepPipeline) while round k runs, round k is dispatched while
round k-1 runs, and each round's vector is read at most
``SIEVE_ROUND_WINDOW`` (default 2) rounds late. With a checkpoint dir
every drained segment is recorded, and ``resume`` prepares nothing for
the rounds the ledger holds.

The reference pads every shard's tables to one shape per round
(``pad_pallas``, ``ND_BUCKET``), because its compiled step is specialised
to array shapes. A CUDA launch takes the table sizes as arguments, so
here each shard launches with its own tables and nothing is padded.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sieve_torch import env
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
)
from sieve_torch.kernels.pairs import pair_kind
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


def _collective_merge(results: list[torch.Tensor], gap_ok: np.ndarray,
                      dev0: torch.device) -> torch.Tensor:
    """The reference's collectives on the first shard's device: the count
    sum; the left neighbour's first flag bit against each shard's last for
    the odds twins that straddle two shards (on where gap_ok says the two
    candidates differ by 2); the per-shard vectors gathered. Returns ONE
    int64[2 + 4*ndev] of uint32 values: [total, total_twins, counts...,
    twins..., first32..., last32...], still on dev0."""
    if dev0.type == "cuda":
        # each result's producer on its own card must finish before dev0
        # reads it
        here = torch.cuda.current_stream(dev0)
        for r in results:
            if r.device != dev0:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(r.device))
                here.wait_event(ev)
    res = torch.stack([r.to(dev0) for r in results])
    count, twins, first32, last32 = res.unbind(1)
    total = count.sum()
    recv = torch.cat([first32[1:] & 1, first32.new_zeros(1)])  # shard i+1 -> i
    gap = torch.from_numpy(gap_ok)
    if dev0.type == "cuda":
        # pinned, so the copy is queued and the host does not wait for the
        # round's kernels (a pageable copy synchronises the stream)
        gap = gap.pin_memory()
    gap = gap.to(dev0, non_blocking=True)
    total_twins = (twins + (last32 >> 31) * recv * gap).sum()
    return torch.cat([torch.stack([total, total_twins]) & _U32,
                      count, twins, first32, last32])


def _fetch_async(packed: torch.Tensor):
    """Queue the device-to-host copy of a round's vector right behind the
    round's work; returns (host tensor, event to wait on or None)."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(packed.device))
    return host, ev


def run_mesh(config: SieveConfig) -> SieveResult:
    """Run the sieve one segment per shard per round. Falls back to the
    local coordinator for ranges too small to shard meaningfully."""
    cfg = config
    if cfg.backend != "cuda":
        raise ValueError(f"the rounds path runs the cuda backend, not {cfg.backend!r}")
    t0 = time.perf_counter()
    ndev = cfg.workers
    devices = shard_devices(cfg.device, ndev)

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

    seeds = seed_primes(cfg.seed_limit)
    twin_kind = pair_kind(cfg)
    pgap = cfg.pair_gap or 2
    # one padded width for every shard and round: it is baked into every
    # spec's rK offset, so it is fixed before any grouping
    Wmax = max(-(-layout.nbits(s.lo, s.hi) // 32) for s in segs)
    Wpad = -(-(Wmax + 1) // TILE_WORDS) * TILE_WORDS
    # the reduction mode is fixed once per run, so every round runs and
    # cross-checks the same path
    fused = fused_enabled()
    reduce = fused_reduce if fused else split_reduce

    ledger = Ledger.open(cfg) if cfg.checkpoint_dir else None
    done: dict[int, SegmentResult] = {}
    if ledger is not None and cfg.resume:
        done = ledger.completed()

    window = max(0, env.env_int("SIEVE_ROUND_WINDOW", 2))
    pending: list = []
    spent = dict.fromkeys(
        ("prep_wait", "stack", "dispatch", "drain", "device_idle"), 0.0)

    def _drain_one():
        batch, nbits_b, (host, ev), rt0 = pending.pop(0)
        td = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        vals = host.numpy()                 # the round's one fetched vector
        spent["drain"] += time.perf_counter() - td
        total = int(vals[0])
        total_twins = int(vals[1])
        counts = vals[2 : 2 + ndev]
        twins_v = vals[2 + ndev : 2 + 2 * ndev]
        fw = vals[2 + 2 * ndev : 2 + 3 * ndev]
        lw = vals[2 + 3 * ndev : 2 + 4 * ndev]
        # dispatch-to-fetch time; with a nonzero window this includes
        # overlapped rounds, so it bounds rather than equals device time
        elapsed_round = time.perf_counter() - rt0
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
                nbits=int(nbits_b[i]),
                elapsed_s=elapsed_round / ndev,
            )
            done[s.seg_id] = res
            if ledger is not None:
                ledger.record(res)
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
    # most window+1 rounds of preps are resident at once
    todo = [
        rnd
        for rnd in range(max(1, cfg.rounds))
        if not all(s.seg_id in done for s in segs[rnd * ndev : (rnd + 1) * ndev])
    ]
    pipeline = PrepPipeline(
        todo,
        lambda: CudaChain(cfg.packing, seeds, Wpad, pair_gap=pgap),
        lambda chain, rnd: [
            chain.prepare(s.lo, s.hi) for s in segs[rnd * ndev : (rnd + 1) * ndev]
        ],
        window,
    )
    try:
        for rnd in todo:
            batch = segs[rnd * ndev : (rnd + 1) * ndev]
            rt0 = time.perf_counter()
            # nothing dispatched and undrained: the device sits idle for
            # exactly the host time until the dispatch below
            device_starved = not pending
            preps = pipeline.take(rnd)
            t_prep = time.perf_counter()
            spent["prep_wait"] += t_prep - rt0
            nbits_v = [p.nbits for p in preps]
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
            inputs = [fused_inputs(p, d) for p, d in zip(preps, devices)]
            t_stack = time.perf_counter()
            spent["stack"] += t_stack - t_prep
            if device_starved:
                spent["device_idle"] += t_stack - rt0
            packed = _collective_merge(
                [reduce(x, twin_kind) for x in inputs], gap_ok, devices[0])
            pending.append((batch, nbits_v, _fetch_async(packed), rt0))
            spent["dispatch"] += time.perf_counter() - t_stack
            while len(pending) > window:
                _drain_one()
        while pending:
            _drain_one()
    finally:
        pipeline.close()

    results = [done[s.seg_id] for s in segs]
    pi, twin_pairs = merge_results(cfg, results)
    elapsed = time.perf_counter() - t0

    chain_phases: dict[str, float] = {}
    for st in pipeline.states:
        for k, v in st.phase_seconds.items():
            chain_phases[k] = chain_phases.get(k, 0.0) + v
    prep_s = pipeline.stats["prep_seconds"]
    values_prepared = sum(
        s.hi - s.lo for rnd in todo for s in segs[rnd * ndev : (rnd + 1) * ndev]
    )
    idle_frac = spent["device_idle"] / elapsed if elapsed > 0 else 0.0
    host_phases = {
        "prep_s": round(prep_s, 6),
        "prep_wait_s": round(spent["prep_wait"], 6),
        "stack_s": round(spent["stack"], 6),
        "dispatch_s": round(spent["dispatch"], 6),
        "drain_s": round(spent["drain"], 6),
        "device_idle_s": round(spent["device_idle"], 6),
        "device_idle_frac": round(idle_frac, 6),
        "overlap_efficiency": round(1.0 - idle_frac, 6),
        "rounds_prepared": pipeline.stats["rounds_prepared"],
        "peak_resident_rounds": pipeline.stats["peak_resident"],
        "prep_values_per_sec": (
            round(values_prepared / prep_s, 1) if prep_s > 0 else None
        ),
        **{f"prep_{k}_s": round(v, 6) for k, v in chain_phases.items()},
        "reduction_mode": "fused" if fused else "split",
    }
    return SieveResult(
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
