"""The port's graft entry: a single-card kernel check and a multi-shard
dry run, the counterpart of the repository's ``__graft_entry__.py``.

``entry(device)`` returns the word kernel's forward step on the flagship
workload, one n=1e6 odds segment (``word_mark.mark_words``, the port of
the reference's ``mark_words_impl``), and its example args.
``dryrun_multichip(n_devices, device)`` runs the rounds path
(``run_mesh``) at n=3e7 with ``n_devices`` shards, 2 rounds and twins, on
the ``torch`` backend and on the ``cuda`` backend (the fused kernel), and
checks exact pi/twin parity, a live spec group D, the device idle share,
the fused reduction mode, and the fused kernel against the split kernel
on every segment.

The port's ``run_mesh`` runs one shard per card and raises when there are
fewer cards than shards, so on one card the dry run has one shard; with
``device="cpu"`` every shard runs the kernels' plain versions on the CPU.

Usage: python -m sieve_torch.graft_entry [--device D]
(the dry run takes a shard per card, at most 8, or 2 shards on the CPU;
SIEVE_TRACE=FILE captures the whole dry run as Chrome trace-event JSON.)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np


def entry(device="cuda"):
    """The word kernel's forward step on the n=1e6 odds segment, and its
    example args: the host tables, as the kernel takes them. The step runs
    on ``device`` and returns one int64[4] there (count, pairs, first32,
    last32)."""
    from sieve_torch.backends.cuda import resolve_device
    from sieve_torch.backends.torch_words import prepare_segment
    from sieve_torch.kernels.pairs import TWIN_ADJ
    from sieve_torch.kernels.word_mark import mark_words
    from sieve_torch.seed import seed_primes

    dev = resolve_device(str(device))
    n = 10**6
    lo, hi = 2, n + 1
    seeds = seed_primes(math.isqrt(n))
    ts = prepare_segment("odds", lo, hi, seeds)
    Wpad, periods = ts.Wpad, ts.periods

    def forward(nbits, patterns, m2, r2, K2, rcp2, act2, ci, cm, pmask):
        return mark_words(
            Wpad, TWIN_ADJ, periods, nbits, patterns,
            m2, r2, K2, rcp2, act2, ci, cm, pmask, device=dev,
        )

    example_args = (
        np.int32(ts.nbits), ts.patterns, ts.m2, ts.r2, ts.K2, ts.rcp2,
        ts.act2, ts.corr_idx, ts.corr_mask, np.uint32(ts.pair_mask),
    )
    return forward, example_args


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The rounds path at n=3e7, ``n_devices`` shards x 2 rounds, twins, on
    the torch and cuda backends, with the reference's checks; returns the
    summary it prints last, with the fused and split kernels' launches
    (0 on the CPU)."""
    # n = 3e7 puts seed primes up to 5477 in the seed set, so strides above
    # 4096 bits populate group D of the fused kernel. Oracle pi/twin values:
    # the reference's (an independent numpy sieve), consistent with
    # BASELINE.md's table at the bracketing powers of ten.
    n = 30_000_000
    pi_n, twins_n = 1_857_859, 152_891
    from sieve_torch import env
    from sieve_torch.config import SieveConfig
    from sieve_torch.kernels.cuda_mark import (
        mark_fused,
        mark_split,
        prepare_cuda,
        spec_counts,
    )
    from sieve_torch.parallel.mesh import run_mesh
    from sieve_torch.seed import seed_primes
    from sieve_torch.segments import plan_segments

    # per-group spec counts of the first shard-segment (all shards share
    # the stride set; only phases differ): proves which groups are live
    segs = plan_segments(n, n_devices * 2)
    seeds = seed_primes(math.isqrt(n))
    counts = spec_counts(prepare_cuda("odds", segs[0].lo, segs[0].hi, seeds))
    print(f"dryrun_multichip: n={n} shards={n_devices}x2 rounds, "
          f"per-group specs {counts}")
    if counts["D"] <= 0:
        raise AssertionError("group D empty: the dry run proves too little")

    def run(backend: str):
        return run_mesh(SieveConfig(
            n=n, backend=backend, packing="odds", workers=n_devices,
            rounds=2,  # the streaming/multi-dispatch path too
            twins=True, quiet=True, device=str(device),
        ))

    launches0 = (mark_fused.launches, mark_split.launches)
    fused = None
    for backend in ("torch", "cuda"):
        # both mesh kernels: the word kernel (torch ops) and the fused
        # kernel, each under the rounds path's collective merge
        res = run(backend)
        if res.pi != pi_n or res.twin_pairs != twins_n:
            raise AssertionError(f"{backend}: pi(3e7), twins = {res.pi}, "
                                 f"{res.twin_pairs}; want {pi_n}, {twins_n}")
        ph = res.host_phases or {}
        idle = ph.get("device_idle_frac")
        print(f"dryrun_multichip: {backend} device_idle_frac={idle} "
              f"overlap_efficiency={ph.get('overlap_efficiency')}")
        if backend == "cuda":
            fused = res
            # streaming prepare must keep the device fed: host prep +
            # staging with an empty device queue under 10% of the run
            if idle is None or idle >= 0.10:
                raise AssertionError(
                    f"device idle fraction {idle} >= 0.10: host prepare is "
                    "back on the critical path")
            mode = ph.get("reduction_mode")
            if mode != "fused":
                raise AssertionError("expected the fused in-kernel reduction "
                                     f"by default, got reduction_mode={mode}")

    # fused vs split parity PER SHARD, not just totals: re-run the cuda
    # rounds path with the fused reduction off and compare every segment's
    # (count, twins, first_word, last_word), so that a fused-path bug that
    # cancels across shards cannot hide in the merged totals
    prev = env.env_str("SIEVE_PALLAS_FUSED")
    os.environ["SIEVE_PALLAS_FUSED"] = "0"
    try:
        split_res = run("cuda")
    finally:
        if prev is None:
            del os.environ["SIEVE_PALLAS_FUSED"]
        else:
            os.environ["SIEVE_PALLAS_FUSED"] = prev
    if (split_res.host_phases or {}).get("reduction_mode") != "split":
        raise AssertionError("SIEVE_PALLAS_FUSED=0 did not select the split kernel")
    fused_segs = {s.seg_id: s for s in fused.segments}
    for s in split_res.segments:
        f = fused_segs[s.seg_id]
        got = (f.count, f.twin_count, f.first_word, f.last_word)
        want = (s.count, s.twin_count, s.first_word, s.last_word)
        if got != want:
            raise AssertionError(
                f"fused/split shard divergence at seg {s.seg_id} "
                f"[{s.lo}, {s.hi}): fused {got} != split {want}")
    summary = {
        "reduction_mode": "fused",
        "fused_split_shard_parity": len(split_res.segments),
        "spec_counts": counts,
        "device_idle_frac": (fused.host_phases or {}).get("device_idle_frac"),
        "launches": {"fused": mark_fused.launches - launches0[0],
                     "split": mark_split.launches - launches0[1]},
    }
    print("dryrun_multichip: " + json.dumps(summary))
    return summary


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the card must exist) or cpu")
    args = p.parse_args(argv)

    import torch

    from sieve_torch import env, trace
    from sieve_torch.backends.cuda import resolve_device

    dev = resolve_device(args.device)
    shards = min(8, torch.cuda.device_count()) if dev.type == "cuda" else 2
    # SIEVE_TRACE=FILE captures the whole dry run as Chrome trace-event
    # JSON (host spans: round phases, prepare threads, per-segment
    # timings); summarize with ``python -m sieve_torch.tools.trace_report``
    trace_out = env.env_str("SIEVE_TRACE")
    if trace_out:
        trace.enable()
    fn, fargs = entry(dev)
    out = fn(*fargs)
    print("entry() ok:", out.cpu().tolist())
    dryrun_multichip(shards, str(dev))
    if trace_out:
        trace.disable()
        trace.save(trace_out)
        print(f"trace written to {trace_out}")
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
