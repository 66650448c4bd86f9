"""Kernel microbenchmark: steady-state ``mark_words`` (the torch
backend's word kernel, torch ops) on one big odds segment, the first
call's time printed apart from the best of 3 after it. ``--cuda`` runs
``mark_cuda`` (the fused Hopper kernel, or the split kernel and its
postlude under SIEVE_PALLAS_FUSED=0) instead. SIEVE_TIER1_MAX moves
specs between the word kernel's tiers; tier 2's work is its hits.

Usage: python -m sieve_torch.tools.microbench [n] [n_segments] [--cuda]
           [--device D]

The port of the reference's tools/microbench.py (its ``--pallas`` is
``--cuda``; its first call is a compile, here a first launch and, for
``--cuda``, the kernel library's build or load). Times are host clock
around a call that ends in the result's fetch; with ``--device cpu`` the
ops or the plain versions run on the CPU.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

from sieve_torch.backends.cuda import resolve_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", default="1e9")
    p.add_argument("n_segments", nargs="?", type=int, default=1)
    p.add_argument("--cuda", action="store_true",
                   help="time mark_cuda (the hand kernel) instead")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    n = int(float(a.n))
    dev = resolve_device(a.device)

    from sieve_torch.backends.torch_words import prepare_segment
    from sieve_torch.kernels import word_mark
    from sieve_torch.kernels.pairs import TWIN_KIND
    from sieve_torch.seed import seed_primes
    from sieve_torch.segments import plan_segments

    seeds = seed_primes(math.isqrt(n))
    seg = plan_segments(n, a.n_segments)[0]
    kind = TWIN_KIND["odds"]

    if a.cuda:
        from sieve_torch.kernels.cuda_mark import mark_cuda, prepare_cuda

        ts = prepare_cuda("odds", seg.lo, seg.hi, seeds)
        print(f"CUDA n={n:.0e} segs={a.n_segments} nbits={ts.nbits} "
              f"Wpad={ts.Wpad} SB={ts.B[0].shape[1]} SC={ts.C[0].shape[1]} "
              f"device={dev}")

        def call():
            return list(mark_cuda(ts, kind, device=dev))
    else:
        ts = prepare_segment("odds", seg.lo, seg.hi, seeds)
        hits = word_mark._tier2_plan(32 * ts.Wpad, ts.m2[None], ts.r2[None],
                                     ts.act2[None], word_mark.TIER2_CHUNK).hits
        print(f"n={n:.0e} segs={a.n_segments} nbits={ts.nbits} Wpad={ts.Wpad} "
              f"tier1={len(ts.periods)} patterns (TIER1_MAX={word_mark.TIER1_MAX}) "
              f"tier2={ts.m2.size} specs, {hits} hits "
              f"device={dev}")

        def call():
            out = word_mark.mark_words(
                ts.Wpad, kind, ts.periods, ts.nbits, ts.patterns, ts.m2,
                ts.r2, ts.K2, ts.rcp2, ts.act2, ts.corr_idx, ts.corr_mask,
                ts.pair_mask, device=dev)
            return out.cpu().tolist()  # packed (count, pairs, first, last)

    t0 = time.perf_counter()
    out = call()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = call()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(f"first call={first_s:.4f}s run(best of 3)={best * 1e3:.4f}ms "
          f"({2 * ts.nbits / best:.3e} values/s for this segment, {dev}) "
          f"count={out[0]}")
    print(f"segment (count, pairs, first, last) = {tuple(int(v) for v in out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
