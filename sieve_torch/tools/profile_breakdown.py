"""Decompose the n=1e9 single-segment run on the cuda backend: host
prepare, the steady-state incremental prepare by phase, the pinned copy
of the tables, the kernels (split alone, split + postlude, fused), the
wrapper end to end, and the coordinator's overhead (``run_local`` against
the sum of its parts).

Usage: python -m sieve_torch.tools.profile_breakdown [n] [--device D]

Every line is the best of 3 after a warm-up. Device lines are CUDA-event
times on a card; with ``--device cpu`` the plain versions run and every
line is host clock on the CPU. The port of the reference's
tools/profile_breakdown.py.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

from sieve_torch.backends.cuda import resolve_device
from sieve_torch.tools import best_of, clock_name, sync


def t(fn, reps: int = 3):
    """Best host-clock seconds of ``fn`` over ``reps`` calls, and its
    last result."""
    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", default="1e9")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    n = int(float(a.n))
    dev = resolve_device(a.device)

    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local
    from sieve_torch.kernels.cuda_mark import (
        CudaChain,
        _split_words,
        fused_inputs,
        fused_reduce,
        launch_fused,
        mark_fused,
        prepare_cuda,
        split_reduce,
    )
    from sieve_torch.kernels.pairs import TWIN_NONE
    from sieve_torch.seed import seed_primes

    lo, hi = 2, n + 1
    seeds = seed_primes(math.isqrt(n))
    clock = clock_name(dev)
    print(f"n={n:.0e} seeds={seeds.size} device={dev}")

    dt, seg = t(lambda: prepare_cuda("odds", lo, hi, seeds))
    print(f"prepare_cuda (host):           {dt * 1e3:10.4f} ms")

    # the incremental chain (what the local and rounds paths pay per
    # segment after their first): re-preparing the same segment is a
    # zero-delta advance, i.e. exactly the steady-state cost
    chain = CudaChain("odds", seeds, seg.Wpad)
    chain.prepare(lo, hi)  # init: the one from-scratch residue derivation
    base = dict(chain.phase_seconds)
    reps = 3
    dt_chain, _ = t(lambda: chain.prepare(lo, hi), reps=reps)
    phases = " ".join(
        f"{k}={(v - base.get(k, 0.0)) / reps * 1e3:.4f}"
        for k, v in chain.phase_seconds.items()
    )
    print(f"chain prepare (host, incr):    {dt_chain * 1e3:10.4f} ms   "
          f"avg phases ms: {phases}")
    SB, SC = seg.B[0].shape[1], seg.C[0].shape[1]
    ND = seg.D[0].shape[0] if seg.D[3].any() else 0
    print(f"  Wpad={seg.Wpad} SB={SB} SC={SC} ND={ND} "
          f"CC={seg.corr_idx.shape[1]} FC={seg.flat_idx.shape[1]}")

    def copy():
        x = fused_inputs(seg, dev)
        sync(dev)
        return x

    copy()
    dt_copy, x = t(copy)
    print(f"{'tables to ' + dev.type + ' (one copy):':<31}{dt_copy * 1e3:10.4f} ms")

    kind = TWIN_NONE
    dt_mark = best_of(lambda: _split_words(x), 1, 3, dev)
    print(f"split kernel only:             {dt_mark * 1e3:10.4f} ms ({clock})")
    dt = best_of(lambda: split_reduce(x, kind), 1, 3, dev)
    print(f"split kernel + postlude:       {dt * 1e3:10.4f} ms ({clock})")
    fused = ((lambda: launch_fused(x, kind)) if dev.type == "cuda"
             else (lambda: fused_reduce(x, kind)))
    dt_fused = best_of(fused, 1, 3, dev)
    print(f"fused mark+reduce:             {dt_fused * 1e3:10.4f} ms ({clock})   "
          f"(split mark {dt_mark * 1e3:.4f} ms, in-kernel reduce "
          f"~{max(0.0, dt_fused - dt_mark) * 1e3:.4f} ms)")

    mark_fused(seg, kind, device=dev)
    dt_e2e, res = t(lambda: mark_fused(seg, kind, device=dev))
    print(f"mark_fused end-to-end:         {dt_e2e * 1e3:10.4f} ms   "
          f"(copy, launch, fetch; host clock)")
    print(f"segment (count, pairs, first, last) = {res}")

    cfg = SieveConfig(n=n, backend="cuda", packing="odds", n_segments=1,
                      twins=False, quiet=True, device=str(dev))
    run_local(cfg)
    dt_run, r = t(lambda: run_local(cfg))
    parts = dt_chain + dt_e2e
    print(f"run_local end-to-end:          {dt_run * 1e3:10.4f} ms   pi={r.pi}")
    print(f"coordinator overhead:          {(dt_run - parts) * 1e3:10.4f} ms   "
          f"(run_local less chain prepare and mark_fused end-to-end)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
