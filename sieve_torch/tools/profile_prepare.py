"""Per-phase breakdown of host spec preparation.

Times the incremental chains (CudaChain / TieredChain) over a run of
contiguous depth-regime segments and splits steady-state cost into the
phases the chains instrument — residue math (the O(1) modular advance),
grouping/compaction (A/B/C/D assembly or tier-2 table build), flat
crossing enumeration, corrections merge — plus the rounds-path stacking
cost that follows prepare on the round critical path. From-scratch
prepare of the same segments is timed for comparison, so the tool answers
"where does the remaining host-prepare time go, and what did incremental
reuse buy".

Host-only (numpy): no device, no kernel. The port of the reference's
tools/profile_prepare.py, with the same argv and phase tables.

usage: python -m sieve_torch.tools.profile_prepare [span] [segments] [packing]
    span      per-segment value span        (default 1e8)
    segments  timed steady-state segments   (default 8)
    packing   plain | odds | wheel30        (default odds)
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

DEPTH_HI = 10**12 + 1  # seed set = the full 78,498 primes below 10^6


def _phase_table(title: str, phases: dict[str, float], total: float,
                 nseg: int) -> None:
    print(f"{title}  ({total / nseg * 1e3:.1f} ms/segment)")
    other = total - sum(phases.values())
    for k, v in [*phases.items(), ("other", other)]:
        pct = 100.0 * v / total if total > 0 else 0.0
        print(f"    {k:<14} {v / nseg * 1e3:9.2f} ms/seg  {pct:5.1f}%")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    span = int(float(argv[0])) if len(argv) > 0 else 10**8
    nseg = int(argv[1]) if len(argv) > 1 else 8
    packing = argv[2] if len(argv) > 2 else "odds"

    from sieve_torch.bitset import get_layout
    from sieve_torch.kernels.cuda_mark import TILE_WORDS, CudaChain, prepare_cuda
    from sieve_torch.kernels.specs import TieredChain, prepare_tiered
    from sieve_torch.kernels.word_mark import SPEC_BLOCK, TIER1_MAX, WORD_BUCKET
    from sieve_torch.seed import seed_primes

    lo0 = 10**12 - (nseg + 1) * span
    seeds = seed_primes(math.isqrt(DEPTH_HI - 1))
    layout = get_layout(packing)
    bounds = [(lo0 + i * span, lo0 + (i + 1) * span) for i in range(nseg + 1)]
    W = max(-(-layout.nbits(lo, hi) // 32) for lo, hi in bounds)
    wpad = -(-(W + 1) // TILE_WORDS) * TILE_WORDS
    print(f"packing={packing} span={span:.0e} segments={nseg} "
          f"seeds={seeds.size} wpad={wpad}")

    # ---- cuda chain: steady state after the init segment ----
    chain = CudaChain(packing, seeds, wpad)
    t0 = time.perf_counter()
    chain.prepare(*bounds[0])
    init_s = time.perf_counter() - t0
    base = dict(chain.phase_seconds)
    t0 = time.perf_counter()
    preps = [chain.prepare(lo, hi) for lo, hi in bounds[1:]]
    incr_s = time.perf_counter() - t0
    phases = {
        k: v - base.get(k, 0.0) for k, v in chain.phase_seconds.items()
    }
    print(f"\nCudaChain init segment (from-scratch residues): "
          f"{init_s * 1e3:.1f} ms")
    _phase_table("CudaChain steady-state prepare", phases, incr_s, nseg)

    # stacking of the round batch, as the reference's mesh path stacks its
    # rounds (what follows prepare on the round critical path)
    t0 = time.perf_counter()
    [np.stack([p.A[i] for p in preps]) for i in range(6)]
    [np.stack([p.B[i] for p in preps]) for i in range(6)]
    [np.stack([p.C[i] for p in preps]) for i in range(4)]
    [np.stack([p.D[i] for p in preps]) for i in range(4)]
    np.stack([p.corr_idx for p in preps])
    np.stack([p.corr_mask for p in preps])
    np.stack([p.flat_idx for p in preps])
    np.stack([p.flat_mask for p in preps])
    stack_s = time.perf_counter() - t0
    print(f"    mesh stacking  {stack_s / nseg * 1e3:9.2f} ms/seg")

    t0 = time.perf_counter()
    for lo, hi in bounds[1:3]:
        prepare_cuda(packing, lo, hi, seeds, wpad=wpad)
    scratch = (time.perf_counter() - t0) / 2
    print(f"from-scratch prepare_cuda: {scratch * 1e3:.1f} ms/segment "
          f"-> chain speedup {scratch / (incr_s / nseg):.2f}x")

    # ---- word-kernel tiered chain ----
    tchain = TieredChain(packing, seeds, TIER1_MAX, SPEC_BLOCK, WORD_BUCKET)
    tchain.prepare(*bounds[0])
    tbase = dict(tchain.phase_seconds)
    t0 = time.perf_counter()
    for lo, hi in bounds[1:]:
        tchain.prepare(lo, hi)
    tincr_s = time.perf_counter() - t0
    tphases = {
        k: v - tbase.get(k, 0.0) for k, v in tchain.phase_seconds.items()
    }
    print()
    _phase_table("TieredChain steady-state prepare", tphases, tincr_s, nseg)

    t0 = time.perf_counter()
    for lo, hi in bounds[1:3]:
        prepare_tiered(packing, lo, hi, seeds, tier1_max=TIER1_MAX,
                       spec_block=SPEC_BLOCK, word_bucket=WORD_BUCKET)
    tscratch = (time.perf_counter() - t0) / 2
    print(f"from-scratch prepare_tiered: {tscratch * 1e3:.1f} ms/segment "
          f"-> chain speedup {tscratch / (tincr_s / nseg):.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
