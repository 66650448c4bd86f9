"""Mesh cold-plane smoke: one batched drain against K sequential
markings, on the port's ``MeshWorker`` (the service's
``--cold-backend mesh``, the word kernel over every device).

1. parity — a chunk grid per packing (plain / odds / wheel30, twins on
   and off) that includes a sub-word sliver (the numpy path for segments
   under 64 candidate bits) and a deliberately non-power-of-two chunk
   count (pad rows and their dropping exercised on every launch). Every
   ``MeshWorker`` result must match the ``CpuNumpyWorker`` reference
   field by field, and every prime count must also match a direct numpy
   segmented sieve built here from the seed primes — two independent
   oracles, so a wrong mesh launch cannot hide behind a shared bug.
2. throughput — values/s through one drain of equal-span cold chunks,
   mesh (ONE batched launch for the lot) against loop (the torch
   backend's ``process_segment`` per chunk, the same word kernel). Both
   sides are warmed and held against each other, and the launch counter
   must show exactly one mesh launch per drain. The JSON line carries the
   reference's keys (unit ``cold_throughput``; ``vs_baseline`` is the
   mesh/loop speedup) and the device it ran on.

The port of the reference's tools/mesh_cold_smoke.py, whose mesh is an
8-device virtual CPU mesh: here the mesh spans the cards torch sees for
``--device cuda`` (one on a one-card host), or the CPU.

Exit status: 0 on full parity (MESH_COLD_SMOKE_OK), 1 on any violation.

Usage: python -m sieve_torch.tools.mesh_cold_smoke [--chunks K] [--span BITS]
           [--device D]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from sieve_torch.backends.cuda import resolve_device


class SmokeFailure(Exception):
    """A parity or launch-count violation."""


def fail(msg: str) -> None:
    raise SmokeFailure(msg)


def oracle_count(lo: int, hi: int, seeds: np.ndarray) -> int:
    """Independent prime count for [lo, hi): direct numpy segmented
    sieve from the seed primes — no marking code of the port involved."""
    is_p = np.ones(hi - lo, dtype=bool)
    for v in range(lo, min(hi, 2)):
        is_p[v - lo] = False
    for p in seeds:
        p = int(p)
        if p * p >= hi:
            break
        start = max(p * p, ((lo + p - 1) // p) * p)
        is_p[start - lo:: p] = False
    return int(is_p.sum())


def _cfg(packing: str, twins: bool, n: int, device: str):
    from sieve_torch.config import SieveConfig

    return SieveConfig(
        n=n, backend="torch", packing=packing, twins=twins,
        n_segments=1, quiet=True, device=device,
    )


# parity grid: a sub-word sliver (numpy path), word-unaligned spans, and
# 5 equal-span chunks — not a power of two, so every launch pads rows and
# must drop them exactly
PARITY_SEGS = [
    (2, 40),
    (1_000, 9_000),
    (9_000, 17_192),
    (60_000, 68_192),
    (68_192, 76_384),
]


def parity_check(device: str) -> None:
    from sieve_torch.backends.cpu_numpy import CpuNumpyWorker
    from sieve_torch.backends.mesh_backend import MeshWorker
    from sieve_torch.seed import seed_primes

    hi_max = max(hi for _, hi in PARITY_SEGS)
    seeds = seed_primes(int(hi_max ** 0.5) + 1)
    for packing in ("plain", "odds", "wheel30"):
        for twins in (False, True):
            cfg = _cfg(packing, twins, hi_max, device)
            mesh = MeshWorker(cfg)
            ref = CpuNumpyWorker(cfg)
            got = mesh.process_segments(PARITY_SEGS, seeds)
            for i, (lo, hi) in enumerate(PARITY_SEGS):
                want = ref.process_segment(lo, hi, seeds, i)
                for f in ("seg_id", "lo", "hi", "count", "twin_count",
                          "first_word", "last_word", "nbits"):
                    g, w = getattr(got[i], f), getattr(want, f)
                    if g != w:
                        fail(
                            f"parity {packing}/twins={twins} "
                            f"[{lo},{hi}) field {f}: mesh={g} cpu={w}"
                        )
                oc = oracle_count(lo, hi, seeds)
                if got[i].count != oc:
                    fail(
                        f"oracle {packing}/twins={twins} [{lo},{hi}): "
                        f"mesh count={got[i].count} oracle={oc}"
                    )
            if mesh.launches < 1:
                fail(f"parity {packing}: no mesh launches recorded")
            mesh.close()
            ref.close()
    print("parity: plain/odds/wheel30 x twins on/off exact "
          "(mesh vs cpu-numpy vs direct oracle)", flush=True)


def throughput(chunks: int, span_bits: int, device: str) -> dict:
    from sieve_torch.backends.mesh_backend import MeshWorker
    from sieve_torch.backends.torch_words import TorchWorker
    from sieve_torch.seed import seed_primes

    span = 1 << span_bits
    lo0 = 10_000_000
    segs = [(lo0 + i * span, lo0 + (i + 1) * span) for i in range(chunks)]
    hi_max = segs[-1][1]
    seeds = seed_primes(int(hi_max ** 0.5) + 1)
    cfg = _cfg("odds", False, hi_max, device)

    mesh = MeshWorker(cfg)
    mesh.process_segments(segs, seeds)  # warm: first launch + prepare chain
    launches0 = mesh.launches
    t0 = time.perf_counter()
    mesh_res = mesh.process_segments(segs, seeds)
    mesh_s = time.perf_counter() - t0
    drain_launches = mesh.launches - launches0
    if drain_launches != 1:
        fail(
            f"one drain of {chunks} equal-span chunks took "
            f"{drain_launches} batched launches (want exactly 1)"
        )

    # the loop alternative: the same word kernel, one process_segment
    # launch per chunk
    loop = TorchWorker(cfg)
    for i, (lo, hi) in enumerate(segs):  # warm
        loop.process_segment(lo, hi, seeds, i)
    t0 = time.perf_counter()
    loop_res = [
        loop.process_segment(lo, hi, seeds, i)
        for i, (lo, hi) in enumerate(segs)
    ]
    loop_s = time.perf_counter() - t0

    for m, l_ in zip(mesh_res, loop_res):
        if (m.count, m.first_word, m.last_word) != (
            l_.count, l_.first_word, l_.last_word
        ):
            fail(f"mesh vs loop drift at [{m.lo},{m.hi})")
    values = chunks * span
    out = {
        "metric": "service_cold_drain_throughput",
        "value": round(values / mesh_s, 1),
        "unit": "cold_throughput",
        "vs_baseline": round(loop_s / mesh_s, 3),
        "loop_values_per_sec": round(values / loop_s, 1),
        "chunks": chunks,
        "devices": mesh.devices,
        "spmd_launches": drain_launches,
        "device": device,
    }
    mesh.close()
    loop.close()
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chunks", type=int, default=16,
                   help="cold chunks per drain slice (default 16)")
    p.add_argument("--span", type=int, default=16,
                   help="log2 chunk span (default 16 -> 65536 values)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = str(resolve_device(args.device))
    try:
        parity_check(device)
        line = throughput(args.chunks, args.span, device)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    print(json.dumps(line), flush=True)
    print("MESH_COLD_SMOKE_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
