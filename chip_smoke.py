#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds it
bit for bit against its plain PyTorch version on the card, drives the
port's counting run through its command line at full size, checks that
every device segment went through the kernel, and times the kernel. Each
phase prints its lines; any failure raises, so the script exits non-zero
and prints no result. The last three lines are the kernel table (JSON),
the card's name and power limit, and the result line:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Exits non-zero when torch sees no CUDA device, and when run outside a
checkout of the repository.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from sieve_torch.bitset import get_layout
from sieve_torch.cli import main as sieve_torch_main
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.kernels import build, pairs
from sieve_torch.kernels.cuda_mark import (
    fused_inputs,
    launch_fused,
    mark_fused,
    mark_fused_reference,
    prepare_cuda,
    spec_counts,
)
from sieve_torch.segments import plan_segments
from sieve_torch.seed import seed_primes

HBM_BYTES_PER_S = 3.35e12        # H100 SXM published device memory rate
INT32_LANES_PER_SM = 64          # Hopper: 32-bit add, shift, logic per SM per clock
POPC_LANES_PER_SM = 16           # Hopper: population counts per SM per clock
SPIN_CYCLES = 2_000_000          # ~1 ms at the H100's clock
KINDS = ("none", "twins", "cousins")
# (packing, lo, hi, seed limit or None for isqrt(hi - 1), env) of the
# kernel-vs-plain segments: a multi-tile and an in-tile sliver segment per
# packing, the group-D segment, a non-empty flat list, one n=1e8 segment
CHECK_SEGMENTS = [
    ("odds", 2_000_003, 6_000_001, None, {}),
    ("odds", 1_001, 33_001, None, {}),
    ("wheel30", 2, 3_000_001, None, {}),
    ("wheel30", 1_013, 37_017, None, {}),
    ("plain", 2, 500_002, None, {}),
    ("plain", 977, 40_001, None, {}),
    ("odds", 2_000_003, 24_000_001, math.isqrt(30_000_000), {}),
    ("odds", 2_000_003, 12_000_001, 5477, {"SIEVE_PALLAS_FLAT_MIN": "4097"}),
    ("odds", 2, 10**8 + 1, None, {}),
    ("plain", 2, 10**8 + 1, None, {}),
    ("wheel30", 2, 10**8 + 1, None, {}),
    # the last segment of the main path's n=1e10 odds run in 5 segments
    ("odds", 8_000_000_000, 10**10 + 1, 10**5, {}),
]
PI = {10**8: 5_761_455, 10**9: 50_847_534, 10**10: 455_052_511}
TWINS = {10**9: 3_424_506, 10**10: 27_412_679}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def env_set(values: dict):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device: this smoke test needs the card")
    card = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    log("device", card)
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"python {sys.version.split()[0]}")
    log("device", f"{props.name}: {props.multi_processor_count} SMs, "
                  f"max SM clock {max_sm_mhz:.0f} MHz, "
                  f"{props.total_memory / 2**30:.1f} GiB")
    return {"card": card, "sms": props.multi_processor_count,
            "max_sm_mhz": max_sm_mhz, "name": torch.cuda.get_device_name(0)}


def phase_build() -> None:
    info = build.build(force=True)
    log("build", f"fused_mark: nvcc {info['seconds']:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("build", "  " + line.strip())


def _segment(packing, lo, hi, limit, gap):
    seeds = seed_primes(limit if limit is not None else math.isqrt(hi - 1))
    return prepare_cuda(packing, lo, hi, seeds, pair_gap=gap)


def _kind(packing, gapname):
    if gapname == "none":
        return pairs.TWIN_NONE
    return (pairs.TWIN_KIND if gapname == "twins" else pairs.COUSIN_KIND)[packing]


def phase_kernel_vs_plain(device="cuda", segments=CHECK_SEGMENTS) -> int:
    """Kernel against its plain version on the same tables: the four
    scalars without and with need_bits, and the need_bits words bit for
    bit. Returns the largest absolute difference seen (0 when exact)."""
    worst, failures = 0, []
    for packing, lo, hi, limit, env in segments:
        for gapname in KINDS:
            with env_set(env):
                seg = _segment(packing, lo, hi, limit, 4 if gapname == "cousins" else 2)
            kind = _kind(packing, gapname)
            plain_s, plain_w = mark_fused_reference(seg, kind, need_bits=True,
                                                    device=device)
            got_s = mark_fused(seg, kind, device=device)
            got_sb, got_w = mark_fused(seg, kind, need_bits=True, device=device)
            diff = max(
                max(abs(a - b) for a, b in zip(got_s, plain_s)),
                max(abs(a - b) for a, b in zip(got_sb, plain_s)),
                int(np.abs(got_w.astype(np.int64) - plain_w.astype(np.int64)).max()),
            )
            worst = max(worst, diff)
            ok = diff == 0 and got_w.shape == plain_w.shape
            if not ok:
                failures.append((packing, lo, hi, gapname))
            log("kernel", f"{packing:7s} [{lo}, {hi}) {gapname:7s} "
                          f"tiles={seg.Wpad // 16384} {spec_counts(seg)} "
                          f"scalars={got_s} {'exact' if ok else 'MISMATCH plain=' + str(plain_s)}")
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version on {failures}")
    return worst


def _device_segments(argv_n: int, packing: str, n_segments: int) -> int:
    layout = get_layout(packing)
    return sum(layout.nbits(s.lo, s.hi) >= pairs.MIN_DEVICE_BITS
               for s in plan_segments(argv_n, n_segments))


def run_cli(argv: list[str]) -> tuple[dict, float]:
    """``python -m sieve_torch <argv> --json`` in this process (so the
    launch counter sees it); returns the result object and the wall time."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = sieve_torch_main(argv + ["--json"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"python -m sieve_torch {' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue().splitlines()[-1]), wall


def phase_main_path(device="cuda", sizes=None) -> tuple[int, int]:
    """The counting run through the CLI, at full size. Returns (launches
    counted, device segments processed)."""
    sizes = sizes or {"big": 10**10, "mid": 10**9, "small": 10**8}
    runs = [(["--n", str(sizes["big"]), "--packing", "odds", "--twins",
              "--segments", "5"], "odds", 5, "twins")]
    runs += [(["--n", str(sizes["mid"]), "--packing", p, "--twins"], p, 1, "twins")
             for p in ("plain", "odds", "wheel30")]
    runs += [(["--n", str(sizes["small"]), "--packing", p, "--count-kind", k,
               "--segments", "4"], p, 4, k)
             for p in ("plain", "odds", "wheel30")
             for k in ("primes", "twins", "cousins")]
    launches = expected = 0
    for argv, packing, nseg, kind in runs:
        n = int(argv[1])
        mark_fused.launches = 0
        got, wall = run_cli(argv + ["--backend", "cuda", "--device", device])
        counted = mark_fused.launches
        want = _device_segments(n, packing, nseg)
        launches += counted
        expected += want
        ph = got["host_phases"] or {}
        log("main", f"sieve_torch {' '.join(argv)}: pi {got['pi']} pairs "
                    f"{got['twin_pairs']} | run {got['elapsed_s']:.4f} s, "
                    f"{got['values_per_sec']:.4e} values/s (wall {wall:.4f} s) | "
                    f"prep {ph.get('prep_s')} s, device {ph.get('postlude_fused_s')} s"
                    f" | launches {counted}/{want}")
        if n in PI and got["pi"] != PI[n]:
            raise AssertionError(f"pi({n}) = {got['pi']}, expected {PI[n]}")
        if n in TWINS and kind == "twins" and got["twin_pairs"] != TWINS[n]:
            raise AssertionError(
                f"twins({n}) = {got['twin_pairs']}, expected {TWINS[n]}")
        if counted != want:
            raise AssertionError(
                f"{argv}: {counted} kernel launches for {want} device segments")
        if n == sizes["small"]:
            cfg = dict(n=n, packing=packing, n_segments=nseg, count_kind=kind,
                       quiet=True)
            mark_fused.launches = 0
            a = run_local(SieveConfig(backend="cuda", device=device, **cfg))
            b = run_local(SieveConfig(backend="cpu-numpy", **cfg))
            strip = lambda r: (r.pi, r.twin_pairs, r.n_segments,
                               [dict(s.to_dict(), elapsed_s=0) for s in r.segments])
            if strip(a) != strip(b):
                raise AssertionError(f"{argv}: cuda and cpu-numpy results differ")
            launches += mark_fused.launches
            expected += want
            log("main", f"  == cpu-numpy SieveResult (pi {b.pi}, pairs {b.twin_pairs})")
    return launches, expected


def _hits(table: tuple, nbits: int) -> int:
    """Bits in [0, nbits) that the live specs of one group table clear:
    spec (m, r) hits r, r + m, ... below nbits."""
    m, rk, act = table[0].ravel(), table[1].ravel(), table[-1].ravel()
    live = act != 0
    m = m[live].astype(np.int64)
    r = rk[live].astype(np.int64) % m
    return int(np.maximum(0, -(-(nbits - r) // m)).sum())


def _work(seg, shift: int) -> dict:
    """The integer work the function needs on this segment's data,
    whatever the kernel does: one pattern AND per (word, live group-A
    spec); one clear per hit of groups B, C and D; one AND or OR per flat
    clear and correction word; per word one popcount, and with a pair
    count two shifts, an OR, two ANDs and a second popcount."""
    W = -(-seg.nbits // 32)
    c = spec_counts(seg)
    hits = {g: _hits(t, seg.nbits) for g, t in (("B", seg.B), ("C", seg.C), ("D", seg.D))}
    alu = (W * c["A"] + sum(hits.values()) + c["flat_words"] + c["corr_words"]
           + (5 * W if shift else 0))
    return {"words": W, "A_ops": W * c["A"], "hits": hits, "alu": alu,
            "popc": W * (2 if shift else 1)}


def _bound(seg, x, dev: dict, shift: int, need_bits: bool):
    """Least time for the work of one segment: the larger of the integer
    operations over their peak (32-bit ALU ops and population counts on
    their own units, each at SMs x lanes x max SM clock) and the bytes
    (inputs read once, the outputs written once) over the memory rate.
    Returns (ms, bound_by, work, alu_peak, popc_peak)."""
    work = _work(seg, shift)
    clock = dev["max_sm_mhz"] * 1e6
    alu_peak = dev["sms"] * INT32_LANES_PER_SM * clock
    popc_peak = dev["sms"] * POPC_LANES_PER_SM * clock
    t_ops = max(work["alu"] / alu_peak, work["popc"] / popc_peak)
    nbytes = 4 * (x.buf.numel() + 4 + (seg.Wpad if need_bits else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", work, alu_peak, popc_peak
    return t_bytes * 1e3, "bytes", work, alu_peak, popc_peak


def _event_ms(fn, reps: int) -> list[float]:
    """Device time of fn() by CUDA events, one sample per call. A spin
    kernel of about 1 ms runs ahead of the start event, so the host has
    queued fn's launch before the window opens and its enqueue cost stays
    outside the window."""
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return ms


def _host_ms(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_times(dev: dict, reps: int = 20) -> dict:
    """The n=1e9 odds segment, without and with need_bits: the kernel by
    CUDA events (median over reps after a warm-up), the plain version by
    host clock around a synchronised run, and the bound. Returns the
    counting variant's numbers."""
    kind = pairs.TWIN_ADJ
    seg = _segment("odds", 2, 10**9 + 1, None, 2)
    x = fused_inputs(seg, "cuda")
    out = {}
    for need_bits in (False, True):
        for _ in range(3):
            launch_fused(x, kind, need_bits)
        ms = _event_ms(lambda: launch_fused(x, kind, need_bits), reps)
        plain = [_host_ms(lambda: mark_fused_reference(seg, kind, need_bits,
                                                       device="cuda"))
                 for _ in range(2)]
        want = plain[0][1]
        result, words = launch_fused(x, kind, need_bits)
        got = tuple(int(v) for v in result.cpu().numpy().view(np.uint32))
        if need_bits:
            got = (got, words.cpu().numpy().view(np.uint32).reshape(-1, 128))
            ok = got[0] == want[0] and np.array_equal(got[1], want[1])
        else:
            ok = got == want
        if not ok:
            raise AssertionError(f"timed segment, need_bits={need_bits}: "
                                 "kernel and plain version differ")
        bound_ms, bound_by, work, alu_peak, popc_peak = _bound(
            seg, x, dev, pairs.PAIR_SHIFT[kind], need_bits)
        label = "need_bits" if need_bits else "counting"
        plain_ms = min(t for t, _ in plain)
        med = statistics.median(ms)
        log("times", f"{dev['card']}: n=1e9 odds segment ({label}), Wpad={seg.Wpad}, "
                     f"kernel median {med:.4f} ms (min {min(ms):.4f}, "
                     f"max {max(ms):.4f}, {reps} runs), plain version {plain_ms:.1f} ms, "
                     f"bound {bound_ms:.4f} ms by {bound_by} ({med / bound_ms:.1f}x)")
        if not need_bits:
            out = {"ms": med, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by}
    log("times", f"bound: {work['words']} words, {spec_counts(seg)}; group A "
                 f"{work['A_ops']} pattern ANDs, hits {work['hits']}; "
                 f"{work['alu']:.4e} 32-bit ALU ops over {alu_peak:.4e} ops/s "
                 f"({dev['sms']} SMs x {INT32_LANES_PER_SM} lanes x "
                 f"{dev['max_sm_mhz']:.0f} MHz max SM clock), {work['popc']:.4e} "
                 f"popcounts over {popc_peak:.4e} /s ({POPC_LANES_PER_SM} lanes); "
                 f"against bytes over {HBM_BYTES_PER_S:.3e} B/s")
    log("times", "library: no single PyTorch call computes this function")
    return out


def main() -> int:
    dev = phase_device()
    t0 = time.perf_counter()
    phase_build()
    log("build", f"done in {time.perf_counter() - t0:.1f} s")
    worst = phase_kernel_vs_plain()
    log("kernel", f"bit-exact on {len(CHECK_SEGMENTS) * len(KINDS)} "
                  f"(segment, kind) pairs, max abs err {worst} "
                  "(tolerance 0: the arithmetic is integer)")
    launches, expected = phase_main_path()
    log("launches", f"mark_fused launched {launches} times for {expected} "
                    "device segments over the main-path runs")
    times = phase_times(dev)
    kernels = [{
        "name": "fused_mark",
        "route": "cuda",
        "source": "sieve_torch/kernels/csrc/fused_mark.cu",
        "replaces": "sieve/kernels/pallas_mark.py:694",
        "launches": launches,
        "max_abs_err": worst,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(dev["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
