#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--other DIR ...]

Builds the port's CUDA kernels (fused and split marking) from the sources
in this checkout, holds each bit for bit against its plain PyTorch version
on the card, drives the port's counting run and its rounds path (the
n=1e11 streaming run, a split-mode checkpointed run and its resume) through
their entry points at full size, checks that every device segment went
through the kernel of its mode, and times the kernels and the split
postlude, whole and with one spec group live at a time. Each ``--other
DIR`` names a checkout of another commit (the parent, unpacked with ``git
archive``) or a variant of these sources, whose kernels are built too and
timed in turns with these in the group phase (others, this, this, others
reversed), labelled by the directory's name. Each phase prints its lines;
any failure raises, so the script exits non-zero and prints no result. The
last three lines are the kernel table (JSON), the card's name and power
limit, and the result line:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Exits non-zero when torch sees no CUDA device, and when run outside a
checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from sieve_torch.bitset import get_layout
from sieve_torch.cli import main as sieve_torch_main
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.kernels import build, pairs
from sieve_torch.kernels.cuda_mark import (
    _SPLIT_ARRAYS,
    CudaChain,
    fused_inputs,
    launch_fused,
    launch_split,
    mark_cuda_split,
    mark_fused,
    mark_fused_reference,
    mark_split,
    mark_split_reference,
    prepare_cuda,
    spec_counts,
    split_reduce,
)
from sieve_torch.kernels.reduce import _postlude
from sieve_torch.parallel.mesh import run_mesh
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
# (n, rounds, which round) of the rounds path held against the plain
# versions too: the n=1e11 middle round the streaming run launches, and the
# last n=1e10 --rounds 8 round, whose padding past nbits is the widest
CHECK_ROUNDS = [(10**11, 64, "middle"), (10**10, 8, "last")]
PI = {10**8: 5_761_455, 10**9: 50_847_534, 10**10: 455_052_511,
      10**11: 4_118_054_813}
TWINS = {10**9: 3_424_506, 10**10: 27_412_679, 10**11: 224_376_048}
PACKINGS = ("plain", "odds", "wheel30")
COUNT_KINDS = ("primes", "twins", "cousins")


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
    log("build", f"fused_mark.cu (fused_mark, split_mark): nvcc "
                 f"{info['seconds']:.1f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if ("Compiling entry" in line or "registers" in line or "spill" in line
                or "smem" in line):
            log("build", "  " + line.strip())


def _segment(packing, lo, hi, limit, gap):
    seeds = seed_primes(limit if limit is not None else math.isqrt(hi - 1))
    return prepare_cuda(packing, lo, hi, seeds, pair_gap=gap)


def _kind(packing, gapname):
    if gapname == "none":
        return pairs.TWIN_NONE
    return (pairs.TWIN_KIND if gapname == "twins" else pairs.COUSIN_KIND)[packing]


def _as_u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _round_segment(n: int, rounds: int, which: str):
    """The middle or last round of ``--n n --rounds rounds`` (odds, twins),
    prepared as run_mesh prepares it: by a CudaChain at the run's common
    padded width."""
    segs = plan_segments(n, rounds)
    layout = get_layout("odds")
    W = max(-(-layout.nbits(s.lo, s.hi) // 32) for s in segs)
    wpad = -(-(W + 1) // 16384) * 16384
    s = segs[rounds // 2 if which == "middle" else rounds - 1]
    return CudaChain("odds", seed_primes(math.isqrt(n)), wpad).prepare(s.lo, s.hi)


def _check(seg, kind, device, raw: bool, chunk_words: int) -> tuple[int, int, str]:
    """Both kernels against their plain versions on one segment and kind.
    Fused: the four scalars without and with need_bits, and the need_bits
    words bit for bit. Split: the split scalars (kernel + postlude) against
    the fused ones and, with ``raw``, the raw words bit for bit (padding
    included). Returns the largest absolute difference per kernel and the
    log line's verdict."""
    plain_s, plain_w = mark_fused_reference(seg, kind, need_bits=True, device=device,
                                            chunk_words=chunk_words)
    got_s = mark_fused(seg, kind, device=device)
    got_sb, got_w = mark_fused(seg, kind, need_bits=True, device=device)
    diff = max(
        max(abs(a - b) for a, b in zip(got_s, plain_s)),
        max(abs(a - b) for a, b in zip(got_sb, plain_s)),
        int(np.abs(got_w.astype(np.int64) - plain_w.astype(np.int64)).max()),
    )
    if got_w.shape != plain_w.shape:
        diff = max(diff, 1)
    split_s = mark_cuda_split(seg, kind, device=device)
    split_diff = max(abs(a - b) for a, b in zip(split_s, got_s))
    if raw:
        raw_got = _as_u32(mark_split(seg, device=device)).astype(np.int64)
        raw_plain = _as_u32(mark_split_reference(seg, device=device,
                                                 chunk_words=chunk_words))
        split_diff = max(split_diff, 1 if raw_got.shape != raw_plain.shape else
                         int(np.abs(raw_got - raw_plain).max()))
    verdict = (f"scalars={got_s} {'exact' if diff == 0 else 'MISMATCH plain=' + str(plain_s)}"
               f" | split {'exact' if split_diff == 0 else 'MISMATCH ' + str(split_s)}")
    return diff, split_diff, verdict


def phase_kernel_vs_plain(device="cuda", segments=CHECK_SEGMENTS,
                          rounds=CHECK_ROUNDS) -> tuple[int, int, int]:
    """Each kernel against its plain version on the same tables: every
    check segment x kind, then the check rounds (twins; the plain
    versions in one chunk of Wpad words). The raw split words do not
    depend on the kind and are checked once per segment. Returns the
    largest absolute difference seen per kernel (0 when exact) and the
    number of (segment, kind) pairs."""
    worst, worst_split, failures, cases = 0, 0, [], []
    for packing, lo, hi, limit, env in segments:
        for gapname in KINDS:
            with env_set(env):
                seg = _segment(packing, lo, hi, limit, 4 if gapname == "cousins" else 2)
            cases.append((f"{packing:7s} [{lo}, {hi}) {gapname:7s}", seg,
                          _kind(packing, gapname), gapname == KINDS[0], 1 << 20))
    for n, nrounds, which in rounds:
        seg = _round_segment(n, nrounds, which)
        cases.append((f"n={n:.0e} --rounds {nrounds} {which} round, twins", seg,
                      pairs.TWIN_ADJ, True, seg.Wpad))
    for what, seg, kind, raw, chunk_words in cases:
        diff, split_diff, verdict = _check(seg, kind, device, raw, chunk_words)
        worst, worst_split = max(worst, diff), max(worst_split, split_diff)
        if diff:
            failures.append(("fused", what))
        if split_diff:
            failures.append(("split", what))
        log("kernel", f"{what} nbits={seg.nbits} tiles={seg.Wpad // 16384} "
                      f"{spec_counts(seg)} {verdict}")
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions on {failures}")
    return worst, worst_split, len(cases)


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


def _strip(res) -> tuple:
    return (res.pi, res.twin_pairs, res.n_segments,
            [dict(s.to_dict(), elapsed_s=0) for s in res.segments])


def phase_main_path(device="cuda", sizes=None) -> tuple[int, int, dict]:
    """The counting run through the CLI, at full size. Returns (launches
    counted, device segments processed, the cpu-numpy results of the small
    runs by (packing, kind))."""
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
    numpy_runs = {}
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
            b = numpy_runs[packing, kind] = run_local(
                SieveConfig(backend="cpu-numpy", **cfg))
            if _strip(a) != _strip(b):
                raise AssertionError(f"{argv}: cuda and cpu-numpy results differ")
            launches += mark_fused.launches
            expected += want
            log("main", f"  == cpu-numpy SieveResult (pi {b.pi}, pairs {b.twin_pairs})")
    return launches, expected, numpy_runs


def _check_launches(what: str, fused: int, split: int) -> None:
    got = (mark_fused.launches, mark_split.launches)
    if got != (fused, split):
        raise AssertionError(f"{what}: launches (fused, split) = {got}, "
                             f"expected {(fused, split)}")


def _log_rounds(what: str, got: dict, wall: float) -> None:
    ph = got["host_phases"]
    log("rounds", f"{what}: pi {got['pi']} pairs {got['twin_pairs']} | run "
                  f"{got['elapsed_s']:.4f} s (wall {wall:.4f} s), "
                  f"{got['values_per_sec']:.4e} values/s, device_idle_frac "
                  f"{ph['device_idle_frac']}, mode {ph['reduction_mode']} | "
                  f"prep {ph['prep_s']} s, prep_wait {ph['prep_wait_s']} s, "
                  f"stack {ph['stack_s']} s, dispatch {ph['dispatch_s']} s, "
                  f"drain {ph['drain_s']} s, rounds_prepared "
                  f"{ph['rounds_prepared']}, peak_resident "
                  f"{ph['peak_resident_rounds']}")


def _check_oracles(argv, got) -> None:
    n = int(float(argv[argv.index("--n") + 1]))
    if got["pi"] != PI[n] or got["twin_pairs"] != TWINS[n]:
        raise AssertionError(f"{argv}: pi {got['pi']}, pairs {got['twin_pairs']}; "
                             f"expected {PI[n]}, {TWINS[n]}")


def _segment_device_ms(n: int, rounds: int, fused: bool, reps: int = 5) -> float:
    """Device time of one middle segment of ``--n n --rounds rounds`` (odds,
    twins) by CUDA events: the fused kernel, or the split kernel plus its
    postlude. Times the segment count estimates the run's device busy time."""
    x = fused_inputs(_round_segment(n, rounds, "middle"), "cuda")
    kind = pairs.TWIN_ADJ
    run = (lambda: launch_fused(x, kind)) if fused else (lambda: split_reduce(x, kind))
    run()
    return statistics.median(_event_ms(run, reps))


def phase_rounds(device="cuda", sizes=None, numpy_runs=None) -> dict:
    """The rounds path (run_mesh) at full size: the README's streaming run
    in fused mode, a checkpointed split-mode run and its resume through
    the CLI, then every packing x kind x mode at n=1e8 against the numpy
    backend segment for segment. The counts are set to 0 before each run
    and read after it. Returns the launches per kernel and the two big
    runs' results."""
    sizes = sizes or {"stream": 10**11, "stream_rounds": 64, "ckpt": 10**10,
                      "ckpt_rounds": 8, "small": 10**8}
    launches = {"fused": 0, "split": 0}
    out = {}
    argv = ["--n", str(sizes["stream"]), "--packing", "odds", "--twins",
            "--rounds", str(sizes["stream_rounds"]), "--backend", "cuda",
            "--device", device]
    mark_fused.launches = mark_split.launches = 0
    got, wall = run_cli(argv)
    _check_launches(" ".join(argv), sizes["stream_rounds"], 0)
    _check_oracles(argv, got)
    launches["fused"] += mark_fused.launches
    _log_rounds("sieve_torch " + " ".join(argv[:7]), got, wall)
    out["stream"] = got
    if device == "cuda":
        seg_ms = _segment_device_ms(sizes["stream"], sizes["stream_rounds"], True)
        busy = sizes["stream_rounds"] * seg_ms / 1e3
        log("rounds", f"  device busy estimate: {sizes['stream_rounds']} x "
                      f"{seg_ms:.4f} ms (fused kernel on the middle segment, CUDA "
                      f"events) = {busy:.4f} s of the {got['elapsed_s']:.4f} s run: "
                      f"idle share {1 - busy / got['elapsed_s']:.4f}")
    with tempfile.TemporaryDirectory(prefix="sieve_ckpt_") as ck, \
            env_set({"SIEVE_PALLAS_FUSED": "0"}):
        argv = ["--n", str(sizes["ckpt"]), "--packing", "odds", "--twins",
                "--rounds", str(sizes["ckpt_rounds"]), "--checkpoint-dir", ck,
                "--backend", "cuda", "--device", device]
        mark_fused.launches = mark_split.launches = 0
        got, wall = run_cli(argv)
        _check_launches(" ".join(argv), 0, sizes["ckpt_rounds"])
        _check_oracles(argv, got)
        launches["split"] += mark_split.launches
        _log_rounds("SIEVE_PALLAS_FUSED=0 sieve_torch " + " ".join(argv[:7])
                    + " --checkpoint-dir", got, wall)
        out["ckpt"] = got
        if device == "cuda":
            seg_ms = _segment_device_ms(sizes["ckpt"], sizes["ckpt_rounds"], False)
            busy = sizes["ckpt_rounds"] * seg_ms / 1e3
            log("rounds", f"  device busy estimate: {sizes['ckpt_rounds']} x "
                          f"{seg_ms:.4f} ms (split kernel + postlude on the middle "
                          f"segment) = {busy:.4f} s of the {got['elapsed_s']:.4f} s "
                          f"run: idle share {1 - busy / got['elapsed_s']:.4f}")
        mark_fused.launches = mark_split.launches = 0
        got, wall = run_cli(argv + ["--resume"])
        _check_launches("resume", 0, 0)
        _check_oracles(argv, got)
        if got["host_phases"]["rounds_prepared"] != 0:
            raise AssertionError("the resumed run prepared rounds")
        log("rounds", f"  --resume: pi {got['pi']} pairs {got['twin_pairs']}, "
                      f"0 launches, 0 rounds prepared (wall {wall:.4f} s)")
    n = sizes["small"]
    for packing in PACKINGS:
        for kind in COUNT_KINDS:
            want = numpy_runs[packing, kind]
            for fused in ("1", "0"):
                cfg = SieveConfig(n=n, packing=packing, count_kind=kind,
                                  rounds=4, backend="cuda", device=device, quiet=True)
                with env_set({"SIEVE_PALLAS_FUSED": fused}):
                    mark_fused.launches = mark_split.launches = 0
                    res = run_mesh(cfg)
                    f, sp = mark_fused.launches, mark_split.launches
                _check_launches(f"run_mesh {packing} {kind} fused={fused}",
                                4 if fused == "1" else 0, 0 if fused == "1" else 4)
                launches["fused"] += f
                launches["split"] += sp
                if _strip(res) != _strip(want):
                    raise AssertionError(f"run_mesh n={n} {packing} {kind} "
                                         f"fused={fused} differs from cpu-numpy")
            log("rounds", f"n={n} --rounds 4 {packing:7s} {kind:8s}: fused and split "
                          f"== cpu-numpy segment for segment (pi {res.pi}, pairs "
                          f"{res.twin_pairs})")
    out["launches"] = launches
    return out


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


def _time_shapes() -> list[tuple[str, object]]:
    """The timed shapes: the n=1e9 odds segment of the counting run, and
    the n=1e11 middle round of the streaming run (the main path's own)."""
    return [("n=1e9 odds segment", _segment("odds", 2, 10**9 + 1, None, 2)),
            ("n=1e11 middle round", _round_segment(10**11, 64, "middle"))]


def phase_times(dev: dict, reps: int = 20) -> dict:
    """Per timed shape, the fused kernel without and with need_bits, then
    the split kernel and its postlude: each kernel by CUDA events (median
    over reps after a warm-up), its plain version by host clock around a
    synchronised run (one chunk of Wpad words), and its bound. Returns the
    numbers by shape, variant ("counting", "need_bits", "split")."""
    kind = pairs.TWIN_ADJ
    out = {}
    for shape, seg in _time_shapes():
        x = fused_inputs(seg, "cuda")
        res = out[shape] = {}
        for need_bits in (False, True):
            for _ in range(3):
                launch_fused(x, kind, need_bits)
            ms = _event_ms(lambda: launch_fused(x, kind, need_bits), reps)
            plain = [_host_ms(lambda: mark_fused_reference(
                seg, kind, need_bits, device="cuda", chunk_words=seg.Wpad))
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
                raise AssertionError(f"timed {shape}, need_bits={need_bits}: "
                                     "kernel and plain version differ")
            bound_ms, bound_by, work, alu_peak, popc_peak = _bound(
                seg, x, dev, pairs.PAIR_SHIFT[kind], need_bits)
            label = "need_bits" if need_bits else "counting"
            plain_ms = min(t for t, _ in plain)
            med = statistics.median(ms)
            log("times", f"{dev['card']}: {shape} ({label}), Wpad={seg.Wpad}, "
                         f"kernel median {med:.4f} ms (min {min(ms):.4f}, "
                         f"max {max(ms):.4f}, {reps} runs), plain version {plain_ms:.1f} ms, "
                         f"bound {bound_ms:.4f} ms by {bound_by} ({med / bound_ms:.1f}x)")
            res[label] = {"ms": med, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
        log("times", f"{shape} bound: {work['words']} words, {spec_counts(seg)}; "
                     f"group A {work['A_ops']} pattern ANDs, hits {work['hits']}; "
                     f"{work['alu']:.4e} 32-bit ALU ops over {alu_peak:.4e} ops/s "
                     f"({dev['sms']} SMs x {INT32_LANES_PER_SM} lanes x "
                     f"{dev['max_sm_mhz']:.0f} MHz max SM clock), {work['popc']:.4e} "
                     f"popcounts over {popc_peak:.4e} /s ({POPC_LANES_PER_SM} lanes); "
                     f"against bytes over {HBM_BYTES_PER_S:.3e} B/s")
        res["split"] = _split_times(shape, seg, dev, reps)
    log("times", "library: no single PyTorch call computes either function")
    return out


def _split_bound(seg, x, dev: dict) -> tuple[float, str, dict]:
    """Least time for the split kernel's function on this segment: the raw
    words of all 32*Wpad bits (padding included), i.e. one pattern AND per
    (word, live group-A spec) and one clear per hit of groups B-D below
    32*Wpad, against the group tables read once and Wpad words written."""
    bits = 32 * seg.Wpad
    c = spec_counts(seg)
    hits = {g: _hits(t, bits) for g, t in (("B", seg.B), ("C", seg.C), ("D", seg.D))}
    alu = seg.Wpad * c["A"] + sum(hits.values())
    t_ops = alu / (dev["sms"] * INT32_LANES_PER_SM * dev["max_sm_mhz"] * 1e6)
    nbytes = 4 * (sum(x.spans[name][1] for name, _ in _SPLIT_ARRAYS) + seg.Wpad)
    t_bytes = nbytes / HBM_BYTES_PER_S
    work = {"alu": alu, "hits": hits, "bytes": nbytes}
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations", work
    return t_bytes * 1e3, "bytes", work


def _split_times(shape: str, seg, dev: dict, reps: int) -> dict:
    """The split kernel and its postlude on the same segment, each by CUDA
    events (median over reps after a warm-up); the split kernel's plain
    version by host clock; the split scalars against the fused ones."""
    kind = pairs.TWIN_ADJ
    x = fused_inputs(seg, "cuda")
    for _ in range(3):
        words = launch_split(x)
    ms = _event_ms(lambda: launch_split(x), reps)
    plain = [_host_ms(lambda: mark_split_reference(seg, device="cuda",
                                                   chunk_words=seg.Wpad))
             for _ in range(2)]
    if not torch.equal(launch_split(x), plain[0][1]):
        raise AssertionError(f"timed {shape}: split kernel and plain version differ")
    lists = tuple(x.part(n).to(torch.int64) for n in
                  ("corr_idx", "corr_mask", "flat_idx", "flat_mask"))
    ci, cm, fi, fm = lists[0], lists[1] & 0xFFFFFFFF, lists[2], lists[3] & 0xFFFFFFFF
    post = lambda: _postlude(words, x.nbits, x.pair_mask, ci, cm, kind, fi, fm)
    for _ in range(3):
        post()
    post_ms = _event_ms(post, reps)
    got = tuple(int(v) & 0xFFFFFFFF for v in post())
    want = mark_fused(seg, kind, device="cuda")
    if got != want:
        raise AssertionError(f"timed {shape}: split {got} != fused {want}")
    bound_ms, bound_by, work = _split_bound(seg, x, dev)
    med, post_med = statistics.median(ms), statistics.median(post_ms)
    plain_ms = min(t for t, _ in plain)
    post_bytes = 8 * seg.Wpad  # the postlude reads the words once
    log("times", f"{dev['card']}: {shape}, split kernel median "
                 f"{med:.4f} ms (min {min(ms):.4f}, max {max(ms):.4f}, {reps} runs), "
                 f"plain version {plain_ms:.1f} ms, bound {bound_ms:.4f} ms by "
                 f"{bound_by} ({med / bound_ms:.1f}x): {work['alu']:.4e} ALU ops, "
                 f"hits {work['hits']}, {work['bytes']} bytes")
    log("times", f"{dev['card']}: {shape}, postlude (torch ops, "
                 f"twins) median {post_med:.4f} ms (min {min(post_ms):.4f}, max "
                 f"{max(post_ms):.4f}, {reps} runs); reading its {post_bytes} "
                 f"bytes of int64 words once takes "
                 f"{post_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms; split total "
                 f"{med + post_med:.4f} ms")
    return {"ms": med, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "postlude_ms": post_med}


# spec groups of the tables; a variant of the inputs with only some live
GROUPS = ("a", "b", "c", "d")
GROUP_CONFIGS = ("all", "a", "b", "c", "d", "none")


def _only(x, config: str):
    """A copy of the kernel inputs with the act columns of every group but
    ``config`` ("all": none, "none": every one) set to 0, so the kernels
    skip those specs; the flat clears and corrections stay."""
    if config == "all":
        return x
    buf = x.buf.clone()
    for g in GROUPS:
        if g != config:
            off, n = x.spans[f"{g}_act"]
            buf[off : off + n] = 0
    return dataclasses.replace(x, buf=buf)


@contextlib.contextmanager
def _library(lib):
    """Route the wrappers' launches to ``lib``, another build of the
    kernels behind the same C interface."""
    old = build._lib
    build._lib = lib
    try:
        yield
    finally:
        build._lib = old


def phase_groups(dev: dict, others: dict | None = None, reps: int = 10) -> dict:
    """Per timed shape and kernel (fused counting and split, each whole and
    with one group live at a time; fused need_bits whole), the median by
    CUDA events of this checkout's kernel and of each of ``others`` (label
    -> a library built from another checkout), in turns: others, this,
    this, others reversed, each turn after a warm-up. Each group's time is
    the kernel's with only that group's specs live ("none": the fixed work
    of the launch). Every other kernel's result must equal this one's.
    Returns the medians by (shape, variant, config, label)."""
    kind = pairs.TWIN_ADJ
    others = others or {}
    order = (list(others.items()) + [("this", build.load())] * 2
             + list(reversed(others.items())))
    variants = (("fused", lambda x: launch_fused(x, kind), GROUP_CONFIGS),
                ("need_bits", lambda x: launch_fused(x, kind, True), ("all",)),
                ("split", launch_split, GROUP_CONFIGS))
    out = {}
    for shape, seg in _time_shapes():
        x0 = fused_inputs(seg, "cuda")
        for variant, fn, configs in variants:
            for config in configs:
                x = _only(x0, config)
                samples = {label: [] for label, _ in order}
                results = {}
                for label, lib in order:
                    with _library(lib):
                        for _ in range(2):
                            fn(x)
                        samples[label] += _event_ms(lambda: fn(x), reps)
                        r = fn(x)
                        results[label] = _as_u32(r[0] if variant != "split" else r)
                for label in others:
                    if not np.array_equal(results[label], results["this"]):
                        raise AssertionError(f"{shape} {variant} {config}: this "
                                             f"kernel and {label}'s differ")
                med = {label: statistics.median(v) for label, v in samples.items()}
                out.update({(shape, variant, config, label): v for label, v in med.items()})
                line = (f"{dev['card']}: {shape} {variant:9s} live {config:4s}: "
                        f"this {med['this']:.4f} ms ({len(samples['this'])} runs)")
                for label in others:
                    v = samples[label]
                    line += (f"; {label} {med[label]:.4f} ms ({len(v)} runs, halves "
                             f"{statistics.median(v[:reps]):.4f} "
                             f"{statistics.median(v[reps:]):.4f}), "
                             f"{med[label] / med['this']:.2f}x this")
                log("groups", line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="a checkout of another commit, or a variant of these "
                         "sources, whose kernels are timed in turns with these "
                         "in the group phase (repeatable)")
    args = ap.parse_args(argv)
    dev = phase_device()
    t0 = time.perf_counter()
    t_start = t0
    phase_build()
    others = {}
    for root in args.other:
        src = root / "sieve_torch" / "kernels" / "csrc" / "fused_mark.cu"
        info = build.build(force=True, source=src.resolve())
        others[root.resolve().name] = build.bind(info["path"])
        log("build", f"{root.resolve().name}: {src}: nvcc {info['seconds']:.1f} s")
    log("build", f"done in {time.perf_counter() - t0:.1f} s")
    worst, worst_split, n_checked = phase_kernel_vs_plain()
    log("kernel", f"bit-exact on {n_checked} (segment, kind) pairs, max abs err "
                  f"fused {worst}, split {worst_split} (tolerance 0: the "
                  "arithmetic is integer)")
    launches, expected, numpy_runs = phase_main_path()
    log("launches", f"mark_fused launched {launches} times for {expected} "
                    "device segments over the counting runs")
    rounds = phase_rounds(numpy_runs=numpy_runs)
    log("launches", f"rounds path: mark_fused {rounds['launches']['fused']}, "
                    f"mark_split {rounds['launches']['split']} launches, one per "
                    "device segment of each mode")
    times = phase_times(dev)["n=1e9 odds segment"]
    phase_groups(dev, others)
    log("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "fused_mark",
        "route": "cuda",
        "source": "sieve_torch/kernels/csrc/fused_mark.cu",
        "replaces": "sieve/kernels/pallas_mark.py:694",
        "launches": launches + rounds["launches"]["fused"],
        "max_abs_err": worst,
        "ms": times["counting"]["ms"],
        "plain_ms": times["counting"]["plain_ms"],
        "bound_ms": times["counting"]["bound_ms"],
        "bound_by": times["counting"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "split_mark",
        "route": "cuda",
        "source": "sieve_torch/kernels/csrc/fused_mark.cu",
        "replaces": "sieve/kernels/pallas_mark.py:609",
        "launches": rounds["launches"]["split"],
        "max_abs_err": worst_split,
        "ms": times["split"]["ms"],
        "plain_ms": times["split"]["plain_ms"],
        "bound_ms": times["split"]["bound_ms"],
        "bound_by": times["split"]["bound_by"],
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
