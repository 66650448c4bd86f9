#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--other DIR ...]

Builds the port's CUDA kernels (fused and split marking) from the sources
in this checkout, holds each bit for bit against its plain PyTorch version
on the card, drives the port's counting run and its rounds path (the
n=1e11 streaming run, a split-mode checkpointed run and its resume) through
their entry points at full size, checks that every device segment went
through the kernel of its mode, and times the kernels and the split
postlude, whole and with one spec group live at a time. Phase ``words``
does the same for the torch backend's word kernel (torch ops, not a hand
kernel): against the cuda backend and, up to n=2.4e7, its own CPU run,
the n=1e8 counting run, the rounds path with a checkpoint and its resume, batched against
sequential calls (one device, then every card), and its times beside the
fused kernel's. Phase ``cluster`` runs the cpu-cluster transport with two
worker processes on the card (checkpointed, resumed, a worker killed)
and on cpu-native workers; phase ``multihost`` runs ``--multihost`` ranks
as processes of this script (``chip_smoke.py --cli <CLI arguments>``):
two gloo ranks sharing the card and their resume, and one NCCL rank.
Phase ``service`` serves a ledger the card wrote through the port's data
plane: the read-only ledger, the tiered store seeded from it, the
segment index (prefix counts, nth, a batch) with chunks demoted into the
store and read back from a second handle, and ``--emit-primes``. Phase
``serve`` runs the query server with its cold plane on the card: a
cold-only in-process server on the cuda backend under a concurrent burst
of every query op (its fused launches == its cold chunks less those
answered on the host), the mesh cold plane on the word kernel, and
``python3 -m sieve_torch serve`` as a process over a ledger the card
wrote, queried hot and cold and shut down over the wire.
Phase ``fabric`` runs the serving fabric over ledgers the card wrote,
split in half at a segment boundary E: shard 0 and two shard-1 replicas
behind one router in this process, under a concurrent burst across E held
against exact oracles, and a cold window past the map on shard 1's fused
kernel (shard 0 launches nothing); a failure drill (a replica stopped
mid-burst, the whole shard down, a restart, an injected
``svc_shard_down``); a FleetObserver with scrape gaps; and ``serve`` x2,
``route`` and ``observe`` as processes, with the fleet tools (``fleet_top
--json``, ``fleet_top --once``, ``fleet_debug``) run against the live
router.
Phase ``profile`` drives the measurement plane: four runs through the CLI
with ``--profile-dir`` (n=1e10 in 5 segments, the n=1e11 ``--rounds 64``
run, the split kernel under SIEVE_PALLAS_FUSED=0, the torch backend),
each exact, whose torch.profiler traces must hold as many kernel events
of each kernel as its wrapper counted launches; then every tool of
sieve_torch/tools on the card (profile_kernel also as a ``python -m``
process, the depth regime among them), each exiting 0; and the depth
segment [10^12 - 10^9, 10^12 + 1), which phase ``kernel`` holds bit for
bit against the plain versions, against pi(10^12) - pi(10^12 - 10^9 - 1).
Phase ``gates`` runs the concurrency and discipline gates on the card:
``sieve_torch.tools.check_all --device cuda`` in this process (the static
analyzer, the env-var and event-schema checks, and the wire check, whose
live ledger is sieved with one fused launch per segment), then the
service, chaos and store smokes as ``python -m`` processes under
SIEVE_LOCK_DEBUG=1, each exiting 0 with its banner and observed lock
orders consistent with the canonical order; the service smoke's cold
plane and the chaos smoke's cluster workers launch the fused kernel.
Phase ``fleet`` runs the shard, observe, profile and failover smokes as
``python -m`` processes with ``--device cuda`` (their ``serve`` children
on ``--backend cuda``; each exits 0 with its banner and its fused
launches, the children's read over the ``metrics`` op), then the
autotuner's sweep of the fused kernel's knobs into a tuned file of its
own and a fresh exact n=1e10 run that loads it, then ``python -m
sieve_torch.graft_entry`` (the word kernel's entry and the one-shard dry
run with its checks). The tuned run is a CLI process of this script
(``chip_smoke.py --cli <CLI arguments>``), which reports its own kernel
launches.
Phase ``bench`` runs ``python -m sieve_torch.bench`` on the card in a
process of this script (``chip_smoke.py --bench``), which reports its own
kernel launches: every parity assert of the bench, its 18 metric lines
each once, its launches exactly as counted from its code, and the lines
through the port's ``bench_compare``, whose absolute budgets are printed.
Each ``--other DIR`` names a checkout of another commit
(the parent, unpacked with ``git archive``) or a variant of these
sources, whose kernels are built too and timed in turns with these in
the group phase (others, this, this, others reversed), labelled by the
directory's name. Each phase prints its lines; any failure raises, so the
script exits non-zero and prints no result. The last three lines are the
kernel table (JSON), the card's name and power limit, and the result
line:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

The words, cluster, multihost, service, serve, fabric, profile, gates,
fleet and bench phases print their summaries as ``[words] {...}``,
``[cluster] {...}``, ``[multihost] {...}``, ``[service] {...}``, ``[serve]
{...}``, ``[fabric] {...}``, ``[profile] {...}``, ``[gates] {...}``,
``[fleet] {...}`` and ``[bench] {...}`` lines before those three. Exits
non-zero when torch sees no CUDA device, and when run outside a checkout
of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import io
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from sieve_torch import metrics, trace
from sieve_torch.backends.cuda import CudaWorker
from sieve_torch.backends.mesh_backend import MeshWorker
from sieve_torch.backends.torch_words import TorchWorker
from sieve_torch.bitset import get_layout
from sieve_torch.cli import main as sieve_torch_main
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.kernels import build, pairs, word_mark
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
from sieve_torch.kernels.specs import MAX_WORDS, prepare_tiered
from sieve_torch.parallel.mesh import run_mesh
from sieve_torch.segments import plan_segments
from sieve_torch.seed import seed_primes

HBM_BYTES_PER_S = 3.35e12        # H100 SXM published device memory rate
INT32_LANES_PER_SM = 64          # Hopper: 32-bit add, shift, logic per SM per clock
POPC_LANES_PER_SM = 16           # Hopper: population counts per SM per clock
SPIN_CYCLES = 2_000_000          # ~1 ms at the H100's clock
KINDS = ("none", "twins", "cousins")
# the depth segment [10^12 - 10^9, 10^12 + 1) and pi(10^12), the published
# value (an oracle independent of every marking path)
DEPTH_LO, DEPTH_HI = 10**12 - 10**9, 10**12 + 1
PI_1E12 = 37_607_912_018
# the plain versions launch one slice assignment per live spec per chunk
# of words: a check segment whose chunks would need more runs as one chunk
PLAIN_LAUNCHES = 300_000
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
    # the depth regime: the full 78,498-seed set, 609 group-D rows
    ("odds", DEPTH_LO, DEPTH_HI, None, {}),
]
# (n, rounds, which round) of the rounds path held against the plain
# versions too: the n=1e11 middle round the streaming run launches, and the
# last n=1e10 --rounds 8 round, whose padding past nbits is the widest
CHECK_ROUNDS = [(10**11, 64, "middle"), (10**10, 8, "last")]
PI = {10**8: 5_761_455, 10**9: 50_847_534, 10**10: 455_052_511,
      10**11: 4_118_054_813}
TWINS = {10**8: 440_312, 10**9: 3_424_506, 10**10: 27_412_679, 10**11: 224_376_048}
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
    """Set (a value) or unset (None) variables for the block."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
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


def _chunk_words(seg) -> int:
    """Words per chunk of a check segment's plain versions: 2^20, or the
    whole segment where 2^20-word chunks would take the plain version past
    PLAIN_LAUNCHES slice assignments (the depth segment: 78,497 specs)."""
    c = spec_counts(seg)
    specs = c["A"] + c["B"] + c["C"] + c["D"]
    chunks = -(-seg.Wpad // (1 << 20))
    return 1 << 20 if chunks * specs <= PLAIN_LAUNCHES else seg.Wpad


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
                          _kind(packing, gapname), gapname == KINDS[0],
                          _chunk_words(seg)))
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
    """``python -m sieve_torch <argv> --json --quiet`` in this process (so
    the launch counter sees it); returns the result object and the wall
    time."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = sieve_torch_main(argv + ["--json", "--quiet"])
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
                  f"{ph['device_idle_frac']}, mode {ph.get('reduction_mode', 'words')} | "
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
    """The timed shapes: the n=1e9 odds segment of the counting run, the
    n=1e11 middle round of the streaming run (the main path's own), and
    the depth segment below 10^12 (every seed below 10^6 live)."""
    return [("n=1e9 odds segment", _segment("odds", 2, 10**9 + 1, None, 2)),
            ("n=1e11 middle round", _round_segment(10**11, 64, "middle")),
            ("depth segment", _segment("odds", DEPTH_LO, DEPTH_HI, None, 2))]


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
    post_pass, post_ops = _pass_bytes(post)
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
                 f"{post_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms, and the "
                 f"{post_pass:.4e} bytes its {post_ops} ops move "
                 f"{post_pass / HBM_BYTES_PER_S * 1e3:.4f} ms; split total "
                 f"{med + post_med:.4f} ms")
    return {"ms": med, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "postlude_ms": post_med,
            "postlude_pass_bytes": post_pass}


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


def _is_view(func) -> bool:
    """Whether an aten op returns a view of an input (moves no bytes)."""
    view = getattr(func, "is_view", None)
    if view is None:
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
    return bool(view)


class _PassBytes(TorchDispatchMode):
    """Counts the bytes that the torch ops run under it move on one device:
    each op's tensor arguments read once and its outputs written once
    (views move nothing; host tensors are left out)."""

    def __init__(self, device: str):
        super().__init__()
        self.device = torch.device(device).type
        self.bytes = 0
        self.ops = 0

    def _sum(self, tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
                   if isinstance(t, torch.Tensor) and t.device.type == self.device)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _is_view(func):
            self.bytes += self._sum((args, kwargs)) + self._sum(out)
            self.ops += 1
        return out


def _pass_bytes(fn, device="cuda") -> tuple[int, int]:
    """(bytes, ops) of the passes one call of ``fn`` makes on ``device``."""
    with _PassBytes(device) as m:
        fn()
    return m.bytes, m.ops


def _fields(res) -> dict:
    return dict(res.to_dict(), elapsed_s=0)


def _tiered(packing, lo, hi, limit, gap):
    seeds = seed_primes(limit if limit is not None else math.isqrt(hi - 1))
    return prepare_tiered(packing, lo, hi, seeds, word_mark.TIER1_MAX,
                          word_mark.SPEC_BLOCK, word_mark.WORD_BUCKET, pair_gap=gap)


def _call_words(ts, kind, device, marked=None):
    """mark_words on one TieredSegment; given ``marked`` (its marked words,
    computed once), only the tail runs."""
    if marked is not None:
        return word_mark.pack4(*word_mark._tail(
            marked, ts.nbits, kind, ts.pair_mask, ts.corr_idx, ts.corr_mask,
            device))
    return word_mark.mark_words(
        ts.Wpad, kind, ts.periods, ts.nbits, ts.patterns, ts.m2, ts.r2, ts.K2,
        ts.rcp2, ts.act2, ts.corr_idx, ts.corr_mask, ts.pair_mask, device=device)


# the word kernel's check segments: those up to n=1e8 (the n=1e9-value
# segment, ~20 s of torch ops for its three kinds, and the depth segment
# stay with the hand kernels' phase, within the script's time limit)
WORD_CHECK_SEGMENTS = [s for s in CHECK_SEGMENTS if s[2] - s[1] <= 10**8 + 1]
# the segments whose word marking the CPU repeats: those up to n=2.4e7;
# the three n=1e8 segments would take ~55 s of CPU torch ops, beyond the
# script's time limit (on them the torch backend is still held against
# the cuda one, which phase kernel holds against the plain versions)
CPU_WORDS_MAX_HI = 24_000_001


def _words_vs_cuda(device="cuda", segments=WORD_CHECK_SEGMENTS) -> int:
    """(a) On every check segment whose words fit the word kernel, for each
    kind: the torch backend equal to the cuda backend field for field; for
    the segments up to CPU_WORDS_MAX_HI also mark_words on the card equal
    to the same function on the CPU (marked once, then each kind's tail).
    Returns the number of (segment, kind) pairs held."""
    cases = 0
    for packing, lo, hi, limit, env in segments:
        nbits = get_layout(packing).nbits(lo, hi)
        wpad = -(-(-(-nbits // 32) + 1) // word_mark.WORD_BUCKET) * word_mark.WORD_BUCKET
        if wpad > MAX_WORDS:
            log("words", f"{packing} [{lo}, {hi}): {wpad} words > MAX_WORDS, skipped")
            continue
        seeds = seed_primes(limit if limit is not None else math.isqrt(hi - 1))
        cpu_words = None
        if hi <= CPU_WORDS_MAX_HI:
            ts = _tiered(packing, lo, hi, limit, 2)
            cpu_words = word_mark._marked_words(
                ts.Wpad, ts.periods, tuple(p[None] for p in ts.patterns),
                ts.m2[None], ts.r2[None], ts.act2[None], "cpu")[0]
        t0 = time.perf_counter()
        for gapname, count_kind in zip(KINDS, COUNT_KINDS):
            cfg = SieveConfig(n=hi - 1, backend="torch", device=device,
                              packing=packing, count_kind=count_kind, quiet=True)
            with env_set(env):
                got = TorchWorker(cfg).process_segment(lo, hi, seeds, seg_id=1)
                want = CudaWorker(dataclasses.replace(cfg, backend="cuda")
                                  ).process_segment(lo, hi, seeds, seg_id=1)
            if _fields(got) != _fields(want):
                raise AssertionError(f"torch {_fields(got)} != cuda {_fields(want)} "
                                     f"on {packing} [{lo}, {hi}) {gapname}")
            verdict = "== cuda backend"
            if cpu_words is not None:
                ts = _tiered(packing, lo, hi, limit, 4 if gapname == "cousins" else 2)
                kind = _kind(packing, gapname)
                card = _call_words(ts, kind, device).cpu().tolist()
                cpu = _call_words(ts, kind, "cpu", cpu_words).tolist()
                if card != cpu:
                    raise AssertionError(f"mark_words on the card {card} != on the "
                                         f"CPU {cpu}: {packing} [{lo}, {hi}) {gapname}")
                verdict += ", == the CPU"
            cases += 1
            log("words", f"{packing:7s} [{lo}, {hi}) {gapname:7s} nbits={nbits}: "
                         f"count {got.count} pairs {got.twin_count} {verdict}")
        log("words", f"  {time.perf_counter() - t0:.2f} s for the three kinds")
    return cases


def _check_calls(what: str, single: int, batch: int = 0) -> None:
    got = (word_mark.mark_words.cuda_calls, word_mark.mark_words_batch.cuda_calls)
    if got != (single, batch):
        raise AssertionError(f"{what}: word-kernel calls on the card (single, batch) "
                             f"= {got}, expected {(single, batch)}")


def _reset_calls() -> None:
    word_mark.mark_words.cuda_calls = word_mark.mark_words_batch.cuda_calls = 0


def _words_main(device, sizes, numpy_runs) -> int:
    """(b) The counting run at full size through the CLI, then n=1e8 per
    packing x kind against cpu-numpy. Returns the calls on the card."""
    calls = 0
    n = sizes["mid"]
    argv = ["--n", str(n), "--backend", "torch", "--twins", "--device", device]
    _reset_calls()
    got, wall = run_cli(argv)
    want = _device_segments(n, "odds", 1)
    _check_calls(" ".join(argv), want if device == "cuda" else 0)
    _check_oracles(argv, got)
    calls += word_mark.mark_words.cuda_calls
    ph = got["host_phases"] or {}
    log("words", f"sieve_torch {' '.join(argv[:5])}: pi {got['pi']} pairs "
                 f"{got['twin_pairs']} | run {got['elapsed_s']:.4f} s, "
                 f"{got['values_per_sec']:.4e} values/s (wall {wall:.4f} s) | prep "
                 f"{ph.get('prep_s')} s | word-kernel calls on the card "
                 f"{word_mark.mark_words.cuda_calls}/{want}")
    small = sizes["small"]
    for packing in PACKINGS:
        for kind in COUNT_KINDS:
            _reset_calls()
            res = run_local(SieveConfig(n=small, packing=packing, n_segments=4,
                                        count_kind=kind, backend="torch",
                                        device=device, quiet=True))
            want = _device_segments(small, packing, 4)
            _check_calls(f"n={small} {packing} {kind}", want if device == "cuda" else 0)
            calls += word_mark.mark_words.cuda_calls
            if _strip(res) != _strip(numpy_runs[packing, kind]):
                raise AssertionError(f"torch n={small} {packing} {kind} differs "
                                     "from cpu-numpy")
        log("words", f"n={small} {packing:7s} x {COUNT_KINDS}, 4 segments: "
                     "== cpu-numpy segment for segment")
    return calls


def _words_rounds(device, sizes) -> int:
    """(c) The rounds path on the word kernel: --rounds 4 against the
    oracle, then --rounds 8 with a checkpoint dir and its resume, which
    runs nothing. Returns the calls on the card."""
    n = sizes["mid"]
    on_card = device == "cuda"
    calls = 0
    argv = ["--n", str(n), "--backend", "torch", "--rounds", "4", "--twins",
            "--device", device]
    _reset_calls()
    got, wall = run_cli(argv)
    _check_calls(" ".join(argv), 4 if on_card else 0)
    _check_oracles(argv, got)
    calls += word_mark.mark_words.cuda_calls
    _log_rounds("words: sieve_torch " + " ".join(argv[:7]), got, wall)
    with tempfile.TemporaryDirectory(prefix="sieve_ckpt_") as ck:
        argv = ["--n", str(n), "--backend", "torch", "--rounds", "8", "--twins",
                "--checkpoint-dir", ck, "--device", device]
        _reset_calls()
        got, wall = run_cli(argv)
        _check_calls(" ".join(argv), 8 if on_card else 0)
        _check_oracles(argv, got)
        calls += word_mark.mark_words.cuda_calls
        _log_rounds("words: sieve_torch " + " ".join(argv[:7]) + " --checkpoint-dir",
                    got, wall)
        _reset_calls()
        got, wall = run_cli(argv + ["--resume"])
        _check_calls("resume", 0)
        _check_oracles(argv, got)
        if got["host_phases"]["rounds_prepared"] != 0:
            raise AssertionError("the resumed run prepared rounds")
        log("rounds", f"  words --resume: pi {got['pi']} pairs {got['twin_pairs']}, "
                      f"0 calls, 0 rounds prepared (wall {wall:.4f} s)")
    return calls


def _words_batched(device="cuda", base=10**9, span=10**6, count=16) -> int:
    """(d) process_segments on equal chunks above ``base`` (one shape
    group) against process_segment, on the torch worker and on MeshWorker
    over every card torch sees. Returns the batched calls on the card."""
    segs = [(base + i * span, base + (i + 1) * span) for i in range(count)]
    seeds = seed_primes(math.isqrt(segs[-1][1] - 1))
    cfg = SieveConfig(n=segs[-1][1] - 1, backend="torch", device=device, twins=True,
                      quiet=True)
    w = TorchWorker(cfg)
    sids = list(range(100, 100 + count))
    seq = [_fields(w.process_segment(lo, hi, seeds, sid))
           for (lo, hi), sid in zip(segs, sids)]
    on_card = device == "cuda"
    _reset_calls()
    t0 = time.perf_counter()
    got = [_fields(r) for r in w.process_segments(segs, seeds, seg_ids=sids)]
    t_batch = time.perf_counter() - t0
    _check_calls("TorchWorker.process_segments", 0, 1 if on_card else 0)
    if got != seq:
        raise AssertionError("batched process_segments differs from sequential")
    mesh = MeshWorker(cfg)
    _reset_calls()
    got = [_fields(r) for r in mesh.process_segments(segs, seeds, seg_ids=sids)]
    if mesh.launches != 1:
        raise AssertionError(f"MeshWorker: {mesh.launches} launches for 1 group")
    _check_calls("MeshWorker.process_segments", 0, mesh.devices if on_card else 0)
    if got != seq:
        raise AssertionError("MeshWorker process_segments differs from sequential")
    log("words", f"{count} chunks of {span} values above {base}: one group; "
                 f"batched == sequential (one call, {t_batch:.4f} s wall); "
                 f"MeshWorker over {mesh.devices} card(s) == sequential, "
                 f"launches {mesh.launches}")
    return 1 + mesh.devices


def _words_times(dev: dict) -> dict:
    """(f) mark_words and the fused kernel on the same segments by CUDA
    events (medians after a warm-up), mark_words by host clock around a
    synchronised call too, and the bytes its passes move against the
    memory rate. The two results must agree."""
    out = {}
    kind = pairs.TWIN_ADJ
    for shape, hi, reps in (("n=1e9 odds segment", 10**9 + 1, 5),
                            ("n=1e8 odds segment", 10**8 + 1, 10)):
        ts = _tiered("odds", 2, hi, None, 2)
        run = lambda: _call_words(ts, kind, "cuda")
        want = run().cpu().tolist()
        ms = _event_ms(run, reps)
        host = min(_host_ms(run)[0] for _ in range(2))
        nbytes, nops = _pass_bytes(run)
        x = fused_inputs(_segment("odds", 2, hi, None, 2), "cuda")
        for _ in range(3):
            launch_fused(x, kind)
        fused_ms = statistics.median(_event_ms(lambda: launch_fused(x, kind), 20))
        fused = [int(v) for v in launch_fused(x, kind)[0].cpu().numpy().view(np.uint32)]
        if fused != want:
            raise AssertionError(f"{shape}: mark_words {want} != fused {fused}")
        med = statistics.median(ms)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        live = int((ts.act2 != 0).sum())
        log("words", f"{dev['card']}: {shape}, Wpad={ts.Wpad}, {len(ts.periods)} "
                     f"tier-1 periods, {live} live tier-2 specs: mark_words median "
                     f"{med:.4f} ms (min {min(ms):.4f}, max {max(ms):.4f}, {reps} runs; "
                     f"host clock {host:.4f} ms); its {nops} ops move {nbytes:.4e} "
                     f"bytes = {bound:.4f} ms at {HBM_BYTES_PER_S:.3e} B/s "
                     f"({med / bound:.2f}x); fused kernel median {fused_ms:.4f} ms "
                     f"({med / fused_ms:.1f}x faster than mark_words); both {want}")
        out[shape] = {"ms": med, "host_ms": host, "pass_bytes": nbytes, "ops": nops,
                      "bound_ms": bound, "fused_ms": fused_ms}
    return out


def phase_words(dev: dict | None, numpy_runs: dict, device="cuda",
                sizes=None, segments=WORD_CHECK_SEGMENTS) -> dict:
    """The torch backend's word path on the card, (a)-(f); see the
    helpers. With ``dev`` None the times are not taken (a CPU rehearsal)."""
    # the CLI runs at n=1e8, within the script's time limit; the n=1e9
    # segment is still timed, and its pass bytes counted, in (f)
    sizes = sizes or {"mid": 10**8, "small": 10**8, "batch_base": 10**9}
    steps = {"checked": lambda: _words_vs_cuda(device, segments),
             "main_calls": lambda: _words_main(device, sizes, numpy_runs),
             "rounds_calls": lambda: _words_rounds(device, sizes),
             "batched_calls": lambda: _words_batched(device, sizes["batch_base"])}
    if dev is not None:
        steps["times"] = lambda: _words_times(dev)
    out, seconds = {}, {}
    for name, step in steps.items():
        t0 = time.perf_counter()
        out[name] = step()
        seconds[name] = time.perf_counter() - t0
    log("words", "seconds per step: " + ", ".join(f"{k} {v:.1f}"
                                                  for k, v in seconds.items()))
    return out

# --- the distributed planes ---------------------------------------------------

# the heartbeat run: 2 segments of 5e8 values, ~2 s each on a torch worker,
# so heartbeats (1 s) must arrive while one runs
CLUSTER_SIZES = {"n": 10**10, "segments": 16, "workers": 2, "hb_n": 10**9,
                 "hb_segments": 2, "cpu_n": 10**9, "cpu_workers": 4}
MULTIHOST_SIZES = {"n": 10**10, "rounds": 8, "nccl_n": 10**11, "nccl_rounds": 64}
RANK_WAIT_S = 300


def _launch_gauge(wid: int, counter: str = "kernel.mark_fused.launches") -> str:
    """The coordinator's gauge of a worker's shipped registry counter."""
    return f"cluster.worker{wid}.{counter}"


def _ledger_fields(ckpt: str) -> list[dict]:
    data = json.loads((Path(ckpt) / "sieve_ledger.json").read_text())
    return [dict(v, elapsed_s=0) for _, v in
            sorted(data["completed"].items(), key=lambda kv: int(kv[0]))]


def _cluster_run(what: str, argv: list[str], env: dict, workers: int, on_card: bool,
                 counters: tuple[str, ...] = ("kernel.mark_fused.launches",)) -> dict:
    """One cpu-cluster run through the CLI, the workers' launches of the
    device code (the sum of ``counters``) read from their shipped
    registries (each set to 0 just before), the assign->done round trips,
    the heartbeats and the per-worker segment times."""
    reg = metrics.registry()
    for wid in range(workers):
        for name in (*(_launch_gauge(wid, c) for c in counters),
                     f"cluster.worker{wid}.worker.segment_ms.count",
                     f"cluster.worker{wid}.worker.segment_ms.mean"):
            reg.gauge(name).set(0)
    beats = reg.counter("cluster.heartbeats").value
    sink = metrics.MemorySink()
    metrics.add_sink(sink)
    snap = trace.snapshot()
    t_start = trace.now_s()
    mark_fused.launches = mark_split.launches = 0
    try:
        with env_set(env):
            got, wall = run_cli(argv)
    finally:
        metrics.remove_sink(sink)
    joins = [r["ts"] - t_start for r in sink.records if r["event"] == "worker_joined"]
    _check_launches(f"{what}: the coordinator itself", 0, 0)
    agg = trace.since(snap)
    snapshot = reg.snapshot()
    per_worker = {}
    for wid in range(workers):
        base = f"cluster.worker{wid}.worker.segment_ms"
        per_worker[wid] = {
            "segments": snapshot[f"{base}.count"]["value"],
            "segment_ms": snapshot[f"{base}.mean"]["value"],
            "launches": sum(snapshot[_launch_gauge(wid, c)]["value"]
                            for c in counters),
        }
    rpc_s, rpc_n = agg.get("rpc.assign", (0.0, 0))
    ph = got["host_phases"]
    out = {"pi": got["pi"], "twin_pairs": got["twin_pairs"],
           "run_s": got["elapsed_s"], "values_per_s": got["values_per_sec"],
           "wall_s": wall, "assigns": rpc_n,
           "heartbeats": reg.counter("cluster.heartbeats").value - beats,
           "first_join_s": min(joins, default=None),
           "last_join_s": max(joins, default=None),
           "rpc_ms": rpc_s / rpc_n * 1e3 if rpc_n else None,
           "workers": per_worker, "host_phases": ph,
           "launches": sum(w["launches"] for w in per_worker.values()) if on_card else 0,
           "worker_failed": sum(r["event"] == "worker_failed" for r in sink.records),
           "reassigned": sum(r["event"] == "reassign" for r in sink.records)}
    log("cluster", f"{what}: pi {got['pi']} pairs {got['twin_pairs']} | run "
                   f"{got['elapsed_s']:.4f} s (wall {wall:.4f} s), "
                   f"{got['values_per_sec']:.4e} values/s | workers joined "
                   f"{out['first_join_s'] or 0:.3f}-{out['last_join_s'] or 0:.3f} s "
                   f"after the start | {rpc_n} assigns, "
                   f"assign->done {out['rpc_ms'] or 0:.3f} ms mean, "
                   f"{out['heartbeats']} heartbeats | workers "
                   f"{per_worker} | telemetry_workers {ph['telemetry_workers']}, "
                   f"clock_err_max_s {ph.get('clock_err_max_s')}, joined "
                   f"{ph['workers_joined']}, left {ph['workers_left']}")
    return out


def phase_cluster(device="cuda", sizes=None) -> dict:
    """cpu-cluster with two worker processes on the card (the cuda backend,
    SIEVE_CLUSTER_WORKER_BACKEND=cuda): checkpointed and equal to the cuda
    local run segment for segment, its resume (no worker spawned), a run
    with the worker that draws segment 3 killed, each against the oracles,
    with the fused kernel's launches summed from the workers' registries
    equal to the segments; two workers on the torch backend, whose
    word-kernel segments last over a second, so heartbeats must arrive
    while a segment runs on the card; then the CPU default (cpu-native
    workers)."""
    sizes = sizes or CLUSTER_SIZES
    n, nseg, workers = sizes["n"], sizes["segments"], sizes["workers"]
    on_card = device == "cuda"
    base = ["--n", str(n), "--twins", "--backend", "cpu-cluster", "--workers",
            str(workers), "--segments", str(nseg), "--device", device,
            "--coordinator-addr", "127.0.0.1:0"]
    card = {"SIEVE_CLUSTER_WORKER_BACKEND": "cuda"}
    want_launches = _device_segments(n, "odds", nseg) if on_card else 0
    out = {}
    mark_fused.launches = 0
    local = run_local(SieveConfig(n=n, twins=True, n_segments=nseg, backend="cuda",
                                  device=device, quiet=True))
    out["local_segments"] = [_fields(r) for r in local.segments]
    with tempfile.TemporaryDirectory(prefix="sieve_cluster_") as ck:
        runs = {"card": _cluster_run("2 cuda workers, --checkpoint-dir",
                                     base + ["--checkpoint-dir", ck], card, workers,
                                     on_card)}
        if _ledger_fields(ck) != out["local_segments"]:
            raise AssertionError("cluster on cuda workers != the cuda local run")
        log("cluster", f"  == the cuda local run segment for segment ({nseg} segments)")
        runs["resume"] = _cluster_run("--resume", base + ["--checkpoint-dir", ck,
                                                          "--resume"],
                                      card, workers, on_card)
        if runs["resume"]["host_phases"]["workers_joined"] != 0:
            raise AssertionError("the resumed cluster run spawned workers")
    runs["kill"] = _cluster_run("2 cuda workers, --chaos-kill-worker any@3",
                                base + ["--chaos-kill-worker", "any@3"], card,
                                workers, on_card)
    if not (runs["kill"]["worker_failed"] and runs["kill"]["reassigned"]):
        raise AssertionError("the chaos kill run killed no worker")
    for what in ("card", "resume", "kill"):
        run = runs[what]
        _check_oracles(base, run)
        want = 0 if what == "resume" else want_launches
        if run["launches"] != want:
            raise AssertionError(f"cluster {what}: {run['launches']} fused launches "
                                 f"on the workers for {want} device segments")
    # heartbeats while a segment runs on the card: word-kernel segments
    # of over a second, so the worker's main thread must send progress
    # while the segment's thread waits on the card
    hb_n = sizes["hb_n"]
    hb_argv = ["--n", str(hb_n), "--twins", "--backend", "cpu-cluster", "--workers",
               str(workers), "--segments", str(sizes["hb_segments"]), "--device",
               device, "--coordinator-addr", "127.0.0.1:0"]
    runs["heartbeat"] = _cluster_run(
        "2 torch workers (the word kernel), heartbeats", hb_argv,
        {"SIEVE_CLUSTER_WORKER_BACKEND": "torch"}, workers, on_card,
        counters=("kernel.mark_words.cuda_calls", "kernel.mark_words_batch.cuda_calls"))
    _check_oracles(hb_argv, runs["heartbeat"])
    want_calls = _device_segments(hb_n, "odds", sizes["hb_segments"]) if on_card else 0
    if runs["heartbeat"]["launches"] != want_calls:
        raise AssertionError(f"torch workers: {runs['heartbeat']['launches']} word-kernel "
                             f"calls for {want_calls} device segments")
    if on_card and runs["heartbeat"]["heartbeats"] < 1:
        raise AssertionError("no heartbeat reached the coordinator while the "
                             "workers' segments ran on the card")
    cpu_argv = ["--n", str(sizes["cpu_n"]), "--twins", "--backend", "cpu-cluster",
                "--workers", str(sizes["cpu_workers"]), "--coordinator-addr",
                "127.0.0.1:0", "--device", device]
    runs["cpu"] = _cluster_run(f"{sizes['cpu_workers']} cpu-native workers",
                               cpu_argv, {"SIEVE_CLUSTER_WORKER_BACKEND": None},
                               sizes["cpu_workers"], False)
    _check_oracles(cpu_argv, runs["cpu"])
    out["runs"] = runs
    out["launches"] = sum(runs[k]["launches"] for k in ("card", "resume", "kill"))
    return out


def cli_main(argv: list[str]) -> int:
    """One CLI run in a process of its own (this script run as
    ``chip_smoke.py --cli <CLI arguments>``: a ``--multihost`` rank, or the
    fleet phase's tuned run): the CLI's main, then one JSON line with its
    exit code, its output and this process's kernel launches."""
    buf = io.StringIO()
    mark_fused.launches = mark_split.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = sieve_torch_main(argv)
    print(json.dumps({"rc": rc, "out": buf.getvalue(), "fused": mark_fused.launches,
                      "split": mark_split.launches}))
    return rc


def _free_addr() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _ranks(argv: list[str], devices: list[str], tmp: Path, tag: str) -> list[dict]:
    """Run one rank per device as its own process; returns per rank the
    child's JSON line plus its host_prepare event."""
    addr = _free_addr()
    procs = []
    try:
        for r, dev in enumerate(devices):
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--cli", *argv,
                 "--device", dev, "--json", "--quiet", "--multihost",
                 "--dist-coordinator", addr, "--dist-processes", str(len(devices)),
                 "--dist-process-id", str(r),
                 "--metrics-file", str(tmp / f"{tag}-rank{r}.jsonl"),
                 "--trace", str(tmp / f"{tag}-rank{r}.trace.json")],
                cwd=Path(__file__).resolve().parent, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = []
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=RANK_WAIT_S)
            if p.returncode != 0:
                raise AssertionError(f"{tag} rank {r} exited {p.returncode}:\n"
                                     f"{stdout[-3000:]}\n{stderr[-3000:]}")
            child = json.loads(stdout.strip().splitlines()[-1])
            recs = [json.loads(x) for x in
                    (tmp / f"{tag}-rank{r}.jsonl").read_text().splitlines()]
            child["host_prepare"] = next(x for x in recs if x["event"] == "host_prepare")
            events = json.loads((tmp / f"{tag}-rank{r}.trace.json").read_text())
            child["gather_ms"] = [e["dur"] / 1e3 for e in events["traceEvents"]
                                  if e.get("ph") == "X" and e["name"] == "round.gather"]
            outs.append(child)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def _log_ranks(what: str, ranks: list[dict], rounds: int) -> dict:
    got = json.loads(ranks[0]["out"].strip().splitlines()[-1])
    for r, child in enumerate(ranks[1:], 1):
        if child["out"].strip():
            raise AssertionError(f"{what}: rank {r} printed {child['out']!r}")
    per_rank = []
    for child in ranks:
        ph = child["host_prepare"]
        g = child["gather_ms"]
        per_rank.append({k: ph.get(k) for k in (
            "rank", "dist_backend", "gather_s", "stack_s", "dispatch_s", "drain_s",
            "rounds_prepared", "device_idle_frac")} | {
            "fused": child["fused"],
            "gather_ms_median": statistics.median(g) if g else None,
            "gather_ms_first": g[0] if g else None,
            "gather_ms_max": max(g) if g else None})
    log("multihost", f"{what}: pi {got['pi']} pairs {got['twin_pairs']} | run "
                     f"{got['elapsed_s']:.4f} s, {got['values_per_sec']:.4e} values/s"
                     f" | per rank {per_rank} | {rounds} rounds")
    return {"pi": got["pi"], "twin_pairs": got["twin_pairs"],
            "run_s": got["elapsed_s"], "values_per_s": got["values_per_sec"],
            "ranks": per_rank}


def phase_multihost(local_segments: list[dict], device="cuda", sizes=None) -> dict:
    """``--multihost`` ranks as processes: two gloo ranks sharing the card
    (``--workers 2``, one shard each), checkpointed, equal to the cuda local
    run of the same plan segment for segment, then its resume, which
    launches nothing on either rank; and one rank under NCCL, equal to the
    plain run_mesh run segment for segment."""
    sizes = sizes or MULTIHOST_SIZES
    on_card = device == "cuda"
    dev0 = "cuda:0" if on_card else "cpu"
    n, rounds = sizes["n"], sizes["rounds"]
    out = {"launches": 0}
    with tempfile.TemporaryDirectory(prefix="sieve_mh_") as tmp:
        tmp = Path(tmp)
        ck = str(tmp / "ck")
        argv = ["--n", str(n), "--twins", "--workers", "2", "--rounds", str(rounds),
                "--checkpoint-dir", ck]
        ranks = _ranks(argv, [dev0, dev0], tmp, "gloo")
        out["gloo"] = _log_ranks(f"2 gloo ranks on {dev0}, " + " ".join(argv[:7]),
                                 ranks, rounds)
        _check_oracles(argv, out["gloo"])
        if _ledger_fields(ck) != local_segments:
            raise AssertionError("the two ranks' ledger != the cuda local run")
        log("multihost", "  rank 0's ledger == the cuda local run segment for segment")
        for r, child in enumerate(ranks):
            if child["host_prepare"]["dist_backend"] != "gloo":
                raise AssertionError("ranks sharing a card must run gloo")
            if child["fused"] != (rounds if on_card else 0):
                raise AssertionError(f"gloo rank {r}: {child['fused']} launches for "
                                     f"{rounds} rounds of one shard")
            out["launches"] += child["fused"]
        ranks = _ranks(argv + ["--resume"], [dev0, dev0], tmp, "resume")
        out["resume"] = _log_ranks("  --resume", ranks, rounds)
        _check_oracles(argv, out["resume"])
        for r, child in enumerate(ranks):
            if child["fused"] or child["host_prepare"]["rounds_prepared"]:
                raise AssertionError(f"resumed rank {r} launched or prepared")
        nn, nrounds = sizes["nccl_n"], sizes["nccl_rounds"]
        ck1 = str(tmp / "ck1")
        argv = ["--n", str(nn), "--twins", "--workers", "1", "--rounds", str(nrounds),
                "--checkpoint-dir", ck1]
        ranks = _ranks(argv, [dev0], tmp, "nccl")
        out["nccl"] = _log_ranks("1 rank, " + " ".join(argv[:7]), ranks, nrounds)
        _check_oracles(argv, out["nccl"])
        backend = ranks[0]["host_prepare"]["dist_backend"]
        if backend != ("nccl" if on_card else "gloo"):
            raise AssertionError(f"one rank on its own card ran {backend}")
        if ranks[0]["fused"] != (nrounds if on_card else 0):
            raise AssertionError(f"nccl rank: {ranks[0]['fused']} launches for "
                                 f"{nrounds} rounds")
        out["launches"] += ranks[0]["fused"]
        plain = run_mesh(SieveConfig(n=nn, twins=True, rounds=nrounds, backend="cuda",
                                     device=device, quiet=True))
        if _ledger_fields(ck1) != [_fields(r) for r in plain.segments]:
            raise AssertionError("the NCCL rank != the plain run_mesh run")
        log("multihost", f"  == the plain run_mesh run segment for segment "
                         f"({plain.elapsed_s:.4f} s in this process)")
    return out


# --- the service's data plane --------------------------------------------------

SERVICE_SIZES = {"n": 10**10, "segments": 16}
# the largest prime below n, for the nth() and --emit-primes checks
LAST_PRIME = {10**6: 999_983, 10**7: 9_999_991, 10**9: 999_999_937,
              10**10: 9_999_999_967}


def _emit(argv: list[str]) -> tuple[str, float]:
    """``python3 -m sieve_torch <argv>`` as its own process; (stdout, wall s)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sieve_torch", *argv],
                          cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m sieve_torch {' '.join(argv)} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, wall


def phase_service(device="cuda", sizes=None) -> dict:
    """The service's data plane over a ledger the card wrote: the counting
    run with a checkpoint (its fused launches counted), the ledger opened
    read-only, a tiered store seeded from it, a SieveIndex with a one-entry
    LRU (so chunks demote into the store) answering prefix counts, nth and
    a batch exactly; the store reopened from a second handle answering the
    interior query from tier 2 with no new materialization; and
    ``--emit-primes`` as its own process, text and --json."""
    from sieve_torch.checkpoint import Ledger
    from sieve_torch.cli import build_parser, config_from_args
    from sieve_torch.service import QueryCtx, SieveIndex, StoreSettings, TieredSegmentStore

    sizes = sizes or SERVICE_SIZES
    n, nseg = sizes["n"], sizes["segments"]
    interior = n // 10  # strictly inside a segment of the plan (checked below)
    on_card = device == "cuda"
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="sieve_svc_") as ck:
        argv = ["--n", str(n), "--twins", "--segments", str(nseg), "--checkpoint-dir",
                ck, "--backend", "cuda", "--device", device]
        mark_fused.launches = mark_split.launches = 0
        got, wall = run_cli(argv)
        out["launches"] = mark_fused.launches
        want = _device_segments(n, "odds", nseg) if on_card else 0
        _check_launches("service: the counting run", want, 0)
        if got["pi"] != PI[n] or got["twin_pairs"] != TWINS[n]:
            raise AssertionError(f"service run: pi {got['pi']} twins {got['twin_pairs']}")
        log("service", f"sieve_torch {' '.join(argv[:7])}: pi {got['pi']} pairs "
                       f"{got['twin_pairs']} | run {got['elapsed_s']:.4f} s (wall "
                       f"{wall:.4f} s) | fused launches {out['launches']}/{want}")

        cfg = config_from_args(build_parser().parse_args(argv))
        ledger = Ledger.open_readonly(cfg)
        if ledger.unverified or len(ledger.completed()) != nseg:
            raise AssertionError(f"read-only ledger: unverified {ledger.unverified}, "
                                 f"{len(ledger.completed())} segments")
        root = str(Path(ck) / "store")
        settings = StoreSettings(compact_s=0.0)
        t_q = time.perf_counter()
        store = TieredSegmentStore(root, writer=True, settings=settings)
        rows = ledger.store_tier0_entries()
        store.import_ledger(rows)
        tier0 = [(lo, hi, c) for lo, hi, c, tier in store.export_counts() if tier == 0]
        if tier0 != rows:
            raise AssertionError("the store's tier-0 export != the ledger's rows")
        idx = SieveIndex("odds", ledger.completed(), lru_segments=1, store=store)
        if interior in idx.bounds:
            raise AssertionError(f"{interior} is a segment boundary, not an interior point")
        last = LAST_PRIME[n]
        checks = [("count_upto", interior, idx.count_upto, PI[interior]),
                  ("count_upto", idx.covered_hi, idx.count_upto, PI[n]),
                  ("nth", PI[interior], idx.nth, LAST_PRIME[interior]),
                  ("nth", PI[n], idx.nth, last)]
        for name, arg, fn, want_v in checks:
            v = fn(arg, QueryCtx())
            if v != want_v:
                raise AssertionError(f"{name}({arg}) = {v}, expected {want_v}")
            log("service", f"  {name}({arg}) = {v}")
        points = [interior, idx.covered_hi, 2, interior - 1]
        batch = idx.count_upto_batch(points, QueryCtx()).tolist()
        scalar = [idx.count_upto(v, QueryCtx()) for v in points]
        if batch != scalar:
            raise AssertionError(f"count_upto_batch {batch} != count_upto {scalar}")
        out["queries_s"] = time.perf_counter() - t_q
        out["index"] = idx.stats()
        out["store"] = store.stats()
        store.close()

        reopened = TieredSegmentStore(root, writer=False, settings=settings)
        idx2 = SieveIndex("odds", ledger.completed(), lru_segments=1, store=reopened)
        ctx = QueryCtx()
        t_r = time.perf_counter()
        v = idx2.count_upto(interior, ctx)
        out["reopened_query_s"] = time.perf_counter() - t_r
        out["reopened_index"] = idx2.stats()
        out["reopened_store"] = reopened.stats()
        reopened.close()
        if v != PI[interior] or not ctx.store_hit or ctx.materialized or idx2.materialized:
            raise AssertionError(f"reopened store: count_upto({interior}) = {v}, "
                                 f"store_hit {ctx.store_hit}, materialized "
                                 f"{idx2.materialized}")
        log("service", f"  reopened from a second handle: count_upto({interior}) = {v} "
                       f"from {out['reopened_store']['hits']} store hits, 0 sieved")

    window = f"{interior - 100}:{interior}"
    text, out["emit_wall_s"] = _emit(["--emit-primes", window])
    listed, out["emit_json_wall_s"] = _emit(["--emit-primes", window, "--json"])
    lines = text.splitlines()
    if not lines or lines[-1] != str(LAST_PRIME[interior]):
        raise AssertionError(f"--emit-primes {window} ended {lines[-1:]}")
    if json.loads(listed) != [int(x) for x in lines]:
        raise AssertionError(f"--emit-primes {window} --json != the text form")
    log("service", f"  --emit-primes {window}: {len(lines)} primes, last {lines[-1]} "
                   f"({out['emit_wall_s']:.3f} s; --json {out['emit_json_wall_s']:.3f} s)")
    out["seconds"] = time.perf_counter() - t0
    return out


SERVE_SIZES = {"n": 10**10, "x": 10**9, "segments": 16, "window": 10**8}
# twin pairs (p, p+2) with p+2 below x
TWINS_BELOW = {10**5: 1_224, 10**8: 440_312}


def _percentiles(replies: list[tuple[str, dict]]) -> dict:
    """p50/p95 of the replies' ``elapsed_ms``, per op."""
    by_op: dict[str, list[float]] = {}
    for op, r in replies:
        by_op.setdefault(op, []).append(float(r["elapsed_ms"]))
    return {op: {"n": len(v), "p50_ms": float(np.percentile(v, 50)),
                 "p95_ms": float(np.percentile(v, 95))}
            for op, v in sorted(by_op.items())}


def _serve_burst(addr: str, jobs: list[tuple[str, dict]], threads: int | None = None,
                 after=None) -> list[dict]:
    """The jobs on ``threads`` client threads (default: one per job, all at
    once), one ``ServiceClient`` each; the raw replies in job order (a
    failed call raises here). ``after(i)`` runs after the i-th reply."""
    from concurrent.futures import ThreadPoolExecutor

    from sieve_torch.service import ServiceClient

    done = iter(range(len(jobs)))

    def one(job):
        op, kw = job
        with ServiceClient(addr, timeout_s=120) as c:
            r = c.query_batch(kw["members"]) if op == "batch" else c.query(op, **kw)
        if after is not None:
            after(next(done))
        return r

    with ThreadPoolExecutor(max_workers=threads or len(jobs)) as pool:
        return list(pool.map(one, jobs))


def _host_chunks(packing: str, chunks) -> int:
    """Chunks the cuda worker answers on the host, by the reference's rule
    for its device backends: fewer than MIN_DEVICE_BITS candidate bits."""
    layout = get_layout(packing)
    return sum(layout.nbits(lo, hi) < pairs.MIN_DEVICE_BITS for lo, hi in chunks)


def _serve_loop_plane(device: str, sizes: dict, out: dict) -> None:
    """(a) a cold-only server on the cuda backend at the reference's
    default settings: every cold chunk is one fused-kernel launch."""
    from sieve_torch.service import ServiceClient, ServiceSettings, SieveService

    n, x = sizes["n"], sizes["x"]
    on_card = device == "cuda"
    cfg = SieveConfig(n=n, backend="cuda", device=device, quiet=True)
    rng = np.random.default_rng(7)
    members = []
    for v in rng.integers(2, n, size=64).tolist():
        kind = len(members) % 3
        if kind == 0:
            members.append({"op": "pi", "x": v})
        elif kind == 1:
            members.append({"op": "is_prime", "x": v})
        else:
            members.append({"op": "count", "lo": v // 2, "hi": v})
    last_x = LAST_PRIME[x]
    jobs = [("pi", {"x": x}),
            ("count", {"lo": 2, "hi": x // 10, "kind": "twins"}),
            ("pi", {"x": n}),
            ("is_prime", {"x": LAST_PRIME[n]}),
            ("nth_prime", {"k": PI[x]}),
            ("primes", {"lo": x - 100, "hi": x}),
            ("count", {"lo": x, "hi": n}),
            ("batch", {"members": members})]
    want = [PI[x], TWINS_BELOW[x // 10], PI[n], True, last_x, None,
            PI[n] - PI[x], None]
    svc = SieveService(cfg, ServiceSettings())
    svc.start()
    try:
        with ServiceClient(svc.addr, timeout_s=120) as c:
            mark_fused.launches = mark_split.launches = 0
            t_w = time.perf_counter()
            warm = c.pi(10**6)
            out["warm_s"] = time.perf_counter() - t_w
            if warm != 78_498:
                raise AssertionError(f"serve loop: warm pi(1e6) = {warm}")
            t_b = time.perf_counter()
            replies = _serve_burst(svc.addr, jobs)
            out["burst_s"] = time.perf_counter() - t_b
            launches = mark_fused.launches
            split = mark_split.launches
            for (op, kw), r, w in zip(jobs, replies, want):
                if op == "batch":
                    continue
                if not r.get("ok"):
                    raise AssertionError(f"serve loop: {op} {kw} -> {r}")
                if op == "primes":
                    vals = [int(v) for v in r["value"]]
                    if not vals or vals[-1] != last_x or vals != sorted(vals):
                        raise AssertionError(f"serve loop: primes {kw} ended {vals[-3:]}")
                elif r["value"] != w:
                    raise AssertionError(f"serve loop: {op} {kw} = {r['value']}, "
                                         f"expected {w}")
            batch = replies[-1]
            scalar = []
            for m in members:
                kw = {k: v for k, v in m.items() if k != "op"}
                scalar.append(c.query(m["op"], **kw)["value"])
            got = [b.get("value") for b in batch]
            if not all(b.get("ok") for b in batch) or got != scalar:
                raise AssertionError(f"serve loop: batch != its scalar answers: "
                                     f"{[(g, s) for g, s in zip(got, scalar) if g != s][:4]}")
            stats = c.stats()
        worker = svc.cold._worker
        host = worker.host_segments if worker is not None else 0
    finally:
        svc.stop()
    chunks = stats["cold_batched_chunks"]
    if stats["degraded_replies"] or stats["internal_errors"]:
        raise AssertionError(f"serve loop: degraded {stats['degraded_replies']}, "
                             f"internal {stats['internal_errors']}")
    if stats["cold_store_hits"] or stats["mesh_launches"] or split:
        raise AssertionError("serve loop: a chunk bypassed the loop worker")
    want_launches = (chunks - host) if on_card else 0
    if launches != want_launches:
        raise AssertionError(f"serve loop: {launches} fused launches for {chunks} "
                             f"chunks less {host} answered on the host")
    requests = stats["requests"] + stats["batch_members"]
    cap = -(-chunks // 128) + requests
    if stats["cold_dispatches"] > cap:
        raise AssertionError(f"serve loop: {stats['cold_dispatches']} dispatches > "
                             f"ceil({chunks}/128) + {requests} requests")
    out.update(dispatches=stats["cold_dispatches"], chunks=chunks,
               host_chunks=host, launches=launches, coalesced=stats["coalesced"],
               requests=requests,
               ops=_percentiles([(op, r) for (op, _), r in zip(jobs, replies)
                                 if op != "batch"]))
    log("serve", f"loop plane (cuda, n={n}): burst {out['burst_s']:.3f} s after a "
                 f"{out['warm_s']:.3f} s warm-up | {stats['cold_dispatches']} dispatches, "
                 f"{chunks} chunks, {host} on the host, fused launches {launches} | "
                 f"batch of {len(members)} == scalar")


def _serve_mesh_plane(device: str, sizes: dict, out: dict) -> None:
    """(b) the mesh cold plane: the word kernel, one dispatch per drain."""
    from sieve_torch.service import ServiceClient, ServiceSettings, SieveService

    x = sizes["x"]
    on_card = device == "cuda"
    cfg = SieveConfig(n=sizes["n"], backend="cuda", device=device, quiet=True)
    svc = SieveService(cfg, ServiceSettings(cold_backend="mesh"))
    svc.start()
    try:
        mark_fused.launches = 0
        word_mark.mark_words_batch.cuda_calls = 0
        t_b = time.perf_counter()
        jobs = [("pi", {"x": x}), ("count", {"lo": 2, "hi": x})]
        replies = _serve_burst(svc.addr, jobs)
        out["burst_s"] = time.perf_counter() - t_b
        calls = word_mark.mark_words_batch.cuda_calls
        fused = mark_fused.launches
        for (op, kw), r in zip(jobs, replies):
            if r.get("value") != PI[x]:
                raise AssertionError(f"serve mesh: {op} {kw} -> {r}")
        with ServiceClient(svc.addr) as c:
            stats = c.stats()
        desc = svc.cold.describe()
    finally:
        svc.stop()
    if desc["cold_backend"] != "mesh" or desc["mesh_devices"] != 1:
        raise AssertionError(f"serve mesh: describe() = {desc}")
    if stats["mesh_launches"] < 1 or stats["mesh_fallbacks"] != 0:
        raise AssertionError(f"serve mesh: launches {stats['mesh_launches']}, "
                             f"fallbacks {stats['mesh_fallbacks']}")
    if stats["degraded_replies"] or stats["internal_errors"] or fused:
        raise AssertionError(f"serve mesh: degraded {stats['degraded_replies']}, "
                             f"internal {stats['internal_errors']}, fused {fused}")
    if on_card and calls < 1:
        raise AssertionError("serve mesh: no mark_words_batch call on the card")
    out.update(dispatches=stats["cold_dispatches"], chunks=stats["cold_batched_chunks"],
               mesh_launches=stats["mesh_launches"], words_calls=calls,
               ops=_percentiles(list(zip(["pi", "count"], replies))))
    log("serve", f"mesh plane (n={sizes['n']}): pi({x}) and count(2, {x}) = {PI[x]} in "
                 f"{out['burst_s']:.3f} s | {stats['cold_dispatches']} dispatches, "
                 f"{stats['cold_batched_chunks']} chunks, {stats['mesh_launches']} mesh "
                 f"launches, {calls} word-kernel calls, 0 fallbacks")


def _serve_cli(device: str, sizes: dict, out: dict) -> None:
    """(c) ``python3 -m sieve_torch serve`` over a ledger the card wrote:
    hot queries from the index, a cold window past it on the fused kernel
    (held against cpu-native), then the shutdown op and a clean exit."""
    from sieve_torch.backends.cpu_native import CpuNativeWorker
    from sieve_torch.service import ServiceClient, ServiceSettings

    n, nseg, window = sizes["n"], sizes["segments"], sizes["window"]
    defaults = ServiceSettings()  # what `serve` runs with
    on_card = device == "cuda"
    with tempfile.TemporaryDirectory(prefix="sieve_serve_") as ck:
        # no --twins: serve's config has no pair kind, and the ledger's
        # config hash includes it (the reference refuses such a ledger too)
        argv = ["--n", str(n), "--segments", str(nseg), "--checkpoint-dir", ck,
                "--backend", "cuda", "--device", device]
        mark_fused.launches = 0
        got, _wall = run_cli(argv)
        out["ledger_launches"] = mark_fused.launches
        _check_launches("serve: the ledger's counting run",
                        _device_segments(n, "odds", nseg) if on_card else 0, 0)
        if got["pi"] != PI[n]:
            raise AssertionError(f"serve ledger: pi {got['pi']}")
        cmd = [sys.executable, "-m", "sieve_torch", "serve", "--n", str(n), "--segments",
               str(nseg), "--checkpoint-dir", ck, "--addr", "127.0.0.1:0", "--quiet"]
        if not on_card:
            cmd += ["--device", device]
        so, se = Path(ck) / "serve.out", Path(ck) / "serve.err"
        t0 = time.perf_counter()
        with open(so, "w") as fo, open(se, "w") as fe:
            proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent,
                                    stdout=fo, stderr=fe, text=True)
        try:
            head = None
            while head is None:
                if proc.poll() is not None:
                    raise AssertionError(f"serve exited {proc.returncode}: "
                                         f"{se.read_text()[-2000:]}")
                if time.perf_counter() - t0 > 180:
                    raise AssertionError("serve printed no address line in 180 s")
                lines = so.read_text().splitlines()
                if lines:
                    head = json.loads(lines[0])
                else:
                    time.sleep(0.05)
            out["start_s"] = time.perf_counter() - t0
            lo, hi = n, n + window
            with ServiceClient(head["addr"], timeout_s=120) as c:
                hot = [c.query("pi", x=n), c.query("nth_prime", k=PI[n])]
                if [r.get("value") for r in hot] != [PI[n], LAST_PRIME[n]]:
                    raise AssertionError(f"serve cli: hot replies {hot}")
                if any(r["source"] != "index" for r in hot):
                    raise AssertionError(f"serve cli: hot sources {hot}")
                cold = c.query("count", lo=lo, hi=hi)
                stats = c.stats()
                launched = c.metrics().get("kernel.mark_fused.launches",
                                           {}).get("value", 0)
                t_s = time.perf_counter()
                c.shutdown()
            rc = proc.wait(timeout=60)
            out["exit_s"] = time.perf_counter() - t_s
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0:
            raise AssertionError(f"serve exited {rc}: {se.read_text()[-2000:]}")
        if out["exit_s"] > defaults.drain_s:
            raise AssertionError(f"serve took {out['exit_s']:.2f} s to exit after "
                                 f"shutdown, past drain_s {defaults.drain_s}")
        drained = json.loads(so.read_text().splitlines()[-1])
        if drained.get("event") != "drained" or not drained.get("clean"):
            raise AssertionError(f"serve: last line {drained}")
    seeds = seed_primes(math.isqrt(hi - 1))
    native = CpuNativeWorker(SieveConfig(n=hi, backend="cpu-native")).process_segment(
        lo, hi, seeds).count
    if not cold.get("ok") or cold["value"] != native:
        raise AssertionError(f"serve cli: count({lo}, {hi}) -> {cold}, cpu-native {native}")
    covered = int(head["covered_hi"])
    chunks = []
    a = covered
    while a < hi:
        b = min((a // defaults.cold_chunk + 1) * defaults.cold_chunk, hi)
        chunks.append((a, b))
        a = b
    host = _host_chunks("odds", chunks)
    if stats["cold_batched_chunks"] != len(chunks):
        raise AssertionError(f"serve cli: {stats['cold_batched_chunks']} chunks, "
                             f"the grid gives {len(chunks)}")
    want = (len(chunks) - host) if on_card else 0
    if launched != want or stats["degraded_replies"] or stats["internal_errors"]:
        raise AssertionError(f"serve cli: {launched} fused launches for "
                             f"{len(chunks)} chunks less {host} on the host")
    out.update(dispatches=stats["cold_dispatches"], chunks=len(chunks), host_chunks=host,
               launches=launched, cold_count=cold["value"],
               ops=_percentiles([("pi", hot[0]), ("nth_prime", hot[1]),
                                 ("count", cold)]))
    log("serve", f"CLI: up in {out['start_s']:.3f} s | pi({n}) and nth_prime({PI[n]}) "
                 f"from the index | count({lo}, {hi}) = {cold['value']} (cpu-native "
                 f"{native}) on {len(chunks)} chunks, {launched} fused launches in the "
                 f"server | shutdown -> exit 0 in {out['exit_s']:.3f} s")


def phase_serve(device="cuda", sizes=None) -> dict:
    """One ``serve`` process with its cold plane on the card: (a) an
    in-process cold-only server on the cuda backend under a concurrent
    burst of every query op, its fused launches == its chunks less the
    ones answered on the host; (b) the mesh cold plane on the word kernel,
    with no fallback; (c) the CLI's ``serve`` as a process over a ledger
    the card wrote, a cold window past it, and its shutdown."""
    sizes = sizes or SERVE_SIZES
    t0 = time.perf_counter()
    out = {"loop": {}, "mesh": {}, "cli": {}}
    _serve_loop_plane(device, sizes, out["loop"])
    _serve_mesh_plane(device, sizes, out["mesh"])
    _serve_cli(device, sizes, out["cli"])
    out["launches"] = (out["loop"]["launches"] + out["cli"]["ledger_launches"]
                       + out["cli"]["launches"])
    out["seconds"] = time.perf_counter() - t0
    return out


FABRIC_SIZES = {"n": 10**10, "segments": 16, "window": 10**8, "cli_window": 10**7,
                "span": 1 << 22}
# primes in [1e10, 1e10 + 1e8): the served cold window of phase serve
COLD_WINDOW = {(10**10, 10**8): 4_341_930}


def _prime_pi(x: int) -> int:
    """pi(x) by Lucy's recursion on the values x // i, vectorized in numpy
    (O(x^0.75)): an oracle for any point the fabric counts, independent of
    every marking path of the port."""
    if x < 2:
        return 0
    r = math.isqrt(x)
    small = np.arange(-1, r, dtype=np.int64)  # small[v] = S(v), v <= r
    large = np.zeros(r + 1, dtype=np.int64)  # large[i] = S(x // i)
    large[1:] = x // np.arange(1, r + 1, dtype=np.int64) - 1
    for p in range(2, r + 1):
        if small[p] == small[p - 1]:
            continue  # p is composite
        sp, p2 = small[p - 1], p * p
        # every right-hand side is read before the step writes (the
        # recursion's old values): large first, then small
        imax = min(r, x // p2)
        ip = np.arange(1, imax + 1, dtype=np.int64) * p
        inner = np.where(ip <= r, large[np.minimum(ip, r)], small[np.minimum(x // ip, r)])
        large[1:imax + 1] -= inner - sp
        if p2 <= r:
            v = np.arange(p2, r + 1, dtype=np.int64)
            small[p2:] -= small[v // p] - sp
    return int(large[1])


def _window_primes(lo: int, hi: int) -> np.ndarray:
    """The primes of [lo, hi) by a plain sieve of the window."""
    flags = np.ones(hi - lo, dtype=bool)
    for p in seed_primes(math.isqrt(max(hi - 1, 1))).tolist():
        start = max(p * p, -(-lo // p) * p)
        flags[start - lo::p] = False
    vals = np.flatnonzero(flags).astype(np.int64) + lo
    return vals[vals >= 2]


def _native_pairs(lo: int, hi: int, kind: str) -> int:
    """Pairs of ``kind`` with both members in [lo, hi), by cpu-native."""
    from sieve_torch.backends.cpu_native import CpuNativeWorker

    seeds = seed_primes(math.isqrt(hi - 1))
    worker = CpuNativeWorker(SieveConfig(n=hi, backend="cpu-native", count_kind=kind))
    return worker.process_segment(lo, hi, seeds).twin_count


class _Anchors:
    """Exact pi(v) for v in [a, a + span) of a few anchors a: pi(a - 1) by
    Lucy's recursion plus a plain sieve of the span."""

    def __init__(self, anchors, span: int):
        self.span = span
        self.base = {a: _prime_pi(a - 1) for a in anchors}
        self.win = {a: _window_primes(a, a + span) for a in anchors}

    def pi(self, v: int) -> int:
        for a, w in self.win.items():
            if a - 1 <= v < a + self.span:
                return self.base[a] + int(np.searchsorted(w, v, side="right"))
        raise KeyError(f"{v} lies near no anchor")

    def count(self, lo: int, hi: int) -> int:
        return self.pi(hi - 1) - self.pi(lo - 1)

    def is_prime(self, v: int) -> bool:
        return self.count(v, v + 1) == 1


def _write_ledger(ck: str, n: int, nseg: int, device: str, twins: bool):
    """The port's counting run writes the ledger (its launches counted);
    returns (launches, the run's config)."""
    from sieve_torch.cli import build_parser, config_from_args

    argv = ["--n", str(n), "--segments", str(nseg), "--checkpoint-dir", ck,
            "--backend", "cuda", "--device", device] + (["--twins"] if twins else [])
    mark_fused.launches = mark_split.launches = 0
    got, wall = run_cli(argv)
    launches = mark_fused.launches
    _check_launches("fabric: the ledger's counting run",
                    _device_segments(n, "odds", nseg) if device == "cuda" else 0, 0)
    if got["pi"] != PI[n] or (twins and got["twin_pairs"] != TWINS[n]):
        raise AssertionError(f"fabric ledger: pi {got['pi']} twins {got.get('twin_pairs')}")
    log("fabric", f"sieve_torch {' '.join(argv[:4])}{' --twins' if twins else ''}: pi "
                  f"{got['pi']}" + (f" twins {got['twin_pairs']}" if twins else "")
                  + f" in {wall:.3f} s, fused launches {launches}")
    cfg = config_from_args(build_parser().parse_args(argv + ["--quiet"]))
    return launches, cfg


def _split_ledger(cfg, root: Path, shard1_copies: int):
    """The ledger's segments split in half at E, a segment boundary: one
    directory for shard 0 and ``shard1_copies`` for shard 1 (each server
    writes the segment store of its own directory)."""
    from sieve_torch.checkpoint import Ledger

    segs = sorted(Ledger.open_readonly(cfg).completed().values(), key=lambda s: s.lo)
    half = len(segs) // 2
    E = segs[half].lo
    dirs = []
    for name, part in [("shard0", segs[:half])] + [
            (f"shard1_{i}", segs[half:]) for i in range(shard1_copies)]:
        d = str(root / name)
        led = Ledger.open(dataclasses.replace(cfg, checkpoint_dir=d))
        for r in part:
            led.record(r)
        dirs.append(d)
    return dirs, E, [s.lo for s in segs]


def _expect(what: str, reply, want) -> None:
    """A routed reply must be ok and equal ``want`` (a typed error raises)."""
    if not isinstance(reply, dict) or not reply.get("ok"):
        raise AssertionError(f"fabric: {what} -> {reply}")
    got = reply["value"]
    if isinstance(want, np.ndarray):
        got, want = [int(v) for v in got], want.tolist()
    if got != want:
        raise AssertionError(f"fabric: {what} = {got}, expected {want}")


def _unavailable(what: str, reply, shard: int, shard_range=None) -> None:
    if reply.get("error") != "unavailable" or reply.get("shard") != shard \
            or f"shard {shard}" not in reply.get("detail", "") \
            or (shard_range is not None and reply.get("shard_range") != shard_range):
        raise AssertionError(f"fabric: {what}: expected a typed unavailable naming "
                             f"shard {shard}, got {reply}")


def _fabric_inproc(device: str, sizes: dict, root: Path, out: dict) -> None:
    """(1) the fabric in this process, (2) its failure drill, (3) the
    observer over it."""
    from sieve_torch.chaos import ChaosSchedule, parse_chaos
    from sieve_torch.metrics import registry
    from sieve_torch.service import (
        ObserverSettings, RouterSettings, ServiceClient, ServiceSettings, Shard,
        ShardMap, SieveRouter, SieveService, read_ring)
    from sieve_torch.service.observe import ANOMALY_SIGNALS, RING_FILE, FleetObserver

    n, span = sizes["n"], sizes["span"]
    on_card = device == "cuda"
    ledger_launches, cfg = _write_ledger(str(root / "src"), n, sizes["segments"],
                                         device, twins=True)
    out["ledger_launches"] = ledger_launches
    dirs, E, los = _split_ledger(cfg, root, shard1_copies=2)
    half = len(los) // 2
    seg_size = los[1] - los[0]
    # interior points lie in a segment's first index chunk, so a hot query
    # materializes one chunk on the host, not a whole segment
    off = min(span, seg_size) // 3
    anchors = _Anchors([los[2], los[half - 1], E, los[half + 3]], span)
    t_o = time.perf_counter()
    pi_e = anchors.pi(E - 1)
    near_e = _window_primes(E - 2000, E + 2000)
    below_e, above_e = near_e[near_e < E], near_e[near_e >= E]
    k_mid = anchors.pi(los[half + 3] - 1) + 5
    out["oracle_s"] = time.perf_counter() - t_o

    def shard_cfg(d):
        return dataclasses.replace(cfg, checkpoint_dir=d)

    svcs = [SieveService(shard_cfg(dirs[0]), ServiceSettings()),
            SieveService(shard_cfg(dirs[1]), ServiceSettings(range_lo=E)),
            SieveService(shard_cfg(dirs[2]), ServiceSettings(range_lo=E))]
    router = None
    try:
        for s in svcs:
            s.start()
        smap = ShardMap([Shard(2, E, (svcs[0].addr,)),
                         Shard(E, n + 1, (svcs[1].addr, svcs[2].addr))])
        router = SieveRouter(smap, RouterSettings(quiet=True, wire_chaos=True)).start()
        reg = registry()
        probes0 = (reg.counter("router.probe_sent").value,
                   reg.counter("router.probe_cached").value)

        # --- (1) a concurrent burst across E ------------------------------
        rng = np.random.default_rng(11)
        members = []
        for j in range(64):
            a = [los[2], los[half - 1], E, los[half + 3]][j % 4]
            v = a + int(rng.integers(0, off))
            members.append([{"op": "pi", "x": v}, {"op": "is_prime", "x": v},
                            {"op": "count", "lo": a, "hi": v}][j % 3])
        w = 10**6
        pair_lo, pair_hi = E - w, E + w
        jobs = [
            ("pi", {"x": n}, PI[n]),
            ("pi", {"x": E}, anchors.pi(E)),
            ("pi", {"x": E - 1}, pi_e),
            ("pi", {"x": E + off}, anchors.pi(E + off)),
            ("pi", {"x": los[2] + off}, anchors.pi(los[2] + off)),
            ("count", {"lo": los[half - 1], "hi": E + off},
             anchors.count(los[half - 1], E + off)),
            ("count", {"lo": los[2] + 17, "hi": los[half + 3] + off},
             anchors.count(los[2] + 17, los[half + 3] + off)),
            ("count", {"lo": pair_lo, "hi": pair_hi, "kind": "twins"},
             _native_pairs(pair_lo, pair_hi, "twins")),
            ("count", {"lo": pair_lo, "hi": pair_hi, "kind": "cousins"},
             _native_pairs(pair_lo, pair_hi, "cousins")),
            ("nth_prime", {"k": pi_e + 7}, int(above_e[6])),
            ("nth_prime", {"k": pi_e}, int(below_e[-1])),
            ("nth_prime", {"k": k_mid}, int(anchors.win[los[half + 3]][4])),
            ("primes", {"lo": E - 300, "hi": E + 300}, _window_primes(E - 300, E + 300)),
            ("is_prime", {"x": int(below_e[-1])}, True),
            ("is_prime", {"x": int(above_e[0])}, True),
            ("is_prime", {"x": int(above_e[0]) + 1}, False),
            ("batch", {"members": members}, None),
        ]
        t_b = time.perf_counter()
        replies = _serve_burst(router.addr, [(op, kw) for op, kw, _ in jobs], 8)
        out["burst_s"] = time.perf_counter() - t_b
        for (op, kw, want), r in zip(jobs, replies):
            if op != "batch":
                _expect(f"{op} {kw}", r, want)
        for m, r in zip(members, replies[-1]):
            v = m.get("x", m.get("hi"))
            want = (anchors.pi(v) if m["op"] == "pi" else anchors.is_prime(v)
                    if m["op"] == "is_prime" else anchors.count(m["lo"], v))
            _expect(f"batch member {m}", r, want)
        with ServiceClient(router.addr, timeout_s=120) as c:
            st = c.stats()
            if st["totals_cached"] != 2 or st["spliced"] < 1:
                raise AssertionError(f"fabric: totals_cached {st['totals_cached']}, "
                                     f"spliced {st['spliced']}")
            # a cold window past the map: the last shard's cold tier
            lo, hi = n, n + sizes["window"]
            want = _prime_pi(hi - 1) - PI[n]
            if COLD_WINDOW.get((n, sizes["window"]), want) != want:
                raise AssertionError(f"fabric: the oracle's cold window {want}")
            mark_fused.launches = 0
            t_c = time.perf_counter()
            cold = c.query("count", lo=lo, hi=hi)
            out["cold_s"] = time.perf_counter() - t_c
            launches = mark_fused.launches
            _expect(f"count({lo}, {hi})", cold, want)
            st = c.stats()
        per = []
        for s in svcs:
            chunks = s.stats()["cold_batched_chunks"]
            worker = s.cold._worker
            per.append((chunks, worker.host_segments if worker is not None else 0))
        if per[0] != (0, 0) or svcs[0].cold._worker is not None:
            raise AssertionError(f"fabric: shard 0 did cold work: {per[0]}")
        own = sum(c - h for c, h in per[1:]) if on_card else 0
        if launches != own or sum(c for c, _ in per[1:]) < 1:
            raise AssertionError(f"fabric: {launches} fused launches, shard 1's "
                                 f"chunks less host answers {per[1:]}")
        probes = (reg.counter("router.probe_sent").value - probes0[0],
                  reg.counter("router.probe_cached").value - probes0[1])
        out["fabric"] = {
            "E": E, "requests": st["requests"], "spliced": st["spliced"],
            "totals_cached": st["totals_cached"], "failovers": st["failovers"],
            "probe_sent": probes[0], "probe_cached": probes[1],
            "cold_count": cold["value"], "cold_chunks": [c for c, _ in per],
            "host_chunks": [h for _, h in per], "launches": launches,
            # index chunks each server sieved on the host for hot queries
            "materialized": [s.index.stats()["materialized"] for s in svcs],
            "ops": _percentiles([(op, r) for (op, _, _), r in zip(jobs, replies)
                                 if op != "batch"] + [("count", cold)])}
        out["checked"] = len(jobs) - 1 + len(members) + 1
        log("fabric", f"in-process fabric: E={E}, {len(jobs) - 1} ops + a batch of "
                      f"{len(members)} on 8 threads in {out['burst_s']:.3f} s, every "
                      f"reply == the oracle | spliced {st['spliced']} | count({lo}, {hi}) "
                      f"= {cold['value']} in {out['cold_s']:.3f} s on shard 1: "
                      f"chunks {per[1][0]}+{per[2][0]}, host {per[1][1]}+{per[2][1]}, "
                      f"fused launches {launches}; shard 0 none")

        # --- (2) the failure drill -----------------------------------------
        drill = {}
        plan = [("count", {"lo": E + 10, "hi": E + off}, anchors.count(E + 10, E + off)),
                ("is_prime", {"x": int(above_e[1])}, True),
                ("nth_prime", {"k": pi_e + 3}, int(above_e[2])),
                ("primes", {"lo": E, "hi": E + 200}, _window_primes(E, E + 200))]
        mid = threading.Event()
        load = [plan[i % len(plan)] for i in range(48)]
        f0 = st["failovers"]

        def stop_first(i):
            if i == 8:
                svcs[1].stop()  # one shard-1 replica lost mid-burst
                mid.set()

        replies = _serve_burst(router.addr, [(op, kw) for op, kw, _ in load], 8,
                               after=stop_first)
        if not mid.is_set():
            raise AssertionError("fabric drill: the replica was never stopped")
        for (op, kw, want), r in zip(load, replies):
            _expect(f"drill {op} {kw}", r, want)
        with ServiceClient(router.addr, timeout_s=120) as c:
            drill["failovers"] = c.stats()["failovers"] - f0
            if drill["failovers"] < 1:
                raise AssertionError("fabric drill: no failover after a replica stopped")
            old = [svcs[1].addr, svcs[2].addr]
            svcs[2].stop()  # the whole of shard 1 is down
            rep = c.query("count", lo=E + 10, hi=E + off)
            _unavailable("shard 1 down", rep, 1, [E, n + 1])
            _expect("shard 0 during the outage",
                    c.query("count", lo=los[2] + 17, hi=los[2] + off),
                    anchors.count(los[2] + 17, los[2] + off))
            _expect("pi(n) from cached totals", c.query("pi", x=n), PI[n])
            # the replica comes back on its old address
            svcs[1] = SieveService(shard_cfg(dirs[1]), ServiceSettings(range_lo=E),
                                   addr=old[0]).start()
            t_r = time.perf_counter()
            while True:
                rep = c.query("count", lo=E + 10, hi=E + off)
                if rep.get("ok"):
                    _expect("after the restart", rep, anchors.count(E + 10, E + off))
                    break
                if time.perf_counter() - t_r > 30:
                    raise AssertionError(f"fabric drill: no recovery: {rep}")
                time.sleep(0.2)
            drill["recovery_s"] = time.perf_counter() - t_r
            # a wire-injected svc_shard_down window on shard 0
            seq = c.stats()["requests"]
            ack = c.inject_chaos(",".join(f"svc_shard_down:0@s{seq + j}:1.5"
                                          for j in (1, 2)))
            if not ack.get("ok"):
                raise AssertionError(f"fabric drill: chaos refused: {ack}")
            _expect("shard 1 inside the window", c.query("is_prime", x=int(above_e[1])),
                    True)
            _unavailable("shard 0 held down",
                         c.query("count", lo=los[2] + 17, hi=los[2] + off), 0)
            if c.stats()["shard_down_windows"] < 1:
                raise AssertionError("fabric drill: no shard_down window counted")
            time.sleep(1.6)
            t_w = time.perf_counter()
            while True:
                rep = c.query("count", lo=los[2] + 17, hi=los[2] + off)
                if rep.get("ok"):
                    _expect("after the window", rep, anchors.count(los[2] + 17, los[2] + off))
                    break
                if time.perf_counter() - t_w > 10:
                    raise AssertionError(f"fabric drill: window never closed: {rep}")
                time.sleep(0.2)
            drill["window_recovery_s"] = time.perf_counter() - t_w
            # the second replica back too, so the observer sees a whole fleet
            svcs[2] = SieveService(shard_cfg(dirs[2]), ServiceSettings(range_lo=E),
                                   addr=old[1]).start()
            drill["shard_down_windows"] = c.stats()["shard_down_windows"]
        out["drill"] = drill
        out["checked"] += len(load) + 8
        log("fabric", f"drill: a shard-1 replica stopped mid-burst -> 48 replies exact, "
                      f"{drill['failovers']} failovers | shard 1 down -> typed "
                      f"unavailable naming shard 1, pi(n) exact from cached totals | "
                      f"restart on the old address -> exact in "
                      f"{drill['recovery_s']:.3f} s | svc_shard_down on shard 0 -> typed, "
                      f"recovered in {drill['window_recovery_s']:.3f} s, no restart")

        # --- (3) the observer ---------------------------------------------
        obs_dir = root / "observe"
        targets = 1 + len(svcs)
        spec = ",".join(f"svc_scrape_gap:{i}@s3" for i in range(targets))
        obs = FleetObserver(router.addr, ObserverSettings(observe_dir=str(obs_dir),
                                                          quiet=True),
                            chaos=ChaosSchedule(parse_chaos(spec)))
        try:
            with ServiceClient(router.addr, timeout_s=120) as c:
                for k in range(5):
                    _expect("between scrapes", c.query("pi", x=E + off),
                            anchors.pi(E + off))
                    obs.scrape_once()
                    time.sleep(0.2)
            ostats = obs.stats()
        finally:
            obs.stop()
        rows = read_ring(str(obs_dir / RING_FILE))
        addrs = [router.addr] + [s.addr for s in svcs]
        if [r["scrape"] for r in rows] != [1, 2, 3, 4, 5]:
            raise AssertionError(f"observer: ring scrapes {[r['scrape'] for r in rows]}")
        for r in rows:
            if [t["addr"] for t in r["targets"]] != addrs or r["anomalies"]:
                raise AssertionError(f"observer: row {r['scrape']}: {r}")
            for t in r["targets"]:
                gap = r["scrape"] == 3
                if gap != (t["gap"] == "svc_scrape_gap") or gap == ("signals" in t) \
                        or (not gap and t["gap"] is not None) \
                        or (not gap and not set(ANOMALY_SIGNALS) <= set(t["signals"])):
                    raise AssertionError(f"observer: scrape {r['scrape']} target {t}")
        if ostats["gaps"] != targets or ostats["anomalies"] != 0:
            raise AssertionError(f"observer: stats {ostats}")
        out["observer"] = {"rows": len(rows), "targets": targets,
                           "gaps": ostats["gaps"], "anomalies": ostats["anomalies"]}
        log("fabric", f"observer: 5 scrapes of {targets} targets -> 5 ring rows, one "
                      f"gap row per target at scrape 3 (no sample), 0 anomalies")
    finally:
        if router is not None:
            router.stop()
        for s in svcs:
            s.stop()


def _spawn(cmd: list[str], root: Path, tag: str, env: dict):
    """``cmd`` started with its stdout and stderr in files under ``root``;
    returns (process, a callable that waits for its first JSON line)."""
    so, se = root / f"{tag}.out", root / f"{tag}.err"
    with open(so, "w") as fo, open(se, "w") as fe:
        proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, env=env,
                                stdout=fo, stderr=fe, text=True)
    t0 = time.perf_counter()

    def first_line(wait_s: float = 180) -> dict:
        while True:
            lines = so.read_text().splitlines()
            if lines:
                return json.loads(lines[0])
            if proc.poll() is not None or time.perf_counter() - t0 > wait_s:
                raise AssertionError(f"{tag}: no first line ({proc.poll()}): "
                                     f"{se.read_text()[-2000:]}")
            time.sleep(0.05)

    first_line.path = so
    return proc, first_line


def _fleet_tools(router: str, replicas: list[str], root: Path, env: dict) -> dict:
    """The fleet tools as processes against a live router: ``fleet_top
    --json`` (exit 0, a row per replica, every one up), ``fleet_top --once``
    (the table, a row per replica) and ``fleet_debug --out`` (exit 0, one
    bundle from the router and both replicas)."""
    def tool(name: str, *argv: str):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"sieve_torch.tools.{name}", router,
                               *argv], cwd=Path(__file__).resolve().parent, env=env,
                              capture_output=True, text=True, timeout=120)
        return proc, time.perf_counter() - t0

    out = {}
    top, out["top_json_s"] = tool("fleet_top", "--json")
    snap = json.loads(top.stdout) if top.returncode == 0 else {"shards": []}
    rows = [r for sh in snap["shards"] for r in sh["replicas"]]
    if top.returncode != 0 or sorted(r["addr"] for r in rows) != sorted(replicas) \
            or any(r["health"] is None for r in rows):
        raise AssertionError(f"fleet_top --json exited {top.returncode}: "
                             f"{top.stdout[-2000:]}{top.stderr[-2000:]}")
    once, out["top_once_s"] = tool("fleet_top", "--once")
    if once.returncode != 0 or "contiguous" not in once.stdout \
            or not all(a in once.stdout for a in replicas):
        raise AssertionError(f"fleet_top --once exited {once.returncode}: "
                             f"{once.stdout[-2000:]}{once.stderr[-2000:]}")
    for line in once.stdout.splitlines():
        log("fabric", "    fleet_top: " + line)
    dbg, out["debug_s"] = tool("fleet_debug", "--out", str(root / "fleet_debug"))
    path = root / "fleet_debug" / "fleet_bundle.json"
    bundle = json.loads(path.read_text()) if path.exists() else {"replicas": []}
    named = sorted(r["addr"] for r in bundle["replicas"] if r.get("bundle"))
    if dbg.returncode != 0 or bundle.get("processes") != 3 \
            or bundle["router"]["addr"] != router or named != sorted(replicas):
        raise AssertionError(f"fleet_debug exited {dbg.returncode}: "
                             f"{dbg.stdout[-2000:]}{dbg.stderr[-2000:]}")
    out["debug_processes"] = bundle["processes"]
    log("fabric", f"fleet tools against the live router: fleet_top --json exit 0, "
                  f"{len(rows)} replica rows up ({out['top_json_s']:.2f} s) | "
                  f"fleet_top --once exit 0 ({out['top_once_s']:.2f} s) | fleet_debug "
                  f"exit 0, a bundle of the router and {len(named)} replicas "
                  f"({out['debug_s']:.2f} s)")
    return out


def _fabric_cli(device: str, sizes: dict, root: Path, out: dict) -> None:
    """(4) ``serve`` x2, ``route`` and ``observe`` as processes over a
    ledger the card wrote: hot and cold queries through the router, the
    observer's scrapes, the fleet tools against the live router, a merged
    trace, and every process exits 0."""
    from sieve_torch.service import ServiceClient, ServiceSettings, read_ring
    from sieve_torch.service.observe import RING_FILE

    n, nseg, window = sizes["n"], sizes["segments"], sizes["cli_window"]
    on_card = device == "cuda"
    # serve has no --twins (the ledger's config hash includes it)
    out["ledger_launches"], cfg = _write_ledger(str(root / "src"), n, nseg, device,
                                                twins=False)
    dirs, E, _los = _split_ledger(cfg, root, shard1_copies=1)
    env = dict(os.environ, SIEVE_SVC_TELEMETRY="1")
    trace_file = root / "fleet_trace.json"
    py = [sys.executable, "-m", "sieve_torch"]
    procs = []
    try:
        t0 = time.perf_counter()
        heads = []
        for i, d in enumerate(dirs):  # both start at once
            cmd = py + ["serve", "--n", str(n), "--segments", str(nseg),
                        "--checkpoint-dir", d, "--addr", "127.0.0.1:0", "--quiet"]
            cmd += ["--range-lo", str(E)] if i else []
            cmd += [] if on_card else ["--device", device]
            proc, first_line = _spawn(cmd, root, f"serve{i}", env)
            procs.append(proc)
            heads.append(first_line)
        addrs = [first_line()["addr"] for first_line in heads]
        out["serve_start_s"] = time.perf_counter() - t0
        t_r = time.perf_counter()
        route, first_line = _spawn(
            py + ["route", "--addr", "127.0.0.1:0", "--quiet", "--trace", str(trace_file),
                  "--shard", f"2:{E}={addrs[0]}", "--shard", f"{E}:{n + 1}={addrs[1]}"],
            root, "route", env)
        procs.append(route)
        head = first_line()
        out["route_start_s"] = time.perf_counter() - t_r
        if head.get("event") != "routing" or head["range"] != [2, n + 1]:
            raise AssertionError(f"route: first line {head}")
        near_e = _window_primes(E, E + 2000)
        pi_e = _prime_pi(E - 1)
        lo, hi = n, n + window
        with ServiceClient(head["addr"], timeout_s=120) as c:
            hot = [c.query("pi", x=n), c.query("nth_prime", k=pi_e + 7),
                   c.query("is_prime", x=int(near_e[0]))]
            for what, r, want in zip(("pi(n)", "nth_prime", "is_prime"), hot,
                                     (PI[n], int(near_e[6]), True)):
                _expect(f"CLI {what}", r, want)
            cold = c.query("count", lo=lo, hi=hi)
            _expect(f"CLI count({lo}, {hi})", cold, _prime_pi(hi - 1) - PI[n])
            t_o = time.perf_counter()
            obs_dir = root / "observe_cli"
            observe = subprocess.run(
                py + ["observe", "--router", head["addr"], "--scrapes", "3", "--scrape-s",
                      "0.2", "--observe-dir", str(obs_dir), "--quiet"],
                cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
                text=True, timeout=120)
            out["observe_s"] = time.perf_counter() - t_o
            if observe.returncode != 0:
                raise AssertionError(f"observe exited {observe.returncode}: "
                                     f"{observe.stderr[-2000:]}")
            last = json.loads(observe.stdout.splitlines()[-1])
            rows = read_ring(str(obs_dir / RING_FILE))
            if last.get("event") != "observed" or last["scrapes"] != 3 or len(rows) != 3 \
                    or last["gaps"] != 0:
                raise AssertionError(f"observe: {last}, {len(rows)} ring rows")
            out["fleet_tools"] = _fleet_tools(head["addr"], addrs, root, env)
            shard_stats, launched = [], []
            for a in addrs:
                with ServiceClient(a, timeout_s=60) as s:
                    shard_stats.append(s.stats())
                    launched.append(s.metrics().get("kernel.mark_fused.launches",
                                                    {}).get("value", 0))
            c.shutdown()  # the router drains, flushes the rings, saves the trace
        rc = route.wait(timeout=60)
        drained = json.loads(first_line.path.read_text().splitlines()[-1])
        if rc != 0 or drained.get("event") != "drained" or not drained.get("clean"):
            raise AssertionError(f"route exited {rc}: {drained}")
        for a in addrs:
            with ServiceClient(a, timeout_s=60) as s:
                s.shutdown()
        rcs = [p.wait(timeout=60) for p in procs[:2]]
        if rcs != [0, 0]:
            raise AssertionError(f"serve exited {rcs}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    defaults = ServiceSettings()
    covered = n + 1
    chunks = []
    a = covered
    while a < hi:
        b = min((a // defaults.cold_chunk + 1) * defaults.cold_chunk, hi)
        chunks.append((a, b))
        a = b
    host = _host_chunks("odds", chunks)
    want = (len(chunks) - host) if on_card else 0
    if shard_stats[0]["cold_batched_chunks"] or launched[0] \
            or shard_stats[1]["cold_batched_chunks"] != len(chunks) or launched[1] != want:
        raise AssertionError(f"CLI: shard launches {launched}, chunks "
                             f"{[s['cold_batched_chunks'] for s in shard_stats]}, the "
                             f"grid gives {len(chunks)} ({host} on the host)")
    events = json.loads(trace_file.read_text())["traceEvents"]
    tracks = sorted(e["args"]["name"] for e in events
                    if e.get("ph") == "M" and e.get("name") == "process_name"
                    and str((e.get("args") or {}).get("name", "")).startswith("shard"))
    if len(tracks) != 2 or not any(e.get("name") == "rpc.route" for e in events):
        raise AssertionError(f"CLI: merged trace tracks {tracks}")
    out.update(E=E, launches=launched[1], chunks=len(chunks), host_chunks=host, checked=4,
               cold_count=cold["value"], trace_tracks=tracks, observe_rows=len(rows),
               ops=_percentiles([("pi", hot[0]), ("nth_prime", hot[1]),
                                 ("is_prime", hot[2]), ("count", cold)]))
    log("fabric", f"CLI: two serve processes up in {out['serve_start_s']:.3f} s, route "
                  f"in {out['route_start_s']:.3f} s | hot pi/nth_prime/is_prime exact | "
                  f"count({lo}, {hi}) = {cold['value']} on shard 1's {len(chunks)} "
                  f"chunks, {launched[1]} fused launches there, 0 on shard 0 | observe "
                  f"--scrapes 3 -> 3 ring rows in {out['observe_s']:.3f} s | merged "
                  f"trace tracks {tracks} | every process exited 0")


def phase_fabric(device="cuda", sizes=None) -> dict:
    """The serving fabric with its shard servers' cold chunks on the card:
    (1) shard 0 [2, E) and two shard-1 replicas [E, n + 1) behind one
    router in this process, under a concurrent burst across E held against
    exact oracles, and a cold window past the map on shard 1's fused
    kernel; (2) the failure drill; (3) a FleetObserver with scrape gaps;
    (4) ``serve``, ``route`` and ``observe`` as processes."""
    sizes = sizes or FABRIC_SIZES
    t0 = time.perf_counter()
    out = {"inproc": {}, "cli": {}}
    with tempfile.TemporaryDirectory(prefix="sieve_fabric_") as tmp:
        (Path(tmp) / "a").mkdir()
        (Path(tmp) / "b").mkdir()
        _fabric_inproc(device, sizes, Path(tmp) / "a", out["inproc"])
        _fabric_cli(device, sizes, Path(tmp) / "b", out["cli"])
    out["launches"] = (out["inproc"]["ledger_launches"]
                       + out["inproc"]["fabric"]["launches"]
                       + out["cli"]["ledger_launches"] + out["cli"]["launches"])
    out["checks"] = {"replies": out["inproc"].pop("checked") + out["cli"].pop("checked"),
                     "ring_rows": out["inproc"]["observer"]["rows"]
                     + out["cli"]["observe_rows"],
                     "processes_exited_0": 4}
    out["seconds"] = time.perf_counter() - t0
    return out


# --- the measurement plane ----------------------------------------------------

# the four profiled runs (n and its segments or rounds), then the tools'
# segments and runs, and the depth segment's bounds
PROFILE_SIZES = {"big": 10**10, "big_segments": 5, "stream": 10**11,
                 "stream_rounds": 64, "split": 10**10, "split_rounds": 8,
                 "words": 10**8, "kernel_span": 10**9, "rounds_n": 10**11,
                 "rounds": 64, "words_n": 10**8, "depth_lo": DEPTH_LO,
                 "depth_hi": DEPTH_HI}
# kernel names in the profiler's trace (demangled, template arguments and
# parameter lists after them)
KERNEL_NAMES = {"fused": re.compile(r"\bfused_mark_kernel\b"),
                "combine": re.compile(r"\bcombine_kernel\b"),
                "split": re.compile(r"\bsplit_mark_kernel\b")}
TOOL_TIMES = {"fused": re.compile(r"--> fused kernel time: +([\d.]+) ms"),
              "split": re.compile(r"--> split kernel time: +([\d.]+) ms"),
              "postlude": re.compile(r"--> postlude time: +([\d.]+) ms")}
SEG_TUPLE = re.compile(r"segment \(count, pairs, first, last\) = \((\d+), (\d+), "
                       r"(\d+), (\d+)\)")


def _profile_runs(sizes: dict) -> list[tuple]:
    """(tag, CLI argv, env, fused launches, split launches, word calls,
    pi, pairs) of the four profiled runs."""
    s = sizes
    return [
        ("D1", ["--n", str(s["big"]), "--packing", "odds", "--twins", "--backend",
                "cuda", "--segments", str(s["big_segments"])], {},
         s["big_segments"], 0, 0, PI[s["big"]], TWINS[s["big"]]),
        ("D2", ["--n", str(s["stream"]), "--packing", "odds", "--twins", "--backend",
                "cuda", "--rounds", str(s["stream_rounds"])], {},
         s["stream_rounds"], 0, 0, PI[s["stream"]], TWINS[s["stream"]]),
        ("D3", ["--n", str(s["split"]), "--rounds", str(s["split_rounds"]),
                "--backend", "cuda"], {"SIEVE_PALLAS_FUSED": "0"},
         0, s["split_rounds"], 0, PI[s["split"]], None),
        ("D4", ["--backend", "torch", "--n", str(s["words"]), "--twins"], {},
         0, 0, 1, PI[s["words"]], TWINS_BELOW[s["words"]]),
    ]


def _kernel_events(d: Path) -> tuple[dict, dict, int]:
    """The one Chrome trace torch.profiler wrote into ``d``: its kernel
    events counted and their durations summed (us) by KERNEL_NAMES, and
    the number of all kernel events."""
    files = sorted(d.glob("*.pt.trace.json*"))
    if len(files) != 1:
        raise AssertionError(f"{d}: {len(files)} profiler traces, expected 1")
    opener = gzip.open if files[0].suffix == ".gz" else open
    with opener(files[0], "rt") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    counts = {k: 0 for k in KERNEL_NAMES}
    dur = {k: 0.0 for k in KERNEL_NAMES}
    for e in kernels:
        for k, pat in KERNEL_NAMES.items():
            if pat.search(e.get("name", "")):
                counts[k] += 1
                dur[k] += float(e.get("dur", 0.0))
    return counts, dur, len(kernels)


def _profiled_runs(device: str, sizes: dict, tmp: Path, times: dict | None) -> dict:
    """(1) ``--profile-dir`` on the card: each run through the CLI with its
    counts set to 0 just before and read just after, its result held
    against the oracles, and its trace's kernel events against the
    wrappers' launch counts."""
    out = {}
    on_card = device == "cuda"
    for tag, argv, env, fused, split, words, pi, twins in _profile_runs(sizes):
        d = tmp / tag
        with env_set(env):
            mark_fused.launches = mark_split.launches = 0
            word_mark.mark_words.cuda_calls = 0
            got, wall = run_cli(argv + ["--device", device, "--profile-dir", str(d)])
            launched = {"fused": mark_fused.launches, "split": mark_split.launches,
                        "words": word_mark.mark_words.cuda_calls}
        want = {"fused": fused, "split": split, "words": words} if on_card else {
            "fused": 0, "split": 0, "words": 0}
        if launched != want:
            raise AssertionError(f"{tag} {argv}: launches {launched}, expected {want}")
        if got["pi"] != pi or (twins is not None and got["twin_pairs"] != twins):
            raise AssertionError(f"{tag} {argv}: pi {got['pi']} pairs "
                                 f"{got['twin_pairs']}; expected {pi}, {twins}")
        counts, dur, n_kernels = _kernel_events(d)
        want_events = {"fused": launched["fused"], "combine": launched["fused"],
                       "split": launched["split"]}
        if counts != want_events:
            raise AssertionError(f"{tag}: kernel events in the trace {counts}, "
                                 f"expected {want_events} (the wrappers' counts)")
        if on_card and words and n_kernels == 0:
            raise AssertionError(f"{tag}: the trace holds no kernel of the word path")
        mean = {k: dur[k] / counts[k] / 1e3 for k in dur if counts[k]}
        out[tag] = {"argv": " ".join(argv), "wall_s": wall, "elapsed_s": got["elapsed_s"],
                    "launches": launched, "kernel_events": counts,
                    "kernel_events_all": n_kernels,
                    "kernel_ms_sum": {k: v / 1e3 for k, v in dur.items()},
                    "kernel_ms_mean": mean}
        line = (f"{tag}: sieve_torch {' '.join(argv)} --profile-dir: pi {got['pi']} "
                f"pairs {got['twin_pairs']} | run {got['elapsed_s']:.4f} s (wall "
                f"{wall:.4f} s) | launches {launched} | trace: {n_kernels} kernel "
                f"events, {counts}, summed ms "
                f"{ {k: round(v / 1e3, 4) for k, v in dur.items()} }")
        log("profile", line + (f" (env {env})" if env else ""))
    if times is not None:
        # the same kernel on the same shape: the profiler's mean against the
        # CUDA-event median of phase times
        ev = times["n=1e11 middle round"]["counting"]["ms"]
        prof = out["D2"]["kernel_ms_mean"]["fused"]
        out["D2"]["cuda_event_ms"] = ev
        out["D2"]["profiler_over_events"] = prof / ev
        log("profile", f"D2 fused kernel: profiler mean {prof:.4f} ms a launch "
                       f"(+ combine {out['D2']['kernel_ms_mean']['combine']:.4f} ms) "
                       f"against {ev:.4f} ms by CUDA events on the n=1e11 middle "
                       f"round (phase times): {prof / ev:.3f}x")
    return out


def _run_tool(name: str, argv: list[str]) -> tuple[str, float]:
    """``python -m sieve_torch.tools.<name> <argv>`` in this process: its
    stdout and seconds; a tool that does not exit 0 fails the phase."""
    import importlib

    mod = importlib.import_module(f"sieve_torch.tools.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    sec = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{name} {' '.join(argv)} exited {rc}:\n{buf.getvalue()}")
    return buf.getvalue(), sec


def _tools(device: str, sizes: dict, tmp: Path) -> dict:
    """(2) every ported tool on the card, each exiting 0; profile_kernel
    also as a ``python -m`` process. The counts the two microbench runs
    print are held against pi (the odds segments from 2 leave out the
    prime 2), and mesh_cold_smoke must print its OK line. Returns each
    run's seconds and the times it printed, by its command line."""
    dev = ["--device", device]
    span = str(sizes["kernel_span"])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sieve_torch.tools.profile_kernel",
                           span, *dev], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"python -m sieve_torch.tools.profile_kernel exited "
                           f"{proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    texts = {f"profile_kernel {span} (process)": (proc.stdout, time.perf_counter() - t0)}
    trace_out = tmp / "rounds.trace.json"
    for name, argv in (
            ("profile_kernel", [span, str(sizes["depth_lo"])] + dev),
            ("profile_rtt", [span] + dev),
            ("profile_breakdown", [span] + dev),
            ("profile_rounds", [str(sizes["rounds_n"]), str(sizes["rounds"]),
                                "--twins", "--trace-out", str(trace_out)] + dev),
            ("trace_report", [str(trace_out)]),
            ("profile_prepare", []),
            ("microbench", [str(sizes["words_n"])] + dev),
            ("microbench", [span, "--cuda"] + dev),
            ("mesh_cold_smoke", dev)):
        texts[" ".join([name, *argv]).replace(str(trace_out), trace_out.name)] = \
            _run_tool(name, argv)
    out = {}
    for key, (text, sec) in texts.items():
        out[key] = {"seconds": sec}
        for k, pat in TOOL_TIMES.items():
            m = pat.search(text)
            if m:
                out[key][f"{k}_ms"] = float(m.group(1))
        log("profile", f"tool {key}: exit 0 in {sec:.2f} s")
        for line in text.rstrip().splitlines():
            log("profile", "    " + line)
    for key, n in ((f"microbench {sizes['words_n']} --device {device}", sizes["words_n"]),
                   (f"microbench {span} --cuda --device {device}", sizes["kernel_span"])):
        count = int(SEG_TUPLE.search(texts[key][0]).group(1))
        if count + 1 != PI[n]:
            raise AssertionError(f"{key}: count {count} + 1 != pi({n}) = {PI[n]}")
    if "MESH_COLD_SMOKE_OK" not in texts[f"mesh_cold_smoke --device {device}"][0]:
        raise AssertionError("mesh_cold_smoke did not print MESH_COLD_SMOKE_OK")
    return out


def _depth_oracle(device: str, sizes: dict) -> dict:
    """(3) the fused kernel's count on the depth segment against
    pi(hi - 1) - pi(lo - 1): the published pi(10^12) and Lucy's pi on the
    host for the lower end (phase kernel holds both kernels against their
    plain versions there)."""
    lo, hi = sizes["depth_lo"], sizes["depth_hi"]
    t0 = time.perf_counter()
    lower = _prime_pi(lo - 1)
    lucy_s = time.perf_counter() - t0
    upper = PI_1E12 if hi - 1 == 10**12 else _prime_pi(hi - 1)
    seg = _segment("odds", lo, hi, None, 2)
    count = mark_fused(seg, pairs.TWIN_NONE, device=device)[0]
    count += get_layout("odds").extras_in(lo, hi)
    want = upper - lower
    log("profile", f"depth segment [{lo}, {hi}): fused kernel count {count}, "
                   f"oracle pi({hi - 1}) - pi({lo - 1}) = {upper} - {lower} = {want} "
                   f"(Lucy's pi on the host in {lucy_s:.2f} s)")
    if count != want:
        raise AssertionError(f"depth segment: count {count} != oracle {want}")
    return {"count": count, "oracle": want, "lucy_s": lucy_s}


def phase_profile(device="cuda", sizes=None, times: dict | None = None,
                  stream_unprofiled_s: float | None = None) -> dict:
    """The measurement plane: (1) four ``--profile-dir`` runs, their traces'
    kernel events equal to the wrappers' launches; (2) every ported tool;
    (3) the depth segment against an independent oracle."""
    sizes = sizes or PROFILE_SIZES
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="sieve_profile_") as tmp:
        runs = _profiled_runs(device, sizes, Path(tmp), times)
        if stream_unprofiled_s is not None:
            d2 = runs["D2"]
            log("profile", f"D2 under the profiler {d2['elapsed_s']:.4f} s, without "
                           f"it {stream_unprofiled_s:.4f} s (phase rounds); not a "
                           "result: the profiler's own cost")
            d2["unprofiled_s"] = stream_unprofiled_s
        mark_fused.launches = mark_split.launches = 0
        tools = _tools(device, sizes, Path(tmp))
        tool_launches = {"fused": mark_fused.launches, "split": mark_split.launches}
    depth = _depth_oracle(device, sizes)
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("fused", "split", "words")}
    return {"runs": runs, "launches": launches, "tools": tools,
            "tool_launches": tool_launches, "depth": depth,
            "seconds": time.perf_counter() - t0}


GATE_SMOKES = {"service_smoke": "SERVICE_SMOKE_OK", "chaos_smoke": "CHAOS_SMOKE_OK",
               "store_smoke": "STORE_SMOKE_OK"}
GATE_CHECKS = ("wire_ops", "event_schema", "concurrency", "env_vars")
WIRE_SEGMENTS = 2  # check_wire_ops' live ledger: n=2,000 in 2 segments
LOCK_OK = re.compile(r"^lock debug OK: (\d+) observed acquisition orders", re.M)
LOCK_PAIRS = re.compile(r"^lock debug pairs: (.*)$", re.M)
SMOKE_LAUNCHES = re.compile(r"^device: .*; fused launches [^:]*: (\d+)$", re.M)


def _gate_checks(device: str) -> dict:
    """(1) ``check_all --device <device>`` in this process: exit 0, one
    ``ok`` line per check, and the wire check's live ledger sieved with one
    fused launch per segment on the card (its 13 probes and the batch are
    byte-identical under v1 and v2, or the check fails)."""
    from sieve_torch.tools import check_all

    buf = io.StringIO()
    mark_fused.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = check_all.main(["--device", device])
    sec = time.perf_counter() - t0
    launches = mark_fused.launches
    text = buf.getvalue()
    for line in text.rstrip().splitlines():
        log("gates", "    " + line)
    ok = [c for c in GATE_CHECKS if f"check_all: {c}: ok" in text.splitlines()]
    if rc != 0 or len(ok) != len(GATE_CHECKS):
        raise AssertionError(f"check_all --device {device} exited {rc}; ok: {ok}")
    want = WIRE_SEGMENTS if device == "cuda" else 0
    if launches != want:
        raise AssertionError(f"check_all: {launches} fused launches for the wire "
                             f"check's {WIRE_SEGMENTS} ledger segments (want {want})")
    log("gates", f"check_all --device {device}: exit 0, {len(ok)} checks ok, "
                 f"{launches} fused launches, {sec:.2f} s")
    return {"seconds": sec, "checks_ok": len(ok), "launches": launches}


def _run_smoke(phase: str, name: str, banner: str, device: str, env: dict):
    """``python -m sieve_torch.tools.<name> --device <device>`` as a process
    of its own: exit 0 with ``banner``; returns its stdout, seconds and the
    fused launches it printed."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"sieve_torch.tools.{name}",
                           "--device", device], env=env,
                          cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=600)
    sec = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if not ln.startswith("{")]
    for line in lines:
        log(phase, f"    {name}: {line}")
    launches = SMOKE_LAUNCHES.search(proc.stdout)
    if proc.returncode != 0 or banner not in lines or not launches:
        raise RuntimeError(f"{name} --device {device} exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, sec, int(launches.group(1))


def _gate_smoke(name: str, device: str) -> dict:
    """(2) ``python -m sieve_torch.tools.<name> --device <device>`` under
    SIEVE_LOCK_DEBUG=1 (read once at import, so a process of its own):
    exit 0 and its banner, K > 0 observed lock orders consistent with the
    canonical order, and the fused launches it printed."""
    stdout, sec, launches = _run_smoke("gates", name, GATE_SMOKES[name], device,
                                       {**os.environ, "SIEVE_LOCK_DEBUG": "1"})
    k = LOCK_OK.search(stdout)
    pairs = LOCK_PAIRS.search(stdout)
    if not (k and pairs) or int(k.group(1)) < 1:
        raise AssertionError(f"{name}: no observed lock orders")
    out = {"seconds": sec, "orders": int(k.group(1)),
           "pairs": json.loads(pairs.group(1)), "launches": launches}
    log("gates", f"{name}: exit 0 in {sec:.2f} s, {out['orders']} observed lock "
                 f"orders consistent with the canonical order, {out['launches']} "
                 "fused launches")
    return out


def phase_gates(device="cuda") -> dict:
    """The concurrency and discipline gates on the card: ``check_all`` in
    process (the wire check's live ledger on the fused kernel), then the
    service, chaos and store smokes as processes under SIEVE_LOCK_DEBUG=1:
    the service smoke's cold plane and the chaos smoke's cluster workers
    launch the fused kernel, the service smoke's observed orders include
    ``build._lock`` taken under ``ColdBackend._lock``, and the store
    smoke's ``serve --procs 3`` puts three CUDA contexts on the card."""
    t0 = time.perf_counter()
    out = {"check_all": _gate_checks(device)}
    for name in GATE_SMOKES:
        out[name] = _gate_smoke(name, device)
    if device == "cuda":
        for name in ("service_smoke", "chaos_smoke"):
            if out[name]["launches"] < 1:
                raise AssertionError(f"{name}: no fused launch on the card")
        inner = {b for _, b in out["service_smoke"]["pairs"]}
        if "build._lock" not in inner:
            raise AssertionError("service_smoke: no observed order takes build._lock "
                                 f"inside another lock ({sorted(inner)})")
    out["launches"] = out["check_all"]["launches"] + sum(
        out[name]["launches"] for name in GATE_SMOKES)
    out["seconds"] = time.perf_counter() - t0
    return out


FLEET_SMOKES = {"shard_smoke": "SHARD_SMOKE_OK", "observe_smoke": "OBSERVE_SMOKE_OK",
                "profile_smoke": "PROFILE_SMOKE_OK", "failover_smoke": "FAILOVER_SMOKE_OK"}
FLEET_SIZES = {"tune_span": 10**9, "n": 10**10, "segments": 5}
DRYRUN_LINE = re.compile(r"^dryrun_multichip: (\{.*\})$", re.M)


def _fleet_autotune(device: str, sizes: dict, tmp: Path) -> dict:
    """(2) ``autotune_kernel`` with SIEVE_TUNED_JSON set to a file of its
    own: every trial (a fresh interpreter, CUDA events around the warm
    ``mark_fused``) gives the baseline's result, and the file holds the
    chosen knobs; then a fresh ``python -m sieve_torch --n 1e10 --twins``
    (in the counting run's 5 segments, a ``--cli`` process of this script)
    loads that file, must be exact and must have launched the fused kernel
    once per device segment."""
    tuned = tmp / "tuned_cuda.json"
    env = {**os.environ, "SIEVE_TUNED_JSON": str(tuned)}
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sieve_torch.tools.autotune_kernel",
                           str(sizes["tune_span"]), "--device", device],
                          env=env, cwd=root, capture_output=True, text=True, timeout=900)
    sweep_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log("fleet", "    autotune_kernel: " + line)
    if proc.returncode != 0 or not tuned.exists():
        raise RuntimeError(f"autotune_kernel exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    doc = json.loads(tuned.read_text())
    meta = doc.pop("_meta")
    rejected = [t for t in meta["trials"] if t["ms"] is None]
    if rejected or "FAILED" in proc.stderr or len(meta["trials"]) != 6:
        raise AssertionError(f"autotune_kernel: trials {meta['trials']}; "
                             f"{proc.stderr[-2000:]}")
    n = sizes["n"]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--cli",
                          "--n", str(n), "--twins", "--segments", str(sizes["segments"]),
                          "--device", device, "--json", "--quiet"],
                         env=env, cwd=root, capture_output=True, text=True, timeout=600)
    run_s = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"the tuned n={n} run exited {run.returncode}: "
                           f"{run.stderr[-4000:]}")
    child = json.loads(run.stdout.splitlines()[-1])
    res = json.loads(child["out"].splitlines()[-1])
    if (res["pi"], res["twin_pairs"]) != (PI[n], TWINS[n]):
        raise AssertionError(f"tuned n={n}: pi, twins = {res['pi']}, "
                             f"{res['twin_pairs']}; want {PI[n]}, {TWINS[n]}")
    # the launches the child counted, against its segment plan
    launches = child["fused"]
    want = (_device_segments(n, res["packing"], res["n_segments"])
            if device == "cuda" else 0)
    if (launches, child["split"]) != (want, 0):
        raise AssertionError(f"tuned n={n}: launches (fused, split) = "
                             f"{(launches, child['split'])}, expected {(want, 0)}")
    log("fleet", f"autotune_kernel --device {device} span {sizes['tune_span']:.0e}: "
                 f"{len(meta['trials'])} trials in {sweep_s:.1f} s, chose {doc} "
                 f"({meta['best_ms']} ms); a fresh --n {n:.0e} --twins with that file: "
                 f"pi {res['pi']}, twins {res['twin_pairs']} exact in {run_s:.1f} s, "
                 f"{launches} fused launches")
    return {"seconds": sweep_s, "knobs": doc, "best_ms": meta["best_ms"],
            "trials": meta["trials"], "device": meta["device"],
            "run": {"seconds": run_s, "elapsed_s": res["elapsed_s"],
                    "launches": launches}}


def _fleet_graft(device: str) -> dict:
    """(3) ``python -m sieve_torch.graft_entry``: the word kernel's entry on
    the n=1e6 segment, then the dry run on one shard per card, which makes
    the reference's checks itself."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "sieve_torch.graft_entry",
                           "--device", device], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=600)
    sec = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log("fleet", "    graft_entry: " + line)
    found = DRYRUN_LINE.findall(proc.stdout)
    if proc.returncode != 0 or "dryrun_multichip ok" not in proc.stdout or not found:
        raise RuntimeError(f"graft_entry exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    summary = json.loads(found[-1])
    if device == "cuda" and not (summary["launches"]["fused"] > 0
                                 and summary["launches"]["split"] > 0):
        raise AssertionError(f"graft_entry: launches {summary['launches']}")
    return {"seconds": sec, **summary}


def phase_fleet(device="cuda", sizes=None) -> dict:
    """The fleet, the tuner and the graft entry on the card: (1) the
    shard, observe, profile and failover smokes as ``python -m`` processes,
    each exiting 0 with its banner, its ``serve`` children on ``--backend
    cuda``; (2) the autotuner's sweep into a tuned file of its own, and an
    exact n=1e10 run that loads it; (3) ``python -m
    sieve_torch.graft_entry``."""
    sizes = sizes or FLEET_SIZES
    t0 = time.perf_counter()
    out = {}
    for name, banner in FLEET_SMOKES.items():
        _stdout, sec, launches = _run_smoke("fleet", name, banner, device,
                                            dict(os.environ))
        if device == "cuda" and launches < 1:
            raise AssertionError(f"{name}: no fused launch on the card")
        out[name] = {"seconds": sec, "launches": launches}
        log("fleet", f"{name}: exit 0 in {sec:.2f} s, {launches} fused launches")
    with tempfile.TemporaryDirectory(prefix="sieve_fleet_") as tmp:
        out["autotune"] = _fleet_autotune(device, sizes, Path(tmp))
    out["graft_entry"] = _fleet_graft(device)
    out["launches"] = (sum(out[name]["launches"] for name in FLEET_SMOKES)
                       + out["autotune"]["run"]["launches"]
                       + out["graft_entry"]["launches"]["fused"])
    out["split_launches"] = out["graft_entry"]["launches"]["split"]
    out["seconds"] = time.perf_counter() - t0
    return out


# the 18 lines ``python -m sieve_torch.bench`` prints, each exactly once
BENCH_METRICS = (
    "sieve_throughput_pi_1e9_odds_cuda", "sieve_throughput_depth_1e12_odds_cuda",
    "host_prepare_throughput_odds_cuda", "fused_reduction_hbm_traffic_ratio",
    "service_query_latency_p95_ms", "service_hot_qps", "service_pipeline_qps",
    "service_hot_qps_binary", "service_wire_bytes_per_member",
    "service_hot_qps_scaling", "service_hot_under_flood_ms_p95",
    "router_query_latency_p95_ms", "service_trace_overhead_ratio",
    "service_recorder_overhead_ratio", "service_profiler_overhead_ratio",
    "service_lock_debug_overhead_ratio", "service_observer_overhead_ratio",
    "service_cold_drain_throughput",
)
# the bench process's own launches, counted from its code: the fused kernel
# twice on line 1 (a warm and a timed n=1e9 run, one segment each), four
# times on line 2 (the depth segment's first run and three timed reruns)
# and once on line 4; the split kernel once (line 4's parity); the word
# kernel once per round of line 3's n=3e7 run in 6 rounds. The service
# lines sieve on the host (cpu-numpy ledgers), and line 9's smoke is a
# process of its own that counts its batched launch itself.
BENCH_LAUNCHES = {"fused": 7, "split": 1, "words": 6, "words_batch": 0}


def bench_child() -> int:
    """``chip_smoke.py --bench``: ``sieve_torch.bench.main`` on the card in
    this process, then one JSON line with its exit code and this process's
    kernel launches."""
    from sieve_torch import bench

    mark_fused.launches = mark_split.launches = 0
    _reset_calls()
    rc = bench.main(["--device", "cuda"])
    print(json.dumps({"rc": rc, "fused": mark_fused.launches,
                      "split": mark_split.launches,
                      "words": word_mark.mark_words.cuda_calls,
                      "words_batch": word_mark.mark_words_batch.cuda_calls}),
          flush=True)
    return rc


def phase_bench() -> dict:
    """``python -m sieve_torch.bench`` on the card in a fresh process of
    this script (``chip_smoke.py --bench``): exit 0, each of the 18 metric
    lines exactly once (every parity assert of the bench passed), the
    process's own launches exactly ``BENCH_LAUNCHES``, and the cold drain
    one batched launch; then the lines through the port's bench_compare
    against an empty previous round, whose absolute budgets are printed
    (a tripped budget is a finding, not a failure: this round sets no
    speed target)."""
    from sieve_torch.tools.bench_compare import compare, extract_metrics

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--bench"],
                          cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=900)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"sieve_torch.bench exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    docs = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    counts, lines = docs[-1], [d for d in docs[:-1] if "metric" in d]
    names = [d["metric"] for d in lines]
    if sorted(names) != sorted(BENCH_METRICS) or len(lines) != len(docs) - 1:
        raise AssertionError(f"bench lines {names}, want each of {BENCH_METRICS} once")
    for d in lines:
        log("bench", "    " + json.dumps(d))
    got = {k: counts[k] for k in BENCH_LAUNCHES}
    if got != BENCH_LAUNCHES:
        raise AssertionError(f"bench launches {got}, expected {BENCH_LAUNCHES}")
    by_name = {d["metric"]: d for d in lines}
    drain = by_name["service_cold_drain_throughput"]
    if (drain["spmd_launches"], drain["device"]) != (1, "cuda"):
        raise AssertionError(f"cold drain: {drain}")
    report, budgets = compare({}, extract_metrics({"tail": proc.stdout}), 0.10)
    for line in report:
        log("bench", "bench_compare:" + line)
    for b in budgets:
        log("bench", f"bench_compare: budget tripped: {b}")
    log("bench", f"python -m sieve_torch.bench: exit 0 in {sec:.1f} s, 18 lines; "
                 f"launches {got} (as counted from its code)")
    return {"seconds": sec, "launches": got, "budgets_tripped": budgets,
            "values": {k: by_name[k]["value"] for k in BENCH_METRICS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, action="append", default=[],
                    help="a checkout of another commit, or a variant of these "
                         "sources, whose kernels are timed in turns with these "
                         "in the group phase (repeatable)")
    args = ap.parse_args(argv)
    dev = phase_device()
    t_start = time.perf_counter()
    spent = {}

    def timed(name, fn, *a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        spent[name] = time.perf_counter() - t0
        log("time", f"phase {name}: {spent[name]:.1f} s (script "
                    f"{time.perf_counter() - t_start:.1f} s)")
        return out

    timed("build", phase_build)
    others = {}
    for root in args.other:
        src = root / "sieve_torch" / "kernels" / "csrc" / "fused_mark.cu"
        info = build.build(force=True, source=src.resolve())
        others[root.resolve().name] = build.bind(info["path"])
        log("build", f"{root.resolve().name}: {src}: nvcc {info['seconds']:.1f} s")
    log("build", f"done in {time.perf_counter() - t_start:.1f} s")
    worst, worst_split, n_checked = timed("kernel", phase_kernel_vs_plain)
    log("kernel", f"bit-exact on {n_checked} (segment, kind) pairs, max abs err "
                  f"fused {worst}, split {worst_split} (tolerance 0: the "
                  "arithmetic is integer)")
    launches, expected, numpy_runs = timed("main", phase_main_path)
    log("launches", f"mark_fused launched {launches} times for {expected} "
                    "device segments over the counting runs")
    rounds = timed("rounds", phase_rounds, numpy_runs=numpy_runs)
    log("launches", f"rounds path: mark_fused {rounds['launches']['fused']}, "
                    f"mark_split {rounds['launches']['split']} launches, one per "
                    "device segment of each mode")
    all_times = timed("times", phase_times, dev)
    times = all_times["n=1e9 odds segment"]
    timed("groups", phase_groups, dev, others)
    words = timed("words", phase_words, dev, numpy_runs)
    log("words", f"torch backend == cuda backend on {words['checked']} (segment, "
                 f"kind) pairs; word-kernel calls on the card: {words['main_calls']} "
                 f"(counting runs) + {words['rounds_calls']} (rounds), one per "
                 f"device segment; {words['batched_calls']} batched")
    cluster = timed("cluster", phase_cluster)
    multihost = timed("multihost", phase_multihost, cluster["local_segments"])
    log("launches", f"distributed planes: mark_fused {cluster['launches']} on the "
                    f"cluster's workers, {multihost['launches']} on the ranks")
    service = timed("service", phase_service)
    log("launches", f"service: mark_fused {service['launches']} in the counting run "
                    "that wrote the served ledger")
    serve = timed("serve", phase_serve)
    log("launches", f"serve: mark_fused {serve['launches']} (the loop plane's cold "
                    "chunks, the CLI ledger's counting run and the CLI server's "
                    "cold window)")
    fabric = timed("fabric", phase_fabric)
    log("launches", f"fabric: mark_fused {fabric['launches']} (the two ledgers' "
                    "counting runs and shard 1's cold chunks, in process and in "
                    "the serve process)")
    profile = timed("profile", phase_profile, times=all_times,
                    stream_unprofiled_s=rounds["stream"]["elapsed_s"])
    log("launches", f"profile: mark_fused {profile['launches']['fused']}, mark_split "
                    f"{profile['launches']['split']} in the four --profile-dir runs "
                    f"(the tools launched {profile['tool_launches']} more in this "
                    "process, measurement launches)")
    gates = timed("gates", phase_gates)
    log("launches", f"gates: mark_fused {gates['launches']} (the wire check's "
                    f"ledger {gates['check_all']['launches']}, the service smoke "
                    f"{gates['service_smoke']['launches']}, the chaos smoke's workers "
                    f"{gates['chaos_smoke']['launches']}, the store smoke "
                    f"{gates['store_smoke']['launches']})")
    fleet = timed("fleet", phase_fleet)
    log("launches", f"fleet: mark_fused {fleet['launches']} (the smokes "
                    + ", ".join(f"{k} {fleet[k]['launches']}" for k in FLEET_SMOKES)
                    + f"; the tuned n=1e10 run {fleet['autotune']['run']['launches']}; "
                    f"the graft dry run {fleet['graft_entry']['launches']['fused']}), "
                    f"mark_split {fleet['split_launches']} (the graft dry run's parity "
                    "run); the sweep's trials are measurement launches")
    bench = timed("bench", phase_bench)
    log("launches", f"bench: mark_fused {bench['launches']['fused']}, mark_split "
                    f"{bench['launches']['split']}, mark_words "
                    f"{bench['launches']['words']} in the bench process")
    log("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s: "
                + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    wt = words["times"]
    print("[words] " + json.dumps({
        "name": "mark_words", "route": "torch ops",
        "source": "sieve_torch/kernels/word_mark.py",
        "counterpart": "sieve/kernels/jax_mark.py:204 (XLA, not Pallas)",
        "calls": words["main_calls"] + words["rounds_calls"],
        "checked": words["checked"],
        **{shape: {k: v for k, v in t.items()} for shape, t in wt.items()},
        "postlude": {"ms": times["split"]["postlude_ms"],
                     "pass_bytes": times["split"]["postlude_pass_bytes"]},
    }))
    print("[cluster] " + json.dumps(
        {"launches": cluster["launches"], **cluster["runs"]}))
    print("[multihost] " + json.dumps(multihost))
    print("[service] " + json.dumps(service))
    print("[serve] " + json.dumps(serve))
    print("[fabric] " + json.dumps(fabric))
    print("[profile] " + json.dumps(profile))
    print("[gates] " + json.dumps(gates))
    print("[fleet] " + json.dumps(fleet))
    print("[bench] " + json.dumps(bench))
    kernels = [{
        "name": "fused_mark",
        "route": "cuda",
        "source": "sieve_torch/kernels/csrc/fused_mark.cu",
        "replaces": "sieve/kernels/pallas_mark.py:694",
        "launches": (launches + rounds["launches"]["fused"] + cluster["launches"]
                     + multihost["launches"] + service["launches"]
                     + serve["launches"] + fabric["launches"]
                     + profile["launches"]["fused"] + gates["launches"]
                     + fleet["launches"] + bench["launches"]["fused"]),
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
        "launches": (rounds["launches"]["split"] + profile["launches"]["split"]
                     + fleet["split_launches"] + bench["launches"]["split"]),
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
    if sys.argv[1:2] == ["--cli"]:
        sys.exit(cli_main(sys.argv[2:]))
    if sys.argv[1:] == ["--bench"]:
        sys.exit(bench_child())
    sys.exit(main())
