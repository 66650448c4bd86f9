"""The port's benchmark: 18 metric lines from the card.

It times the counting path on the fused kernel at the shallow and the
depth regime, the host-prepare chain, the fused reduction's traffic
model, the query service, the router fabric, the observability planes'
overheads, and the mesh cold drain.

    python -m sieve_torch.bench [--device cuda|cpu]

The port of the reference's bench.py. It prints 18 JSON lines, each
``{"metric", "value", "unit", ...}`` with the reference's keys, on
stdout; the nine items below name them (items 1 and 5 print several):

1. ``sieve_throughput_pi_1e9_odds_cuda``: pi(1e9), odds packing, the
   ``cuda`` backend (one fused launch per run), a warm run then a timed
   one, each asserted exact. vs_baseline is over BASELINE.md's CPU floor:
   pi(1e9) by segmented numpy in 7.5 s in one process, 1.33e8 values/s.
2. ``sieve_throughput_depth_1e12_odds_cuda``: warm values/s on ONE
   10^9-span odds segment at lo = 10^12 - 10^9 with the full 78,498-seed
   set (609 group-D rows), the regime the north star (pi(10^12) in under
   60 s) lives in. The ``CudaWorker`` result is held field by field
   against the port's ``CpuNumpyWorker`` on the same segment, and that
   numpy run is timed: vs_baseline is the speedup of the best of three
   warm device runs over it, both from this process. On ``--device cpu``
   the line is skipped (a note on stderr) unless SIEVE_BENCH_DEPTH=1; on
   ``--device cuda`` it always runs, and without a card it raises.
3. ``host_prepare_throughput_odds_cuda``: steady-state ``CudaChain``
   values/s over depth-regime segments with the full seed set;
   vs_baseline = speedup over from-scratch ``prepare_cuda`` of the same
   segments. The line carries overlap_efficiency and device_idle_frac of
   a streamed ``run_mesh`` round loop on the ``torch`` backend (the word
   kernel), asserted exact.
4. ``fused_reduction_hbm_traffic_ratio``: the fused path's device bytes
   for one segment as a fraction of the split path's, counted from the
   port's own buffers for [2,000,003, 24,000,001): both paths read the
   kernel's tables and lists (the arrays of ``cuda_mark._KERNEL_ARRAYS``
   but the two per-tile cursor arrays); split = those + the Wpad-word
   bitset written by the split kernel and read again by its postlude;
   fused = those + the cursors (``tile_offsets`` of the correction and
   flat lists) + each block's 32-byte partial, written and read again by
   the combine + the 16-byte result. Gated on ``mark_fused`` == the
   split kernel + ``split_reduce`` on that segment. vs_baseline =
   0.55 / ratio, the reference's target ratio.
5. The service plane, each reply asserted exact against a host oracle:
   ``service_query_latency_p95_ms`` (p95 of the ``rpc.query`` spans of a
   mixed hot/cold workload against an in-process ``SieveService``); the
   wire plane's ``service_hot_qps``, ``service_pipeline_qps``,
   ``service_hot_qps_binary`` and ``service_wire_bytes_per_member``;
   ``service_hot_qps_scaling`` (``python -m sieve_torch serve --procs 1,
   2, 4 --backend cpu-numpy`` on one port: q4 / (4 q1), with ``cpus``);
   ``service_hot_under_flood_ms_p95`` (hot-lane p95 while 20 threads
   flood the cold lane).
6. ``router_query_latency_p95_ms``: p95 of the ``rpc.route`` spans of a
   mixed workload against a two-shard in-process fabric, edge splices
   included.
7-8. The overhead ratios, ``service_{trace,recorder,profiler,lock_debug,
   observer}_overhead_ratio``: client-side p95 of the line-5 mixed
   workload with the plane on over the same with it off, passes
   interleaved (off, on, ...) on a fresh service each, after an untimed
   warmup, the minimum p95 across reps per mode. The lock-debug "on"
   pass must have recorded lock orders, which must agree with the
   canonical order.
9. ``service_cold_drain_throughput``: ``python -m
   sieve_torch.tools.mesh_cold_smoke --device <device>`` as a child
   process, whose line (mesh over loop drain on the word kernel, over
   the cards torch sees) is printed as it is. A failed smoke fails the
   benchmark.

The service lines sieve their ledgers with ``cpu-numpy``: they are
host-plane numbers by definition. Every parity check runs before a number
is printed: a fast wrong sieve scores nothing. Any failure exits 1.
``sieve_torch/tools/bench_compare.py`` gates these lines between rounds.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

N = 10**9
PI_N = 50_847_534  # BASELINE.md oracle
BASELINE_CPU_FLOOR_VALUES_PER_SEC = (N - 1) / 7.5  # BASELINE.md CPU floor

DEPTH_SPAN = 10**9
DEPTH_LO = 10**12 - DEPTH_SPAN
DEPTH_HI = 10**12 + 1  # seed set = seed_primes(10^6) = 78,498 primes

# known pi(x) of the default sizes; other sizes count the seed sieve
PI_KNOWN = {10**9: PI_N, 30_000_000: 1_857_859}
# the fused kernel's result buffer: uint32[4] (count, pairs, first, last)
RESULT_BYTES = 4 * 4
# each fused block's partial: 8 uint32
PARTIAL_BYTES = 8 * 4
# the mesh cold-drain smoke, run as ``python <COLD_SMOKE> --device D``
COLD_SMOKE = ["-m", "sieve_torch.tools.mesh_cold_smoke"]
CHILD_TIMEOUT_S = 600
# the service lines' ledger [2, SVC_N] (cpu-numpy, 8 segments) and their
# cold chunk, the reference's
SVC_N = 2_000_000
SVC_CHUNK = 1 << 18


def emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def _pi(n: int) -> int:
    if n in PI_KNOWN:
        return PI_KNOWN[n]
    from sieve_torch.seed import seed_primes

    return int(seed_primes(n).size)


def shallow_metric(device: str = "cuda", n: int = N) -> dict:
    """Line 1: pi(n) on the cuda backend in one segment, warm then timed."""
    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local

    want = _pi(n)
    cfg = SieveConfig(
        n=n, backend="cuda", packing="odds", n_segments=1, twins=False,
        quiet=True, device=device,
    )
    # warmup: builds and loads the kernel, which is not what is measured
    warm = run_local(cfg)
    assert warm.pi == want, f"warmup parity failure: {warm.pi} != {want}"

    t0 = time.perf_counter()
    res = run_local(cfg)
    elapsed = time.perf_counter() - t0
    assert res.pi == want, f"parity failure: {res.pi} != {want}"

    values_per_sec = (n - 1) / elapsed
    return emit({
        "metric": "sieve_throughput_pi_1e9_odds_cuda",
        "value": round(values_per_sec, 1),
        "unit": "values/s/chip",
        "vs_baseline": round(values_per_sec / BASELINE_CPU_FLOOR_VALUES_PER_SEC, 3),
    })


SEGMENT_FIELDS = ("seg_id", "lo", "hi", "count", "twin_count", "first_word",
                  "last_word", "nbits")


def depth_parity(device: str, lo: int, hi: int):
    """The depth segment on ``CudaWorker`` (its first run builds the
    chain and loads the kernel), held field by field against
    ``CpuNumpyWorker``: (worker, seeds, device result, numpy seconds)."""
    from sieve_torch.backends.cpu_numpy import CpuNumpyWorker
    from sieve_torch.backends.cuda import CudaWorker
    from sieve_torch.config import SieveConfig
    from sieve_torch.seed import seed_primes

    cfg = SieveConfig(n=hi - 1, backend="cuda", packing="odds", twins=True,
                      quiet=True, device=device)
    seeds = seed_primes(math.isqrt(hi - 1))
    worker = CudaWorker(cfg)
    cold = worker.process_segment(lo, hi, seeds)
    # no oracle table covers pi(10^12) - pi(10^12 - 10^9): the numpy
    # worker's run of the same segment is the reference, and its time the
    # baseline
    t0 = time.perf_counter()
    ref = CpuNumpyWorker(cfg).process_segment(lo, hi, seeds)
    cpu_s = time.perf_counter() - t0
    got = tuple(getattr(cold, f) for f in SEGMENT_FIELDS)
    want = tuple(getattr(ref, f) for f in SEGMENT_FIELDS)
    assert got == want, f"depth parity failure: {got} != {want}"
    return worker, seeds, cold, cpu_s


def depth_metric(device: str = "cuda", lo: int = DEPTH_LO,
                 reps: int = 3) -> dict | None:
    """Line 2: the depth segment, best of ``reps`` warm runs."""
    from sieve_torch import env

    if device == "cpu" and not env.env_flag("SIEVE_BENCH_DEPTH"):
        print("depth metric skipped on --device cpu (the plain version would "
              "take hours; force with SIEVE_BENCH_DEPTH=1)", file=sys.stderr)
        return None
    hi = DEPTH_HI
    worker, seeds, ref, cpu_s = depth_parity(device, lo, hi)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res = worker.process_segment(lo, hi, seeds)
        best = min(best, time.perf_counter() - t0)
        assert res.count == ref.count, "depth rerun parity failure"
    values_per_sec = (hi - lo) / best
    return emit({
        "metric": "sieve_throughput_depth_1e12_odds_cuda",
        "value": round(values_per_sec, 1),
        "unit": "values/s/chip",
        "vs_baseline": round(cpu_s / best, 3),
    })


def host_prepare_metric(device: str = "cuda", span: int = 10**8, k: int = 9,
                        mesh_n: int = 30_000_000, mesh_rounds: int = 6) -> dict:
    """Line 3: steady-state incremental chain prepare at depth-regime
    stride density against from-scratch ``prepare_cuda`` of the same
    segments, plus overlap efficiency and device idle share of a real
    streamed ``run_mesh`` on the torch backend."""
    from sieve_torch.bitset import get_layout
    from sieve_torch.config import SieveConfig
    from sieve_torch.kernels.cuda_mark import TILE_WORDS, CudaChain, prepare_cuda
    from sieve_torch.parallel.mesh import run_mesh
    from sieve_torch.seed import seed_primes

    seeds = seed_primes(math.isqrt(DEPTH_HI - 1))  # full 78,498-seed set
    layout = get_layout("odds")
    bounds = [(DEPTH_LO + i * span, DEPTH_LO + (i + 1) * span) for i in range(k)]
    W = max(-(-layout.nbits(lo, hi) // 32) for lo, hi in bounds)
    wpad = -(-(W + 1) // TILE_WORDS) * TILE_WORDS

    chain = CudaChain("odds", seeds, wpad)
    chain.prepare(*bounds[0])  # one-time from-scratch residue derivation
    t0 = time.perf_counter()
    for lo, hi in bounds[1:]:
        chain.prepare(lo, hi)
    incr_per_seg = (time.perf_counter() - t0) / (k - 1)

    t0 = time.perf_counter()
    for lo, hi in bounds[1:3]:
        prepare_cuda("odds", lo, hi, seeds, wpad=wpad)
    scratch_per_seg = (time.perf_counter() - t0) / 2

    # overlap efficiency: a real streamed run (background prepare threads
    # feeding the round loop) on ``device``
    cfg = SieveConfig(
        n=mesh_n, backend="torch", packing="odds", workers=1, rounds=mesh_rounds,
        twins=False, quiet=True, device=device,
    )
    res = run_mesh(cfg)
    assert res.pi == _pi(mesh_n), f"mesh parity failure: {res.pi}"
    ph = res.host_phases or {}
    return emit({
        "metric": "host_prepare_throughput_odds_cuda",
        "value": round(span / incr_per_seg, 1),
        "unit": "values/s",
        # speedup of incremental chain prepare over from-scratch
        "vs_baseline": round(scratch_per_seg / incr_per_seg, 3),
        "overlap_efficiency": ph.get("overlap_efficiency"),
        "device_idle_frac": ph.get("device_idle_frac"),
    })


def traffic_bytes(seg) -> tuple[int, int]:
    """(split_bytes, fused_bytes) of one prepared segment, from the
    port's buffers (the module docstring, item 4)."""
    import numpy as np

    from sieve_torch.kernels.cuda_mark import _KERNEL_ARRAYS, TILE_WORDS, fused_args

    args = fused_args(seg)
    nbytes = {name: np.asarray(args[i]).nbytes for name, i in _KERNEL_ARRAYS}
    cursor_bytes = nbytes.pop("coff") + nbytes.pop("foff")
    table_bytes = sum(nbytes.values())
    bitset_bytes = seg.Wpad * 4
    blocks = seg.Wpad // TILE_WORDS
    split_bytes = table_bytes + 2 * bitset_bytes
    fused_bytes = (table_bytes + cursor_bytes + 2 * PARTIAL_BYTES * blocks
                   + RESULT_BYTES)
    return split_bytes, fused_bytes


def fused_reduction_metric(device: str = "cuda", lo: int = 2_000_003,
                           hi: int = 24_000_001) -> dict:
    """Line 4: fused vs split, a parity gate and the segment's traffic
    ratio. Both kernels run on ``device`` (their plain versions on the
    CPU); a disagreement prints no number."""
    from sieve_torch.kernels.cuda_mark import mark_cuda_split, mark_fused, prepare_cuda
    from sieve_torch.kernels.pairs import TWIN_ADJ
    from sieve_torch.seed import seed_primes

    seeds = seed_primes(math.isqrt(hi - 1))
    seg = prepare_cuda("odds", lo, hi, seeds)
    fused = mark_fused(seg, TWIN_ADJ, device=device)
    split = mark_cuda_split(seg, TWIN_ADJ, device=device)
    assert fused == split, f"fused parity failure: {fused} != {split}"
    split_bytes, fused_bytes = traffic_bytes(seg)
    ratio = fused_bytes / split_bytes
    return emit({
        "metric": "fused_reduction_hbm_traffic_ratio",
        "value": round(ratio, 4),
        "unit": "fused/split segment bytes",
        "vs_baseline": round(0.55 / ratio, 3),
        "split_bytes": split_bytes,
        "fused_bytes": fused_bytes,
        "parity": list(fused),
    })


# --- the service plane -------------------------------------------------------


def _pctile(vals: list[float], q: float) -> float:
    """Nearest-rank percentile (no interpolation: a latency sample that
    happened is reported, one that didn't is not)."""
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def _oracle(hi: int):
    """(primes below hi, pi) from the host seed sieve: the replies' oracle."""
    import numpy as np

    from sieve_torch.seed import seed_primes

    primes = seed_primes(hi)

    def o_pi(x: int) -> int:
        return int(np.searchsorted(primes, x, side="right"))

    return primes, o_pi


def _ledger(ck: str, n: int):
    """A cpu-numpy ledger of [2, n] in 8 segments in ``ck``; its config."""
    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local

    cfg = SieveConfig(n=n, backend="cpu-numpy", packing="odds", n_segments=8,
                      checkpoint_dir=ck, quiet=True)
    run_local(cfg)
    return cfg


def _ops_line(events: list[dict], span: str) -> dict:
    by_op: dict[str, list[float]] = {}
    for e in events:
        if e.get("name") == span:
            op = (e.get("args") or {}).get("op", "?")
            by_op.setdefault(op, []).append(e["dur"] / 1000.0)  # us -> ms
    assert by_op, f"no {span} spans captured"
    all_ms = [v for vals in by_op.values() for v in vals]
    p95 = _pctile(all_ms, 0.95)
    return {
        "value": round(p95, 3),
        "unit": "ms_p95",
        "vs_baseline": round(50.0 / p95, 3) if p95 else None,  # 50 ms budget
        "p50_ms": round(_pctile(all_ms, 0.5), 3),
        "ops": {
            op: {
                "n": len(vals),
                "p50_ms": round(_pctile(vals, 0.5), 3),
                "p95_ms": round(_pctile(vals, 0.95), 3),
            }
            for op, vals in sorted(by_op.items())
        },
    }


def _mixed_workload(cli, o_pi, timings: list[float] | None = None) -> None:
    """The line-5 mix: 150 hot prefix counts, 50 windowed counts through
    the materialize tier, 8 cold chunks past the ledger; every reply
    exact. With ``timings``, each call's client-side ms is appended."""
    def call(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        if timings is not None:
            timings.append((time.perf_counter() - t0) * 1e3)
        return out

    n, chunk = SVC_N, SVC_CHUNK
    for i in range(150):  # hot: O(log segments) prefix counts
        x = (7919 * (i + 1)) % n
        assert call(cli.pi, x) == o_pi(x), f"pi({x}) parity failure"
    for i in range(50):   # hot: windowed counts (materialize tier)
        lo = (104_729 * (i + 1)) % (n - 60_000)
        want = o_pi(lo + 50_000 - 1) - o_pi(lo - 1)
        assert call(cli.count, lo, lo + 50_000) == want, \
            f"count({lo}) parity failure"
    for i in range(8):    # cold: one fresh chunk each, batched
        x = n + (i + 1) * chunk - 1
        assert call(cli.pi, x) == o_pi(x), f"cold pi({x}) parity failure"


def service_latency_metric() -> dict:
    """Line 5: p50/p95 ms per op from the ``rpc.query`` spans of the
    mixed workload against an in-process service."""
    import tempfile

    from sieve_torch import trace
    from sieve_torch.service import ServiceClient

    _primes, o_pi = _oracle(SVC_N + 9 * SVC_CHUNK)
    with tempfile.TemporaryDirectory(prefix="sieve_bench_svc") as ck:
        cfg = _ledger(ck, SVC_N)
        trace.enable()
        trace.drain_events()  # only this workload's spans are measured
        with _service(cfg) as svc, ServiceClient(svc.addr, timeout_s=60) as cli:
            _mixed_workload(cli, o_pi)
        events, _dropped = trace.drain_events()
        trace.disable()
    return emit({"metric": "service_query_latency_p95_ms",
                 **_ops_line(events, "rpc.query")})


def service_hot_qps_metric(reps_p: int = 8, reps_b: int = 40) -> list[dict]:
    """Wire-plane throughput on ONE replica, three ways over the same 256
    hot prefix queries: sequential (one request in flight), pipelined
    (submit/drain on one connection) and batched (one ``batch`` RPC per
    256 members). ``service_hot_qps`` is the batched number on a
    ``negotiate=False`` (JSON v1) client, its vs_baseline batched over
    sequential; a negotiated connection then runs the batched loop on the
    binary v2 frames (``service_hot_qps_binary``) and prices the bytes per
    member (``service_wire_bytes_per_member``)."""
    import tempfile

    from sieve_torch.service import ServiceClient, ServiceSettings, SieveService

    n, chunk = SVC_N, SVC_CHUNK
    _primes, o_pi = _oracle(n + chunk)
    xs = [(7919 * (i + 1)) % n for i in range(256)]
    want = [o_pi(x) for x in xs]
    items = [{"op": "pi", "x": x} for x in xs]

    with tempfile.TemporaryDirectory(prefix="sieve_bench_qps") as ck:
        cfg = _ledger(ck, n)
        # queue sized for the 256-deep pipeline: this line measures the
        # wire plane, not admission control
        settings = ServiceSettings(workers=4, queue_limit=512, cold_chunk=chunk,
                                   refresh_s=0.0)
        with SieveService(cfg, settings) as svc, \
                ServiceClient(svc.addr, timeout_s=60, negotiate=False) as cli:
            for x, w in zip(xs[:64], want[:64]):  # warm index/LRU paths
                assert cli.pi(x) == w, f"warm pi({x}) parity failure"

            # sequential: one request in flight, client-side latency
            lat_ms: list[float] = []
            t0 = time.perf_counter()
            for x, w in zip(xs, want):
                c0 = time.perf_counter()
                assert cli.pi(x) == w, f"seq pi({x}) parity failure"
                lat_ms.append((time.perf_counter() - c0) * 1000.0)
            seq_qps = len(xs) / (time.perf_counter() - t0)

            # pipelined: submit all 256 on one connection, then drain
            t0 = time.perf_counter()
            for _ in range(reps_p):
                ids = [cli.submit("pi", x=x) for x in xs]
                replies = cli.drain(ids)
                for rid, w in zip(ids, want):
                    assert replies[rid].get("ok") and replies[rid]["value"] == w, \
                        f"pipelined pi parity failure: {replies[rid]!r}"
            pipe_qps = reps_p * len(xs) / (time.perf_counter() - t0)

            # batched: one RPC per 256 members, one vectorized gather
            t0 = time.perf_counter()
            for _ in range(reps_b):
                outs = cli.query_batch(items)
                for o, w in zip(outs, want):
                    assert o.get("ok") and o["value"] == w, \
                        f"batch pi parity failure: {o!r}"
            batch_qps = reps_b * len(xs) / (time.perf_counter() - t0)

            # JSON wire cost: one batch with the counters read around it
            js0, jr0 = cli.bytes_sent, cli.bytes_recv
            cli.query_batch(items)
            json_bpm = (cli.bytes_sent - js0 + cli.bytes_recv - jr0) / len(xs)

            # binary wire v2: same members, same oracle, a fresh negotiated
            # connection
            with ServiceClient(svc.addr, timeout_s=60) as cli2:
                assert cli2.wire_v == 2, "binary v2 negotiation failed"
                lat2_ms: list[float] = []
                for x, w in zip(xs, want):
                    c0 = time.perf_counter()
                    assert cli2.pi(x) == w, f"v2 seq pi({x}) parity failure"
                    lat2_ms.append((time.perf_counter() - c0) * 1000.0)
                t0 = time.perf_counter()
                for _ in range(reps_b):
                    outs = cli2.query_batch(items)
                    for o, w in zip(outs, want):
                        assert o.get("ok") and o["value"] == w, \
                            f"v2 batch pi parity failure: {o!r}"
                bin_qps = reps_b * len(xs) / (time.perf_counter() - t0)
                bs0, br0 = cli2.bytes_sent, cli2.bytes_recv
                cli2.query_batch(items)
                bin_bpm = (cli2.bytes_sent - bs0 + cli2.bytes_recv - br0) / len(xs)

    return [
        emit({"metric": "service_hot_qps", "value": round(batch_qps, 1),
              "unit": "qps", "vs_baseline": round(batch_qps / seq_qps, 2),
              "sequential_qps": round(seq_qps, 1),
              "pipeline_qps": round(pipe_qps, 1),
              "hot_p95_ms": round(_pctile(lat_ms, 0.95), 3),
              "queries": reps_b * len(xs)}),
        emit({"metric": "service_pipeline_qps", "value": round(pipe_qps, 1),
              "unit": "qps", "vs_baseline": round(pipe_qps / seq_qps, 2),
              "queries": reps_p * len(xs)}),
        emit({"metric": "service_hot_qps_binary", "value": round(bin_qps, 1),
              "unit": "qps", "vs_json": round(bin_qps / batch_qps, 2),
              "hot_p95_ms": round(_pctile(lat2_ms, 0.95), 3),
              "queries": reps_b * len(xs)}),
        emit({"metric": "service_wire_bytes_per_member", "value": round(bin_bpm, 1),
              "unit": "bytes_per_member",
              "json_bytes_per_member": round(json_bpm, 1),
              "vs_json": round(bin_bpm / json_bpm, 2)}),
    ]


def _first_line(proc: subprocess.Popen, timeout_s: float) -> str:
    """The child's first stdout line, or raise after ``timeout_s``."""
    box: list[str] = []
    reader = threading.Thread(target=lambda: box.append(proc.stdout.readline()),
                              daemon=True)
    reader.start()
    reader.join(timeout_s)
    if not box:
        raise TimeoutError(f"no line from {proc.args[:6]} in {timeout_s} s")
    return box[0]


def _stop_group(proc: subprocess.Popen, timeout_s: float = 30) -> None:
    """SIGTERM the child (a ``--procs`` supervisor drains its children),
    then kill its whole process group if it has not exited."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    if proc.poll() is None:
        proc.wait(timeout=timeout_s)


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def service_hot_qps_scaling_metric() -> dict:
    """Hot qps of ``python -m sieve_torch serve --procs P`` for each P on
    ONE port, the processes sharing the mmap'd segment store; the value
    is q_max / (P_max q_1), gated by bench_compare's ``scaling_ratio``
    floor only where ``cpus`` >= ``procs_max``. The servers run
    ``--backend cpu-numpy`` (the queries are all hot, x < n): the port's
    ``serve`` defaults to the card. Every reply is asserted exact."""
    import tempfile

    from sieve_torch.service import ServiceClient

    n = 1_000_000
    reps = 3  # per-thread passes over xs in the timed window
    _primes, o_pi = _oracle(n + 1)
    xs = [(7919 * (i + 1)) % n for i in range(128)]
    want = [o_pi(x) for x in xs]
    env = _child_env()
    qps: dict[int, float] = {}
    with tempfile.TemporaryDirectory(prefix="sieve_bench_scale") as ck:
        _ledger(ck, n)
        for procs in (1, 2, 4):
            cmd = [sys.executable, "-m", "sieve_torch", "serve", "--n", str(n),
                   "--segments", "8", "--checkpoint-dir", ck,
                   "--backend", "cpu-numpy", "--addr", "127.0.0.1:0",
                   "--procs", str(procs), "--quiet"]
            proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                                    text=True, start_new_session=True)
            try:
                doc = json.loads(_first_line(proc, CHILD_TIMEOUT_S))
                assert doc.get("event") == "serving", doc
                addr = doc["addr"]
                # warm every process's index/LRU: fresh connections spread
                # over the fleet until each answered some
                for _ in range(max(4, 2 * procs)):
                    with ServiceClient(addr, timeout_s=60) as c:
                        for x, w in zip(xs[:32], want[:32]):
                            assert c.pi(x) == w, f"warm pi({x}) parity failure"

                errs: list[BaseException] = []

                def pump() -> None:
                    try:
                        with ServiceClient(addr, timeout_s=60) as c:
                            for _ in range(reps):
                                for x, w in zip(xs, want):
                                    assert c.pi(x) == w, f"pi({x}) parity failure"
                    except BaseException as e:  # noqa: BLE001
                        errs.append(e)

                threads = [threading.Thread(target=pump) for _ in range(procs)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(300)
                elapsed = time.perf_counter() - t0
                assert not errs, f"scaling pump failed: {errs[0]!r}"
                assert not any(t.is_alive() for t in threads), "scaling pump hung"
                qps[procs] = procs * reps * len(xs) / elapsed
            finally:
                _stop_group(proc)

    return emit({
        "metric": "service_hot_qps_scaling",
        "value": round(qps[4] / (4 * qps[1]), 3),
        "unit": "scaling_ratio",
        "qps_1": round(qps[1], 1),
        "qps_2": round(qps[2], 1),
        "qps_4": round(qps[4], 1),
        "procs_max": 4,
        "cpus": os.cpu_count(),
        "queries_per_proc": reps * len(xs),
    })


def service_hot_under_flood_metric() -> dict:
    """Hot-lane p95 while ``flood`` threads saturate the cold lane
    (``cold_delay_s`` simulated): the lane isolation as a number. Every
    hot reply is exact; cold replies are exact or typed."""
    import tempfile

    from sieve_torch import trace
    from sieve_torch.service import ServiceClient, ServiceSettings, SieveService

    n, chunk, flood = SVC_N, SVC_CHUNK, 20
    _primes, o_pi = _oracle(n + (flood + 4) * chunk)
    with tempfile.TemporaryDirectory(prefix="sieve_bench_flood") as ck:
        cfg = _ledger(ck, n)
        trace.enable()
        trace.drain_events()
        settings = ServiceSettings(
            workers=4, hot_workers=1, queue_limit=64, cold_queue_limit=16,
            cold_chunk=chunk, cold_delay_s=0.15, cold_age_s=0.5,
            default_deadline_s=30.0, refresh_s=0.0,
        )
        typed = {"overloaded", "deadline_exceeded", "degraded"}
        with SieveService(cfg, settings) as svc, \
                ServiceClient(svc.addr, timeout_s=60) as cli:
            for i in range(50):  # warm the hot path / LRU first
                x = (7919 * (i + 1)) % n
                assert cli.pi(x) == o_pi(x), f"warm pi({x}) parity failure"

            def cold(i: int) -> None:
                x = n + (i + 1) * chunk - 1  # distinct cold chunks
                with ServiceClient(svc.addr, timeout_s=60) as c:
                    rep = c.query("pi", x=x)
                    if rep.get("ok"):
                        assert rep["value"] == o_pi(x), f"cold pi({x}) parity failure"
                    else:
                        assert rep.get("error") in typed, \
                            f"cold pi({x}) untyped reply {rep!r}"

            threads = [threading.Thread(target=cold, args=(i,)) for i in range(flood)]
            t_mark = trace.now_s()
            for t in threads:
                t.start()
            for _ in range(3):  # the hot stream the lanes must protect
                for i in range(50):
                    x = (7919 * (i + 1)) % n
                    assert cli.pi(x) == o_pi(x), f"hot pi({x}) parity failure"
            for t in threads:
                t.join(120)
        events, _dropped = trace.drain_events()
        trace.disable()
    hot_ms = [
        e["dur"] / 1000.0 for e in events
        if e.get("name") == "rpc.query"
        and (e.get("args") or {}).get("lane") == "hot"
        and e["ts"] / 1e6 >= t_mark  # flood window only, not the warmup
    ]
    assert hot_ms, "no hot-lane rpc.query spans captured under flood"
    p95 = _pctile(hot_ms, 0.95)
    return emit({
        "metric": "service_hot_under_flood_ms_p95",
        "value": round(p95, 3),
        "unit": "ms_p95",
        "vs_baseline": round(50.0 / p95, 3) if p95 else None,
        "p50_ms": round(_pctile(hot_ms, 0.5), 3),
        "hot_n": len(hot_ms),
    })


def router_query_latency_metric() -> dict:
    """Line 6: p95 ms of the ``rpc.route`` spans of a mixed workload
    against a two-shard in-process fabric: the ledger split 4+4 into
    per-shard serving dirs (shard 1 with ``range_lo``); point routes,
    scatter-gather prefix counts, windowed counts, twin windows across
    the shard edge (the splice path) and nth_prime over the edge. Every
    reply exact; both full-shard totals cached and at least one splice."""
    import tempfile

    import numpy as np

    from sieve_torch import trace
    from sieve_torch.checkpoint import Ledger
    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local
    from sieve_torch.service import (
        RouterSettings,
        ServiceClient,
        ServiceSettings,
        Shard,
        ShardMap,
        SieveRouter,
        SieveService,
    )

    n = SVC_N
    oracle, o_pi = _oracle(n + 100_000)

    def o_count(lo: int, hi: int) -> int:
        return int(np.searchsorted(oracle, hi, side="left")
                   - np.searchsorted(oracle, lo, side="left"))

    def o_pairs(lo: int, hi: int, gap: int) -> int:
        w = oracle[(oracle >= lo) & (oracle < hi)]
        if w.size < 2:
            return 0
        idx = np.searchsorted(w, w + gap)
        ok = idx < w.size
        return int(np.count_nonzero(w[idx[ok]] == w[ok] + gap))

    def shard_cfg(d: str) -> SieveConfig:
        return SieveConfig(n=n, backend="cpu-numpy", packing="odds", n_segments=8,
                           checkpoint_dir=d, quiet=True)

    with tempfile.TemporaryDirectory(prefix="sieve_bench_router") as ck:
        src = os.path.join(ck, "src")
        run_local(shard_cfg(src))
        segs = sorted(Ledger.open_readonly(shard_cfg(src)).completed().values(),
                      key=lambda r: r.lo)
        E = segs[4].lo  # shard edge on a segment boundary
        dirs = [os.path.join(ck, f"shard{i}") for i in range(2)]
        for d, part in zip(dirs, (segs[:4], segs[4:])):
            led = Ledger.open(shard_cfg(d))
            for r in part:
                led.record(r)

        trace.enable()
        trace.drain_events()  # only this workload's spans are measured
        svcs = [
            SieveService(shard_cfg(dirs[0]),
                         ServiceSettings(workers=4, queue_limit=64,
                                         refresh_s=0.0)).start(),
            SieveService(shard_cfg(dirs[1]),
                         ServiceSettings(workers=4, queue_limit=64, refresh_s=0.0,
                                         range_lo=E)).start(),
        ]
        smap = ShardMap([Shard(2, E, (svcs[0].addr,)),
                         Shard(E, n + 1, (svcs[1].addr,))])
        router = SieveRouter(smap, RouterSettings(quiet=True)).start()
        try:
            with ServiceClient(router.addr, timeout_s=60) as cli:
                # full-range prefix: caches BOTH full-shard totals
                assert cli.pi(n) == o_pi(n), f"pi({n}) parity failure"
                for i in range(120):  # scatter-gather prefix counts
                    x = (7919 * (i + 1)) % n
                    assert cli.pi(x) == o_pi(x), f"pi({x}) parity failure"
                for i in range(60):   # windowed counts, both shards
                    lo = (104_729 * (i + 1)) % (n - 60_000)
                    want = o_count(lo, lo + 50_000)
                    assert cli.count(lo, lo + 50_000) == want, \
                        f"count({lo}) parity failure"
                for i in range(40):   # point routes to one shard each
                    x = (7907 * (i + 1)) % n
                    got = cli.query("is_prime", x=x)
                    assert got["ok"] and got["value"] == (o_count(x, x + 1) == 1), \
                        f"is_prime({x}) parity failure"
                for i in range(30):   # edge-straddling pair windows: splice
                    lo, hi = E - 400 - 37 * i, E + 400 + 29 * i
                    rep = cli.query("count", lo=lo, hi=hi, kind="twins")
                    assert rep["ok"] and rep["value"] == o_pairs(lo, hi, 2), \
                        f"twins({lo},{hi}) parity failure"
                for i in range(10):   # nth_prime walks the cumulative totals
                    k = o_pi(E - 1) - 5 + i  # straddles the edge count
                    rep = cli.query("nth_prime", k=k)
                    assert rep["ok"] and rep["value"] == int(oracle[k - 1]), \
                        f"nth_prime({k}) parity failure"
                st = cli.stats()
                assert st["totals_cached"] == 2, "full-shard totals not cached"
                assert st["spliced"] >= 1, "no edge splice in the workload"
        finally:
            router.stop()
            for s in svcs:
                s.stop()
        events, _dropped = trace.drain_events()
        trace.disable()
    return emit({"metric": "router_query_latency_p95_ms",
                 **_ops_line(events, "rpc.route")})


# --- the overhead ratios -----------------------------------------------------


def _overhead(prefix: str, reps: int, run_pass) -> dict:
    """Interleaved off/on passes of the mixed workload, each on a fresh
    service over one ledger (cold chunks cost the same in both modes), an
    untimed warmup first, client-side timing; the minimum p95 across reps
    per mode (the converged floor, which still holds every deterministic
    per-request cost). ``run_pass(cfg, on, body)`` builds the service with
    the plane on or off and calls ``body(svc, cli)``. Returns the p95s,
    the ratio and the request count."""
    import tempfile

    _primes, o_pi = _oracle(SVC_N + 9 * SVC_CHUNK)
    with tempfile.TemporaryDirectory(prefix=prefix) as ck:
        cfg = _ledger(ck, SVC_N)

        def one(on: bool) -> list[float]:
            timings: list[float] = []

            def body(cli) -> None:
                for i in range(30):  # untimed warmup: steady state only
                    cli.pi((101 * (i + 1)) % SVC_N)
                _mixed_workload(cli, o_pi, timings)

            run_pass(cfg, on, body)
            return timings

        p95s_off: list[float] = []
        p95s_on: list[float] = []
        n_reqs = 0
        for _ in range(reps):
            off = one(False)
            on = one(True)
            p95s_off.append(_pctile(off, 0.95))
            p95s_on.append(_pctile(on, 0.95))
            n_reqs = len(on)
    p95_off, p95_on = min(p95s_off), min(p95s_on)
    ratio = p95_on / p95_off if p95_off else float("inf")
    return {"off": p95_off, "on": p95_on, "ratio": ratio, "n": n_reqs}


def _overhead_line(metric: str, keys: tuple[str, str], budget: float, got: dict,
                   reps: int) -> dict:
    ratio = got["ratio"]
    return emit({
        "metric": metric,
        "value": round(ratio, 4),
        "unit": "overhead_ratio",
        "vs_baseline": round(budget / ratio, 3) if ratio else None,
        keys[0]: round(got["off"], 3),
        keys[1]: round(got["on"], 3),
        "n": got["n"],
        "reps": reps,
    })


def _service(cfg, **extra):
    """An in-process service over ``cfg``'s ledger with the line-5
    settings, plus ``extra``."""
    from sieve_torch.service import ServiceSettings, SieveService

    return SieveService(cfg, ServiceSettings(workers=4, queue_limit=64,
                                             cold_chunk=SVC_CHUNK, refresh_s=0.0,
                                             **extra))


def service_trace_overhead_metric(reps: int = 25) -> dict:
    """Fleet tracing: the trace plane fully off vs fully on (span capture,
    the bounded ship ring, batched reply piggybacks requested as a
    tracing router would), timed from the client so the ratio includes
    the serialize and ship cost. Budget 1.05."""
    from sieve_torch import trace
    from sieve_torch.service import ServiceClient

    def run_pass(cfg, traced: bool, body) -> None:
        if traced:
            trace.enable()
        with _service(cfg, telemetry_ship=traced) as svc, \
                ServiceClient(svc.addr, timeout_s=60) as cli:
            if traced:
                orig = cli.query
                cli.query = (  # type: ignore[method-assign]
                    lambda op, deadline_s=None, **p:
                    orig(op, deadline_s, telemetry=True, **p)
                )
            body(cli)
        if traced:
            trace.drain_events()
            trace.disable()
            trace.set_event_limit(None)

    got = _overhead("sieve_bench_trace", reps, run_pass)
    return _overhead_line("service_trace_overhead_ratio",
                          ("p95_untraced_ms", "p95_traced_ms"), 1.05, got, reps)


def service_recorder_overhead_metric(reps: int = 25) -> dict:
    """Flight recorder: armed (metrics-sink event tail, chained crash
    hooks) with the MetricsHistory sampler at 50 ms and a real debug dir,
    vs both off. No trigger fires, so the ratio prices the steady state.
    Budget 1.05."""
    import tempfile

    from sieve_torch.service import ServiceClient

    with tempfile.TemporaryDirectory(prefix="sieve_bench_dbg") as dbg:
        def run_pass(cfg, recorded: bool, body) -> None:
            with _service(cfg, recorder=recorded,
                          debug_dir=dbg if recorded else None,
                          # 20 samples/s: far denser than the 1 s default,
                          # so the sampler genuinely runs in-window
                          metrics_sample_s=0.05 if recorded else 0.0) as svc, \
                    ServiceClient(svc.addr, timeout_s=60) as cli:
                body(cli)

        got = _overhead("sieve_bench_rec", reps, run_pass)
    return _overhead_line("service_recorder_overhead_ratio",
                          ("p95_unrecorded_ms", "p95_recorded_ms"), 1.05, got, reps)


def service_profiler_overhead_metric(reps: int = 25) -> dict:
    """Continuous profiler: ``prof_hz`` at the production default (a 19 Hz
    sampler folding stacks into a bounded table) vs 0 (no sampler thread).
    Nothing pulls the profile. Budget 1.05."""
    from sieve_torch.service import ServiceClient

    def run_pass(cfg, profiled: bool, body) -> None:
        with _service(cfg, prof_hz=19.0 if profiled else 0.0) as svc, \
                ServiceClient(svc.addr, timeout_s=60) as cli:
            body(cli)

    got = _overhead("sieve_bench_prof", reps, run_pass)
    return _overhead_line("service_profiler_overhead_ratio",
                          ("p95_unprofiled_ms", "p95_profiled_ms"), 1.05, got, reps)


def service_lock_debug_overhead_metric(reps: int = 25) -> dict:
    """Lock sanitizer: ``SIEVE_LOCK_DEBUG`` as the variable. The flag is
    read when a lock is built (sieve_torch/analysis/lockdebug.py), so it is
    set around the service's and the client's construction: the off pass
    prices plain ``threading`` primitives, the on pass the recording
    wrappers. An on pass must have recorded lock orders (else it measured
    nothing), and they must agree with the canonical order. Budget 1.10:
    a debug mode that wraps every lock, not an always-on tax."""
    from sieve_torch.analysis import lockdebug
    from sieve_torch.service import ServiceClient

    def run_pass(cfg, debug: bool, body) -> None:
        prev = os.environ.pop("SIEVE_LOCK_DEBUG", None)
        if debug:
            os.environ["SIEVE_LOCK_DEBUG"] = "1"
            lockdebug.recorder().reset()
        try:
            with _service(cfg) as svc, \
                    ServiceClient(svc.addr, timeout_s=60) as cli:
                body(cli)
        finally:
            if prev is None:
                os.environ.pop("SIEVE_LOCK_DEBUG", None)
            else:
                os.environ["SIEVE_LOCK_DEBUG"] = prev
        if debug:
            assert lockdebug.recorder().observed_pairs(), \
                "SIEVE_LOCK_DEBUG=1 pass recorded no lock order"
            problems = lockdebug.check_static_consistency()
            assert not problems, \
                "lock sanitizer vs static graph: " + "; ".join(problems)

    got = _overhead("sieve_bench_lockdbg", reps, run_pass)
    return _overhead_line("service_lock_debug_overhead_ratio",
                          ("p95_plain_ms", "p95_debug_ms"), 1.10, got, reps)


def service_observer_overhead_metric(reps: int = 25) -> dict:
    """Capacity observatory: ON arms exemplar tail sampling (span ring,
    completion-time sampler, the rolling exemplar file under a real debug
    dir) and a live FleetObserver scraping the service at 1 Hz into an
    on-disk ring; OFF disables both. Both passes keep the flight
    recorder's default. Nothing alarms in the workload. Budget 1.05."""
    import tempfile

    from sieve_torch.service import ServiceClient
    from sieve_torch.service.observe import FleetObserver, ObserverSettings

    with tempfile.TemporaryDirectory(prefix="sieve_bench_obs_dbg") as dbg:
        def run_pass(cfg, observed: bool, body) -> None:
            sub = os.path.join(dbg, "on" if observed else "off")
            with _service(cfg, exemplars=observed, debug_dir=sub) as svc, \
                    ServiceClient(svc.addr, timeout_s=60) as cli:
                obs = None
                if observed:
                    obs = FleetObserver(svc.addr, ObserverSettings(
                        scrape_s=1.0, observe_dir=sub, debug_pull=False,
                        quiet=True))
                    obs.start()
                try:
                    body(cli)
                finally:
                    if obs is not None:
                        obs.stop()

        got = _overhead("sieve_bench_obs_ck", reps, run_pass)
    return _overhead_line("service_observer_overhead_ratio",
                          ("p95_unobserved_ms", "p95_observed_ms"), 1.05, got, reps)


def service_cold_drain_throughput_metric(device: str = "cuda") -> dict:
    """Line 9: the mesh cold-drain smoke as a child process; it holds the
    mesh against cpu-numpy and a direct oracle, and one drain against
    exactly one batched launch, before it prints its line."""
    cmd = [sys.executable, *COLD_SMOKE, "--device", device]
    proc = subprocess.run(cmd, env=_child_env(), cwd=REPO, capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("{") and "service_cold_drain_throughput" in ln]
    if proc.returncode != 0 or "MESH_COLD_SMOKE_OK" not in proc.stdout or not lines:
        raise RuntimeError(f"mesh cold smoke failed (rc={proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    print(lines[0], flush=True)
    return json.loads(lines[0])


# main's calls, in the reference's order
METRICS = (
    shallow_metric,
    depth_metric,
    host_prepare_metric,
    fused_reduction_metric,
    service_latency_metric,
    service_hot_qps_metric,
    service_hot_qps_scaling_metric,
    service_hot_under_flood_metric,
    router_query_latency_metric,
    service_trace_overhead_metric,
    service_recorder_overhead_metric,
    service_profiler_overhead_metric,
    service_lock_debug_overhead_metric,
    service_observer_overhead_metric,
    service_cold_drain_throughput_metric,
)
# the lines that run on --device (the others are host planes)
DEVICE_METRICS = {shallow_metric, depth_metric, host_prepare_metric,
                  fused_reduction_metric, service_cold_drain_throughput_metric}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m sieve_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the kernel lines: cuda (the card, "
                        "default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    for fn in METRICS:
        try:
            if fn in DEVICE_METRICS:
                fn(device=args.device)
            else:
                fn()
        except Exception as e:  # noqa: BLE001 — report and fail the run
            traceback.print_exc()
            print(f"bench: FAIL: {fn.__name__}: {e}", file=sys.stderr, flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
