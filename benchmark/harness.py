"""One run of one cell: set-up, a closed-loop window, the check, the line.

The window runs jobs back to back from one client: each job is one call
of the entry the cell's mix names (``run_mesh`` or ``run_local``) on a
fresh ``SieveConfig``, as the CLI makes it, followed by a device
synchronise. Jobs start until ``--seconds`` have passed; the window ends
when the last one returns, so no job is cut and none is left out.

Set-up is timed from the moment ``import torch`` returned (run.py) to the
window's start: importing the port, the CUDA context, loading (or, in a
fresh checkout, building) the kernel library, one warm job of the cell's
own shape, and a garbage collection that freezes what set-up made. Its
parts are printed on the line ``setup_parts`` before the result.

With ``--trace 1`` the port's span capture is on and ``torch.profiler``
records the card's activity over the window; the per-layer readers
(benchmark/metrics/) take their numbers from both.

The result is checked against the plain reference (benchmark/check.py)
after the window, once the device's peak memory has been read.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import sys
import threading
import time
from typing import Callable

from benchmark import check, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "sieve"}
BREAKDOWN_TOP = 10           # entries of each breakdown list


def interpreter_age_s() -> float | None:
    """Seconds since this process started, from /proc (None elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def forbidden_loaded() -> list[str]:
    """The top-level names in ``sys.modules`` that the run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


@dataclasses.dataclass
class Job:
    start: float                 # host clock, seconds from the window's start
    end: float
    result: object = None        # the entry's SieveResult
    error: str | None = None


def window_metrics(jobs: list[Job], values_per_job: int) -> dict:
    """The window's rate and tail from its jobs, timed from the window's
    start: every job completed counts, and the time is up to the last
    one's end. The tail is the 95th percentile of all jobs' wall times
    (linear between order statistics)."""
    done = [j for j in jobs if j.error is None]
    if not done:
        return {"values_per_s": None, "job_p95_ms": None, "window_s": None}
    window = max(j.end for j in jobs)
    return {"values_per_s": values_per_job * len(done) / window,
            "job_p95_ms": p95([(j.end - j.start) * 1e3 for j in jobs]),
            "window_s": window}


def p95(values: list[float]) -> float:
    """The 95th percentile, linear between order statistics."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def run_window(job: Callable[[], object], seconds: float,
               clock: Callable[[], float] = time.perf_counter,
               sync: Callable[[], None] = lambda: None) -> list[Job]:
    """Closed loop, one client: start jobs until ``seconds`` have passed."""
    t0 = clock()
    jobs: list[Job] = []
    while not jobs or clock() - t0 < seconds:
        s = clock()
        try:
            res, err = job(), None
            sync()
        except Exception as e:  # a failed job counts; the window goes on
            res, err = None, f"{type(e).__name__}: {e}"
        jobs.append(Job(s - t0, clock() - t0, res, err))
    return jobs


def make_job(cell: spec.Cell, device: str, n: int | None = None):
    """The cell's job: its entry on a fresh config. Returns (job, config
    dict as run, segment count)."""
    from sieve_torch.config import SieveConfig

    config = dict(cell.config)
    if n is not None:
        config["n"] = n
    mix = cell.traffic
    if mix.get("loop") != "closed" or mix.get("clients") != 1:
        raise ValueError(f"{cell.name}: the generator runs a closed loop of "
                         f"one client, not {mix}")
    kwargs = dict(n=int(config["n"]), backend=config["backend"],
                  packing=config["packing"], count_kind=config["count_kind"],
                  quiet=True, device=device)
    if mix["entry"] == "run_mesh":
        from sieve_torch.parallel.mesh import run_mesh as entry

        kwargs["rounds"] = segments = int(mix["rounds"])
    elif mix["entry"] == "run_local":
        from sieve_torch.coordinator import run_local as entry

        kwargs["n_segments"] = segments = int(mix["segments"])
    else:
        raise ValueError(f"{cell.name}: unknown entry {mix['entry']!r}")
    return (lambda: entry(SieveConfig(**kwargs))), config, segments


def answer(result) -> dict:
    """A job's answer as the check reads it (no pair count is 0 pairs)."""
    return {"pi": result.pi, "pairs": result.twin_pairs or 0,
            "segments": [{f: getattr(s, f) for f in ("lo", "hi") + check.FIELDS}
                         for s in result.segments]}


@dataclasses.dataclass
class Reading:
    """What a per-layer reader is given (benchmark/metrics/)."""

    cell: spec.Cell
    config: dict
    jobs: int                    # jobs the window completed
    job_ms: list                 # every job's wall time
    window_s: float
    spans: dict                  # span name -> (seconds, count) over the window
    device_ops: list | None      # (name, start_s, end_s) on the window's clock
    busy_s: float | None         # union of device_ops within the window
    job_bound_s: Callable[[], float | None]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def innermost(spans: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    """The spans of one thread, properly nested, flattened into
    consecutive pieces each named by the innermost span open there."""
    out: list[tuple[float, float, str]] = []
    stack: list[tuple[float, str]] = []
    cur = None
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, nm = stack.pop()
            if end > cur:
                out.append((cur, end, nm))
                cur = end
        if cur is not None and s > cur and stack:
            out.append((cur, s, stack[-1][1]))
        cur = s if cur is None else max(cur, s)
        stack.append((e, name))
    while stack:
        end, nm = stack.pop()
        if end > cur:
            out.append((cur, end, nm))
            cur = end
    return out


def idle_gaps(busy: list[tuple[float, float]], window_s: float,
              pieces: list[tuple[float, float, str]]) -> dict[str, float]:
    """Seconds the device was idle in the window, by the innermost span
    the host's main thread was in; ``_no_span_`` where it was in none."""
    gaps, t = [], 0.0
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, window_s)))
        t = max(t, b)
    if t < window_s:
        gaps.append((t, window_s))
    out: dict[str, float] = {}
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + hi - lo
                covered += hi - lo
            k += 1
        if b - a - covered > 0:
            out["_no_span_"] = out.get("_no_span_", 0.0) + b - a - covered
    return out


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def _top(d: dict[str, float]) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]]


class DeviceTrace:
    """torch.profiler over the window, the card's activity only: kernels,
    copies and sets, on the window's clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self, unix0_ns: int, window_s: float) -> list[tuple[str, float, float]]:
        """Stop, and return (name, start_s, end_s) of every device
        operation that overlaps [0, window_s] of the window that began at
        unix time ``unix0_ns``."""
        self._prof.__exit__(None, None, None)
        ops = []
        for e in self._prof.profiler.kineto_results.events():
            if not str(e.device_type()).endswith("CUDA"):
                continue
            a = (e.start_ns() - unix0_ns) / 1e9
            b = a + e.duration_ns() / 1e9
            if b > 0 and a < window_s:
                ops.append((e.name(), a, b))
        return ops


def _main_thread_pieces(tracer, tr0: float, window_s: float, tid: int):
    spans = [(e["ts"] / 1e6 - tr0, (e["ts"] + e["dur"]) / 1e6 - tr0, e["name"])
             for e in tracer.events()
             if e.get("ph") == "X" and e.get("tid") == tid]
    return innermost([s for s in spans if s[1] > 0 and s[0] < window_s])


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             t_torch: float, device: str = "cuda", n: int | None = None,
             parts: dict | None = None) -> dict:
    """Set up, run the window, check, and return the result object (the
    line run.py prints). ``device="cpu"`` runs the same path on the
    kernels' plain versions, for the tests; only "cuda" is a measurement."""
    import torch

    out, err = sys.stdout, sys.stderr
    parts = dict(parts or {})

    def part(name: str, t: float) -> float:
        now = time.perf_counter()
        parts[name] = now - t
        return now

    t = time.perf_counter()
    from sieve_torch import trace
    from sieve_torch.kernels import build

    job, config, segments = make_job(cell, device, n)
    t = part("import_port_s", t)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.init()
        torch.empty(1, device="cuda")
        t = part("cuda_init_s", t)
        if config["backend"] == "cuda":
            from sieve_torch.kernels.cuda_mark import warm

            parts["library_built"] = not build.library_path().exists()
            warm([torch.device("cuda", 0)])
            t = part("library_s", t)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    job()
    sync()
    t = part("warm_job_s", t)
    gc.collect()
    gc.freeze()
    t = part("gc_s", t)
    dev_trace = None
    if traced:
        trace.enable()
        if on_card:
            dev_trace = DeviceTrace()
        t = part("trace_start_s", t)
    snap = trace.snapshot()
    tr0, unix0, t0 = trace.now_s(), time.time_ns(), time.perf_counter()
    setup_s = t0 - t_torch
    jobs = run_window(job, seconds, sync=sync)
    spans = trace.since(snap)
    win = window_metrics(jobs, int(config["n"]) - 1)
    window_s = max(j.end for j in jobs)
    job_ms = [(j.end - j.start) * 1e3 for j in jobs]
    ops = dev_trace.stop(unix0, window_s) if dev_trace else None
    if traced:
        trace.disable()

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if on_card else 0)}
    failed = [j for j in jobs if j.error is not None]
    answers = [answer(j.result) for j in jobs if j.error is None]
    del jobs[:]  # the program's results are now plain data

    ref = check.reference(config, segments, seed)
    numbers = check.compare(answers, ref)
    correct = check.verdict(numbers, len(answers), len(failed))

    metrics: dict[str, dict] = {}
    result = {"correct": correct, "attempted": len(answers) + len(failed),
              "failed": len(failed), "metrics": metrics, "device": device_info}
    if not traced:
        # a metric named "<reading>.<part>" is that reading under a bound
        # of its own, for the cells it lists
        e2e = {"values_per_s": win["values_per_s"],
               "job_p95_ms": win["job_p95_ms"], "setup_s": setup_s}
        for m in cell.end_to_end:
            value = e2e.get(m["name"].split(".")[0])
            if value is None:
                raise ValueError(f"no reading of end-to-end metric {m['name']!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        busy = _union([(max(a, 0.0), min(b, window_s)) for _, a, b in ops]) if ops else []
        busy_s = sum(b - a for a, b in busy) if ops is not None else None

        def job_bound_s() -> float | None:
            from benchmark.reference import common
            from benchmark import roofline

            peak = roofline.peaks(device_info["kind"])
            if peak is None:
                return None
            seeds = common.seed_primes(math.isqrt(int(config["n"])))
            gap = check.gap_of(config)
            return sum(roofline.bound_s(roofline.segment_work(lo, hi, seeds, gap), peak)
                       for lo, hi in common.plan(int(config["n"]), segments))

        reading = Reading(cell, config, len(answers), job_ms, window_s, spans,
                          ops, busy_s, job_bound_s)
        for m in cell.per_layer:
            v = spec.reader(m["name"]).read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if ops is not None:
            device_info["busy_s"] = busy_s
            device_info["window_s"] = window_s
            by_name: dict[str, float] = {}
            for name, a, b in ops:
                by_name[_short(name)] = by_name.get(_short(name), 0.0) + (
                    min(b, window_s) - max(a, 0.0))
            pieces = _main_thread_pieces(trace.get_tracer(), tr0, window_s,
                                         threading.main_thread().ident)
            result["breakdown"] = {
                "device_ops": _top(by_name),
                "idle_gaps": _top(idle_gaps(busy, window_s, pieces))}
        print(f"traced window: values_per_s {win['values_per_s']} job_p95_ms "
              f"{win['job_p95_ms']} over {len(answers)} jobs", file=err)
    for j in failed[:3]:
        print(f"failed job: {j.error}", file=err)
    result["checked"] = {k: {"value": v, "limit": check.LIMITS[k]}
                         for k, v in numbers.items()}
    # last of all, once the check, the yardstick and every reader are loaded
    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")
    print("setup_parts " + json.dumps(parts), file=out)
    print(f"checked {len(answers)} jobs; reference sieved segments "
          f"{sorted(ref['whole'])} of {len(ref['plan'])} whole", file=err)
    for k, v in numbers.items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=err)
    err.flush()
    return result
