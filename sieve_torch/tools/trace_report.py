"""Render a ``--trace`` file on the terminal: per-phase breakdown,
device-idle timeline, and the slowest spans. The port's copy of the
reference's ``tools/trace_report.py``: the same file, bundle or exemplar
file renders the same text and exits with the same code in both.

The input is Chrome trace-event JSON as written by sieve_torch/trace.py
(``{"traceEvents": [...]}``; a bare event array is accepted too), so the
same file loads in Perfetto / ``chrome://tracing`` for the visual view.

``--cluster`` renders the distributed view of a merged cpu-cluster
trace (coordinator + per-worker tracks, see sieve_torch/cluster.py):
per-worker utilization/idle, the RPC-wait vs compute split, straggler
ranking, rpc.assign <-> worker.segment correlation/nesting after clock
rebasing, the membership timeline (worker joins/leaves and adaptive
deadline adjustments), and the per-worker clock-alignment error report.

``--routed`` renders the fleet view of a merged ROUTER trace (see
sieve_torch/service/router.py): router ``rpc.route`` spans correlated by
trace-context prefix with the shard-replica ``rpc.query`` children
merged under per-replica tracks, plus each replica's clock-alignment
error bound.

``--bundle`` renders a flight-recorder postmortem bundle (see
sieve_torch/debug.py) instead of a trace: what tripped the trigger,
metric sparklines over the bundled history window, the span-ring tail,
and the last error-ish events — for a single-process ``bundle.json`` or
a merged ``fleet_bundle.json`` (a directory is accepted and searched for
either file).

``--exemplars`` renders a tail-sampled exemplar file
(sieve_torch/service/exemplar.py).

A file that is not valid trace JSON (truncated write, wrong file, a
bare object without ``traceEvents``) exits 1 with a named
``trace_report: error:`` line instead of a traceback.

Host code: it loads no torch, so it starts in well under a second.

Usage: python -m sieve_torch.tools.trace_report TRACE_FILE [--top N]
       [--cluster | --routed | --bundle | --exemplars]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys


class TraceLoadError(Exception):
    """The input is not a readable Chrome trace-event file."""


def load_all(path_or_file) -> list[dict]:
    """Every event in a trace file (spans, instants, counters, metadata).

    Raises :class:`TraceLoadError` — never a bare decode traceback — on
    a missing/unreadable file, malformed or truncated JSON, or JSON of
    the wrong shape (tooling must fail named, not crash)."""
    name = getattr(path_or_file, "name", str(path_or_file))
    try:
        if hasattr(path_or_file, "read"):
            doc = json.load(path_or_file)
        else:
            with open(path_or_file) as f:
                doc = json.load(f)
    except json.JSONDecodeError as e:
        raise TraceLoadError(
            f"{name}: malformed or truncated trace JSON ({e})"
        ) from None
    except UnicodeDecodeError:
        raise TraceLoadError(f"{name}: not a text JSON file") from None
    except OSError as e:
        raise TraceLoadError(f"{name}: {e.strerror or e}") from None
    if isinstance(doc, dict):
        if "traceEvents" not in doc:
            raise TraceLoadError(
                f"{name}: JSON object has no 'traceEvents' key — not a "
                "Chrome trace-event file"
            )
        doc = doc["traceEvents"]
    if not isinstance(doc, list) or any(
        not isinstance(e, dict) for e in doc
    ):
        raise TraceLoadError(
            f"{name}: trace events must be a list of objects"
        )
    return doc


def load_events(path_or_file) -> list[dict]:
    """Complete ("X") span events from a trace file, sorted by start."""
    spans = [e for e in load_all(path_or_file) if e.get("ph") == "X"]
    spans.sort(key=lambda e: e["ts"])
    return spans


def phase_breakdown(spans: list[dict]) -> dict[str, dict]:
    """Aggregate spans by name: count, total/mean/max duration (us)."""
    agg: dict[str, dict] = {}
    for e in spans:
        a = agg.setdefault(
            e["name"], {"count": 0, "total_us": 0.0, "max_us": 0.0}
        )
        a["count"] += 1
        a["total_us"] += e["dur"]
        if e["dur"] > a["max_us"]:
            a["max_us"] = e["dur"]
    for a in agg.values():
        a["mean_us"] = a["total_us"] / a["count"]
    return agg


def wall_span_us(spans: list[dict]) -> float:
    if not spans:
        return 0.0
    lo = min(e["ts"] for e in spans)
    hi = max(e["ts"] + e["dur"] for e in spans)
    return hi - lo


def _fmt_args(e: dict) -> str:
    args = e.get("args")
    if not args:
        return ""
    return " " + " ".join(f"{k}={v}" for k, v in sorted(args.items()))


def report(spans: list[dict], top: int = 10) -> str:
    """The full text report (kept a pure function so tests and the
    profile_* wrappers can render without going through the CLI)."""
    lines: list[str] = []
    wall = wall_span_us(spans)
    lines.append(
        f"{len(spans)} spans over {wall / 1e3:.1f} ms of host timeline"
    )

    lines.append("")
    lines.append("per-phase breakdown (by total time):")
    lines.append(
        f"  {'phase':<24} {'count':>6} {'total ms':>10} {'mean ms':>9} "
        f"{'max ms':>9} {'% wall':>7}"
    )
    agg = phase_breakdown(spans)
    for name, a in sorted(
        agg.items(), key=lambda kv: -kv[1]["total_us"]
    ):
        pct = 100.0 * a["total_us"] / wall if wall else 0.0
        lines.append(
            f"  {name:<24} {a['count']:>6} {a['total_us'] / 1e3:>10.3f} "
            f"{a['mean_us'] / 1e3:>9.3f} {a['max_us'] / 1e3:>9.3f} "
            f"{pct:>6.1f}%"
        )

    lines.append("")
    idle = [e for e in spans if e["name"] == "round.device_idle"]
    if idle:
        total_idle = sum(e["dur"] for e in idle)
        frac = total_idle / wall if wall else 0.0
        lines.append(
            f"device-idle timeline ({len(idle)} windows, "
            f"{total_idle / 1e3:.3f} ms, {100 * frac:.1f}% of timeline):"
        )
        t0 = min(e["ts"] for e in spans)
        for e in idle:
            lines.append(
                f"  +{(e['ts'] - t0) / 1e3:>10.3f} ms  "
                f"idle {e['dur'] / 1e3:>8.3f} ms{_fmt_args(e)}"
            )
    else:
        lines.append(
            "device-idle timeline: no round.device_idle spans "
            "(device never starved, or not a mesh run)"
        )

    service = service_report(spans)
    if service:
        lines.append("")
        lines.extend(service)

    router = router_report(spans)
    if router:
        lines.append("")
        lines.extend(router)

    lines.append("")
    lines.append(f"slowest {min(top, len(spans))} spans:")
    for e in sorted(spans, key=lambda e: -e["dur"])[:top]:
        lines.append(
            f"  {e['dur'] / 1e3:>10.3f} ms  {e['name']}{_fmt_args(e)}"
        )
    return "\n".join(lines)


def service_report(spans: list[dict]) -> list[str]:
    """Query-service section: per-request latency decomposed into
    queue-wait vs index materialization vs cold backend compute, split
    by reply source (the service's rpc.query spans). Empty when the
    trace has no service traffic."""
    rpc = [e for e in spans if e["name"] == "rpc.query"]
    refreshes = [e for e in spans if e["name"] == "service.refresh"]
    if not rpc and not refreshes:
        return []
    lines = ["query service (rpc.query requests):"]
    if refreshes:
        # live-follow freshness: how often the snapshot swapped,
        # how often a refresh was skipped, and how stale the last swapped
        # snapshot is at the end of the trace
        swapped = [e for e in refreshes
                   if e.get("args", {}).get("outcome") == "swapped"]
        failed = len(refreshes) - len(swapped)
        trace_end = max(e["ts"] + e["dur"] for e in spans)
        if swapped:
            last = max(swapped, key=lambda e: e["ts"])
            staleness_s = (trace_end - (last["ts"] + last["dur"])) / 1e6
            lines.append(
                f"  ledger follow: {len(swapped)} refresh(es) swapped, "
                f"{failed} skipped; covered_hi="
                f"{last.get('args', {}).get('covered_hi', '?')}, snapshot "
                f"{staleness_s:.3f}s stale at trace end"
            )
        else:
            lines.append(
                f"  ledger follow: 0 refreshes swapped, {failed} skipped "
                "(serving the startup snapshot)"
            )
    if not rpc:
        return lines
    by_outcome: dict[tuple[str, str], list[float]] = {}
    for e in rpc:
        a = e.get("args", {})
        key = (str(a.get("op", "?")), str(a.get("outcome", "?")),
               str(a.get("source", "?")))
        by_outcome.setdefault(key, []).append(e["dur"])
    lines.append(
        f"  {'op':<10} {'outcome':<18} {'source':<7} {'count':>6} "
        f"{'total ms':>10} {'mean ms':>9} {'max ms':>9}"
    )
    for (op, outcome, source), durs in sorted(
        by_outcome.items(), key=lambda kv: -sum(kv[1])
    ):
        lines.append(
            f"  {op:<10} {outcome:<18} {source:<7} {len(durs):>6} "
            f"{sum(durs) / 1e3:>10.3f} {sum(durs) / len(durs) / 1e3:>9.3f} "
            f"{max(durs) / 1e3:>9.3f}"
        )
    total = sum(e["dur"] for e in rpc)
    parts = [
        ("queue-wait", "query.queue_wait"),
        ("index materialize", "query.materialize"),
        ("cold compute", "query.cold"),
    ]
    lines.append(
        f"  latency split over {len(rpc)} requests "
        f"({total / 1e3:.3f} ms total in rpc.query):"
    )
    accounted = 0.0
    for label, name in parts:
        t = sum(e["dur"] for e in spans if e["name"] == name)
        accounted += t
        pct = 100 * t / total if total else 0.0
        lines.append(f"    {label:<18} {t / 1e3:>10.3f} ms {pct:>6.1f}%")
    # batched cold plane: query.cold spans nest inside
    # query.cold_batch, so the batch row reports only the drain/dispatch
    # overhead on top of the compute already counted above
    batches = [e for e in spans if e["name"] == "query.cold_batch"]
    if batches:
        cold_t = sum(e["dur"] for e in spans if e["name"] == "query.cold")
        over = max(0.0, sum(e["dur"] for e in batches) - cold_t)
        accounted += over
        chunks = sum((e.get("args") or {}).get("chunks", 0) for e in batches)
        lines.append(
            f"    {'cold batch':<18} {over / 1e3:>10.3f} ms "
            f"{100 * over / total if total else 0:>6.1f}%"
            f"  ({len(batches)} dispatches, {chunks} chunks)"
        )
    # mesh cold plane: query.cold_mesh spans nest inside
    # query.cold, so this row is informational (NOT added to accounted
    # — that would double-count) — it shows how much of the cold compute
    # ran as one-launch SPMD rounds and at what chunk fanout
    mesh = [e for e in spans if e["name"] == "query.cold_mesh"]
    if mesh:
        mesh_t = sum(e["dur"] for e in mesh)
        chunks = sum((e.get("args") or {}).get("chunks", 0) for e in mesh)
        devices = max(
            (e.get("args") or {}).get("devices", 0) for e in mesh
        )
        lines.append(
            f"    {'cold mesh':<18} {mesh_t / 1e3:>10.3f} ms "
            f"{100 * mesh_t / total if total else 0:>6.1f}%"
            f"  ({len(mesh)} SPMD launches, {chunks} chunks, "
            f"{devices} devices; nested in cold compute)"
        )
    other = max(0.0, total - accounted)
    lines.append(
        f"    {'index/other':<18} {other / 1e3:>10.3f} ms "
        f"{100 * other / total if total else 0:>6.1f}%"
    )
    # priority lanes: per-lane request latency + queue wait.
    # Traces from pre-lane servers carry no lane arg and skip the block.
    by_lane: dict[str, list[float]] = {}
    for e in rpc:
        lane = (e.get("args") or {}).get("lane")
        if lane is not None:
            by_lane.setdefault(str(lane), []).append(e["dur"])
    if by_lane:
        waits: dict[str, list[float]] = {}
        for e in spans:
            if e["name"] != "query.queue_wait":
                continue
            lane = (e.get("args") or {}).get("lane")
            if lane is not None:
                waits.setdefault(str(lane), []).append(e["dur"])
        lines.append(
            f"  {'lane':<6} {'count':>6} {'mean ms':>9} {'p95 ms':>9} "
            f"{'max ms':>9} {'wait p95 ms':>12}"
        )
        for lane in sorted(by_lane):
            durs = sorted(by_lane[lane])
            p95 = durs[max(0, math.ceil(0.95 * len(durs)) - 1)]
            w = sorted(waits.get(lane, []))
            # no observations is "-", never a fake 0.0 percentile
            wp95 = w[max(0, math.ceil(0.95 * len(w)) - 1)] if w else None
            wp95_s = f"{wp95 / 1e3:>12.3f}" if wp95 is not None \
                else f"{'-':>12}"
            lines.append(
                f"  {lane:<6} {len(durs):>6} "
                f"{sum(durs) / len(durs) / 1e3:>9.3f} {p95 / 1e3:>9.3f} "
                f"{max(durs) / 1e3:>9.3f} {wp95_s}"
            )
    return lines


def router_report(spans: list[dict]) -> list[str]:
    """Shard-router section: front-door latency by op and
    outcome (``rpc.route`` spans) plus the per-shard scatter table
    (``route.scatter`` spans — one per downstream shard call, so a
    scatter-gather query contributes a row to several shards). Traces
    from pre-router runs have no rpc.route spans and skip the block."""
    route = [e for e in spans if e["name"] == "rpc.route"]
    if not route:
        return []
    lines = ["shard router (rpc.route requests):"]
    by_key: dict[tuple[str, str], list[float]] = {}
    fanout = 0
    for e in route:
        a = e.get("args", {})
        by_key.setdefault(
            (str(a.get("op", "?")), str(a.get("outcome", "?"))), []
        ).append(e["dur"])
        fanout += int(a.get("shards", 0) or 0)
    lines.append(
        f"  {len(route)} routed requests, "
        f"{fanout / len(route):.2f} shards touched per request"
    )
    lines.append(
        f"  {'op':<10} {'outcome':<18} {'count':>6} {'total ms':>10} "
        f"{'mean ms':>9} {'max ms':>9}"
    )
    for (op, outcome), durs in sorted(
        by_key.items(), key=lambda kv: -sum(kv[1])
    ):
        lines.append(
            f"  {op:<10} {outcome:<18} {len(durs):>6} "
            f"{sum(durs) / 1e3:>10.3f} {sum(durs) / len(durs) / 1e3:>9.3f} "
            f"{max(durs) / 1e3:>9.3f}"
        )
    scatter = [e for e in spans if e["name"] == "route.scatter"]
    if scatter:
        by_shard: dict[str, dict] = {}
        for e in scatter:
            a = e.get("args", {})
            row = by_shard.setdefault(
                str(a.get("shard", "?")), {"durs": [], "outcomes": {}}
            )
            row["durs"].append(e["dur"])
            o = str(a.get("outcome", "?"))
            row["outcomes"][o] = row["outcomes"].get(o, 0) + 1
        lines.append(
            f"  per-shard scatter ({len(scatter)} downstream calls):"
        )
        lines.append(
            f"  {'shard':<6} {'calls':>6} {'mean ms':>9} {'p95 ms':>9} "
            f"{'max ms':>9}  outcomes"
        )
        for shard in sorted(by_shard, key=lambda s: (len(s), s)):
            row = by_shard[shard]
            durs = sorted(row["durs"])
            p95 = durs[max(0, math.ceil(0.95 * len(durs)) - 1)]
            outs = " ".join(
                f"{k}={v}" for k, v in sorted(row["outcomes"].items())
            )
            lines.append(
                f"  {shard:<6} {len(durs):>6} "
                f"{sum(durs) / len(durs) / 1e3:>9.3f} {p95 / 1e3:>9.3f} "
                f"{max(durs) / 1e3:>9.3f}  {outs}"
            )
    return lines


def routed_report(events: list[dict]) -> str:
    """The fleet view of a merged router trace (pure function).

    Expects the stream a tracing :class:`~sieve_torch.service.router.SieveRouter`
    writes: its own ``rpc.route``/``route.scatter`` spans plus per-shard-
    replica tracks (``process_name`` = ``"shard<i> <addr>"``) carrying the
    rebased ``rpc.query`` (and queue-wait/cold) children shipped back on
    reply piggybacks, with one ``clock.align`` instant per merge.

    Correlation is by trace-context prefix: a shard ``rpc.query`` with
    ``args.ctx = R/s1.3.0`` is a child of the ``rpc.route`` whose
    ``args.ctx = R``. Point queries have exactly one child; scatters have
    one per shard touched."""
    spans = sorted(
        (e for e in events if e.get("ph") == "X"), key=lambda e: e["ts"]
    )
    replica_pids = {
        e["pid"]: e["args"]["name"]
        for e in events
        if e.get("ph") == "M"
        and e.get("name") == "process_name"
        and str(e.get("args", {}).get("name", "")).startswith("shard")
    }
    route = [e for e in spans if e["name"] == "rpc.route"]
    if not route:
        return (
            "no rpc.route spans in trace — not a router trace "
            "(python -m sieve route with --trace)"
        )
    if not replica_pids:
        return (
            "no shard-replica tracks in trace — shards did not piggyback "
            "telemetry (start them with SIEVE_SVC_TELEMETRY=1), or every "
            "payload was dropped"
        )
    lines: list[str] = []
    wall = wall_span_us(spans)
    queries = [
        e for e in spans
        if e["name"] == "rpc.query" and e.get("pid") in replica_pids
    ]
    lines.append(
        f"routed-query fleet timeline: {len(replica_pids)} shard-replica "
        f"tracks, {len(route)} rpc.route spans, {len(queries)} merged "
        f"shard rpc.query spans over {wall / 1e3:.1f} ms"
    )

    # --- route -> child correlation by ctx prefix ---------------------------
    by_ctx: dict[str, list[dict]] = {}
    for q in queries:
        ctx = str(q.get("args", {}).get("ctx", ""))
        if ctx:
            # child ctx "R/s<i>.<call>.<attempt>" -> route ctx "R"
            base = ctx.rsplit("/", 1)[0]
            by_ctx.setdefault(base, []).append(q)
    correlated = exactly_one = nested = 0
    for r in route:
        rctx = str(r.get("args", {}).get("ctx", ""))
        kids = by_ctx.get(rctx, []) if rctx else []
        if not kids:
            continue
        correlated += 1
        if len(kids) == 1:
            exactly_one += 1
        if all(
            k["ts"] >= r["ts"]
            and k["ts"] + k["dur"] <= r["ts"] + r["dur"]
            for k in kids
        ):
            nested += 1
    lines.append(
        f"correlation: {correlated}/{len(route)} rpc.route spans have "
        f"shard rpc.query children "
        f"({100 * correlated / len(route):.1f}%); "
        f"{exactly_one} with exactly one child; nested after rebase: "
        f"{nested}/{correlated} "
        f"({100 * nested / correlated if correlated else 0:.1f}%)"
    )

    # --- per-replica tracks -------------------------------------------------
    lines.append("")
    lines.append("per-replica tracks (merged rpc.query spans):")
    lines.append(
        f"  {'replica':<28} {'spans':>6} {'mean ms':>9} {'p95 ms':>9} "
        f"{'max ms':>9}"
    )
    for pid in sorted(replica_pids):
        durs = sorted(e["dur"] for e in queries if e.get("pid") == pid)
        if durs:
            p95 = durs[max(0, math.ceil(0.95 * len(durs)) - 1)]
            lines.append(
                f"  {replica_pids[pid]:<28} {len(durs):>6} "
                f"{sum(durs) / len(durs) / 1e3:>9.3f} {p95 / 1e3:>9.3f} "
                f"{durs[-1] / 1e3:>9.3f}"
            )
        else:
            lines.append(
                f"  {replica_pids[pid]:<28} {0:>6} {'-':>9} {'-':>9} "
                f"{'-':>9}"
            )

    # --- clock alignment ----------------------------------------------------
    lines.append("")
    aligns = [
        e for e in events
        if e.get("name") == "clock.align"
        and "replica" in e.get("args", {})
    ]
    if aligns:
        lines.append("per-replica clock alignment (min-RTT estimate, "
                     "error bound = RTT/2):")
        latest: dict[str, dict] = {}
        for e in sorted(aligns, key=lambda e: e.get("ts", 0)):
            latest[str(e["args"]["replica"])] = e["args"]
        max_err = None
        total_dropped = 0
        for rep in sorted(latest):
            a = latest[rep]
            total_dropped += a.get("dropped", 0)
            if "offset_s" in a:
                max_err = (
                    a["err_s"] if max_err is None
                    else max(max_err, a["err_s"])
                )
                lines.append(
                    f"  shard{a.get('shard', '?')} {rep}: offset "
                    f"{a['offset_s'] * 1e3:+.3f} ms, rtt "
                    f"{a['rtt_s'] * 1e3:.3f} ms, err <= "
                    f"{a['err_s'] * 1e6:.0f} us "
                    f"({a.get('samples', 0)} samples, "
                    f"{a.get('dropped', 0)} events dropped)"
                )
            else:
                lines.append(
                    f"  shard{a.get('shard', '?')} {rep}: no alignment "
                    "sample (events merged unrebased)"
                )
        if max_err is not None:
            lines.append(
                f"  max clock-alignment error: {max_err * 1e6:.0f} us"
            )
        if total_dropped:
            lines.append(
                f"  WARNING: {total_dropped} shard trace events dropped "
                "by the ship ring (raise SIEVE_TELEMETRY_RING)"
            )
    else:
        lines.append("clock alignment: no replica clock.align events "
                     "in trace")
    return "\n".join(lines)


def cluster_report(events: list[dict], top: int = 10) -> str:
    """The distributed view of a merged cluster trace (pure function).

    Expects the event stream written by a cpu-cluster ``--trace`` run:
    coordinator ``rpc.assign`` spans, per-worker process tracks
    (``process_name`` = "worker N") carrying the rebased
    ``worker.recv``/``worker.segment``/``worker.reply`` spans, and one
    ``clock.align`` instant per worker.
    """
    spans = sorted(
        (e for e in events if e.get("ph") == "X"), key=lambda e: e["ts"]
    )
    worker_pids = {
        e["pid"]: e["args"]["name"]
        for e in events
        if e.get("ph") == "M"
        and e.get("name") == "process_name"
        and str(e.get("args", {}).get("name", "")).startswith("worker ")
    }
    if not worker_pids:
        return (
            "no worker tracks in trace — not a merged cluster trace "
            "(cpu-cluster backend with --trace), or no worker shipped "
            "telemetry"
        )
    lines: list[str] = []
    wall = wall_span_us(spans)
    rpc = [e for e in spans if e["name"] == "rpc.assign"]
    wseg = [e for e in spans if e["name"] == "worker.segment"]
    lines.append(
        f"cluster timeline: {len(worker_pids)} workers, {len(rpc)} "
        f"rpc.assign round-trips over {wall / 1e3:.1f} ms"
    )

    # --- per-worker utilization / idle --------------------------------------
    lines.append("")
    lines.append("per-worker utilization (busy = worker.segment time, "
                 "idle = worker.recv wait):")
    lines.append(
        f"  {'worker':<10} {'segs':>5} {'busy ms':>10} {'util %':>7} "
        f"{'idle ms':>10} {'idle %':>7} {'reply ms':>9}"
    )
    per_worker: dict[int, dict] = {}
    for pid in worker_pids:
        rows = [e for e in spans if e["pid"] == pid]
        busy = sum(e["dur"] for e in rows if e["name"] == "worker.segment")
        idle = sum(e["dur"] for e in rows if e["name"] == "worker.recv")
        reply = sum(e["dur"] for e in rows if e["name"] == "worker.reply")
        segs = [e for e in rows if e["name"] == "worker.segment"]
        per_worker[pid] = {
            "busy": busy, "idle": idle, "segs": segs,
            "max_seg": max((e["dur"] for e in segs), default=0.0),
        }
        lines.append(
            f"  {worker_pids[pid]:<10} {len(segs):>5} {busy / 1e3:>10.3f} "
            f"{100 * busy / wall if wall else 0:>6.1f}% "
            f"{idle / 1e3:>10.3f} "
            f"{100 * idle / wall if wall else 0:>6.1f}% {reply / 1e3:>9.3f}"
        )

    # --- rpc-wait vs compute split ------------------------------------------
    # correlate by trace context: each rpc.assign and the worker.segment
    # of the same attempt share args.ctx
    seg_by_ctx = {
        e["args"]["ctx"]: e
        for e in wseg
        if e.get("args", {}).get("ctx")
    }
    corr = nested = 0
    rpc_total = seg_total = 0.0
    for r in rpc:
        rpc_total += r["dur"]
        w = seg_by_ctx.get(r.get("args", {}).get("ctx"))
        if w is None:
            continue
        corr += 1
        seg_total += w["dur"]
        if (
            w["ts"] >= r["ts"]
            and w["ts"] + w["dur"] <= r["ts"] + r["dur"]
        ):
            nested += 1
    lines.append("")
    wait = max(0.0, rpc_total - seg_total)
    lines.append(
        f"rpc-wait vs compute (over {corr} correlated round-trips): "
        f"compute {seg_total / 1e3:.3f} ms "
        f"({100 * seg_total / rpc_total if rpc_total else 0:.1f}%), "
        f"rpc-wait {wait / 1e3:.3f} ms "
        f"({100 * wait / rpc_total if rpc_total else 0:.1f}%)"
    )
    lines.append(
        f"correlation: {corr}/{len(rpc)} rpc.assign spans have a "
        f"worker.segment child; nested after rebase: {nested}/{corr} "
        f"({100 * nested / corr if corr else 0:.1f}%)"
    )

    # --- straggler ranking ---------------------------------------------------
    lines.append("")
    lines.append("straggler ranking (by slowest single segment):")
    ranked = sorted(
        per_worker.items(), key=lambda kv: -kv[1]["max_seg"]
    )[:top]
    for pid, w in ranked:
        n = len(w["segs"])
        mean = w["busy"] / n if n else 0.0
        lines.append(
            f"  {worker_pids[pid]:<10} max {w['max_seg'] / 1e3:>9.3f} ms  "
            f"mean {mean / 1e3:>9.3f} ms  busy {w['busy'] / 1e3:>9.3f} ms"
        )

    # --- membership timeline -------------------------------------------------
    membership = sorted(
        (
            e for e in events
            if e.get("ph") == "i" and e.get("name") in (
                "cluster.worker_joined", "cluster.worker_left",
                "cluster.deadline_adjusted",
            )
        ),
        key=lambda e: e.get("ts", 0),
    )
    if membership:
        lines.append("")
        lines.append("membership timeline (joins, leaves, deadline "
                     "adjustments):")
        t0 = min(e["ts"] for e in spans) if spans else membership[0]["ts"]
        for e in membership:
            a = e.get("args", {})
            if e["name"] == "cluster.worker_joined":
                what = (
                    f"worker {a.get('worker')} joined "
                    f"(active={a.get('active')})"
                )
            elif e["name"] == "cluster.worker_left":
                what = (
                    f"worker {a.get('worker')} left "
                    f"(active={a.get('active')})"
                )
            else:
                prev = a.get("prev_s")
                what = (
                    f"deadline adjusted to {a.get('deadline_s')}s"
                    + (f" (was {prev}s)" if prev is not None else "")
                )
            lines.append(f"  +{(e['ts'] - t0) / 1e3:>10.3f} ms  {what}")

    # --- clock alignment -----------------------------------------------------
    lines.append("")
    aligns = [e for e in events if e.get("name") == "clock.align"]
    if aligns:
        lines.append("clock alignment (NTP-style min-RTT estimate, "
                     "error bound = RTT/2):")
        max_err = None
        total_dropped = 0
        for e in sorted(aligns, key=lambda e: e["args"].get("worker", 0)):
            a = e["args"]
            total_dropped += a.get("dropped", 0)
            if "offset_s" in a:
                max_err = (
                    a["err_s"] if max_err is None
                    else max(max_err, a["err_s"])
                )
                lines.append(
                    f"  worker {a['worker']}: offset "
                    f"{a['offset_s'] * 1e3:+.3f} ms, rtt "
                    f"{a['rtt_s'] * 1e3:.3f} ms, err <= "
                    f"{a['err_s'] * 1e6:.0f} us "
                    f"({a.get('samples', 0)} samples, "
                    f"{a.get('dropped', 0)} events dropped)"
                )
            else:
                lines.append(
                    f"  worker {a['worker']}: no alignment sample "
                    f"(events merged unrebased)"
                )
        if max_err is not None:
            lines.append(
                f"  max clock-alignment error: {max_err * 1e6:.0f} us"
            )
        if total_dropped:
            lines.append(
                f"  WARNING: {total_dropped} worker trace events dropped "
                "by the ship ring (raise SIEVE_TELEMETRY_RING)"
            )
    else:
        lines.append("clock alignment: no clock.align events in trace")
    return "\n".join(lines)


# --- flight-recorder bundles -------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"
_BUNDLE_PREFIX = "sieve-debug/"
_FLEET_PREFIX = "sieve-fleet-debug/"


def load_bundle(path: str) -> dict:
    """A flight-recorder bundle document from a file or a bundle dir.

    Accepts a ``bundle.json`` / ``fleet_bundle.json`` path directly, or
    a directory that contains either. Raises :class:`TraceLoadError`
    (named, no traceback) on anything that is not a recorder bundle."""
    if os.path.isdir(path):
        for name in ("fleet_bundle.json", "bundle.json"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise TraceLoadError(
                f"{path}: directory holds no fleet_bundle.json or "
                "bundle.json"
            )
    try:
        with open(path) as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        raise TraceLoadError(
            f"{path}: malformed or truncated bundle JSON ({e})"
        ) from None
    except UnicodeDecodeError:
        raise TraceLoadError(f"{path}: not a text JSON file") from None
    except OSError as e:
        raise TraceLoadError(f"{path}: {e.strerror or e}") from None
    ver = doc.get("bundle") if isinstance(doc, dict) else None
    if not isinstance(ver, str) or not ver.startswith(
        (_BUNDLE_PREFIX, _FLEET_PREFIX)
    ):
        raise TraceLoadError(
            f"{path}: no recognised 'bundle' version key — not a "
            "flight-recorder bundle (see sieve/debug.py)"
        )
    return doc


def _sparkline(vals: list) -> str:
    pts = [float(v) for v in vals
           if isinstance(v, (int, float)) and math.isfinite(v)]
    if not pts:
        return "-"
    lo, hi = min(pts), max(pts)
    if hi <= lo:
        return _SPARK[0] * len(pts)
    scale = (len(_SPARK) - 1) / (hi - lo)
    return "".join(_SPARK[int((v - lo) * scale + 0.5)] for v in pts)


def _history_series(history: list) -> dict[str, list]:
    """name -> per-sample numeric series across a bundle's history rows.

    Counters/gauges contribute their ``value``; histograms their
    ``count``. A metric absent from an older row pads with None so every
    series spans the same sample axis."""
    names: list[str] = []
    seen: set[str] = set()
    for row in history:
        for name, inst in (row.get("metrics") or {}).items():
            if name not in seen and isinstance(inst, dict):
                seen.add(name)
                names.append(name)
    series: dict[str, list] = {n: [] for n in names}
    for row in history:
        snap = row.get("metrics") or {}
        for n in names:
            inst = snap.get(n)
            if not isinstance(inst, dict):
                series[n].append(None)
            elif "value" in inst:
                series[n].append(inst["value"])
            else:
                series[n].append(inst.get("count"))
    return series


def _compact(d: dict, skip: tuple = ("event", "ts")) -> str:
    parts = [f"{k}={d[k]!r}" for k in d if k not in skip]
    s = " ".join(parts)
    return s if len(s) <= 72 else s[:69] + "..."


def _one_bundle_lines(b: dict, max_series: int = 12,
                      span_tail: int = 15, error_tail: int = 10) -> list:
    lines = [
        f"  role={b.get('role')} pid={b.get('pid')} "
        f"wall={b.get('wall_time')}",
        f"  trigger: {b.get('trigger')}"
        + (f"  detail: {json.dumps(b.get('detail'))}"
           if b.get("detail") else ""),
    ]
    if b.get("path"):
        lines.append(f"  written: {b['path']}")
    rec = b.get("recorder") or {}
    lines.append(
        f"  recorder: {rec.get('bundles', 0)} bundles, "
        f"{rec.get('suppressed', 0)} suppressed by cooldown, "
        f"{b.get('spans_dropped', 0)} spans dropped by ring"
    )
    history = b.get("history") or []
    series = _history_series(history)
    if series:
        lines.append(f"  metrics history ({len(history)} samples):")
        shown = 0
        for name, vals in series.items():
            if shown >= max_series:
                lines.append(
                    f"    ... {len(series) - shown} more series"
                )
                break
            last = next((v for v in reversed(vals) if v is not None), None)
            lines.append(
                f"    {name:<38} last={last!r:>10}  {_sparkline(vals)}"
            )
            shown += 1
    else:
        lines.append("  metrics history: no samples (sampler disabled?)")
    spans = b.get("spans") or []
    if spans:
        lines.append(f"  span tail (last {min(span_tail, len(spans))} "
                     f"of {len(spans)}):")
        for s in spans[-span_tail:]:
            dur = s.get("dur")
            dur_ms = f"{dur / 1e3:.3f} ms" if dur is not None else "-"
            lines.append(f"    {s.get('name', '?'):<28} {dur_ms:>12}")
    errors = b.get("errors") or []
    if errors:
        lines.append(f"  last errors ({len(errors)}):")
        for e in errors[-error_tail:]:
            lines.append(f"    {e.get('event', '?'):<24} {_compact(e)}")
    else:
        lines.append("  last errors: none recorded")
    prof = b.get("profile")
    if prof:
        from sieve_torch.profile import self_times

        merged = {r["stack"]: {"count": r["count"],
                               "role": r.get("role")}
                  for r in prof.get("stacks") or []}
        lines.append(
            f"  profile ({prof.get('hz')} Hz, "
            f"{prof.get('samples', 0)} samples, "
            f"{len(prof.get('stacks') or [])} stacks, "
            f"{prof.get('evicted', 0)} evicted) — top self-time:"
        )
        for r in self_times(merged, 8):
            lines.append(
                f"    {r['frame']:<38} {r['self']:>6}  {r['share']:.1%}"
            )
    return lines


def bundle_report(doc: dict) -> str:
    """Terminal postmortem of a flight-recorder bundle (pure function).

    Handles both a single-process bundle and a merged fleet bundle (the
    fleet debug tool's ``fleet_bundle.json``)."""
    ver = doc.get("bundle", "")
    lines: list[str] = []
    if ver.startswith(_FLEET_PREFIX):
        reps = doc.get("replicas") or []
        lines.append(
            f"fleet debug bundle ({ver}): "
            f"{doc.get('processes', 0)} processes captured"
        )
        router = doc.get("router") or {}
        lines.append("")
        if router.get("bundle"):
            lines.append(f"router {router.get('addr', '?')}")
            lines.extend(_one_bundle_lines(router["bundle"]))
        else:
            lines.append(
                f"router {router.get('addr', '?')}: NO BUNDLE "
                f"({router.get('error')})"
            )
        for rep in reps:
            tag = (f"s{rep['shard']} " if rep.get("shard") is not None
                   else "")
            lines.append("")
            if rep.get("bundle"):
                lines.append(f"replica {tag}{rep.get('addr', '?')}")
                lines.extend(_one_bundle_lines(rep["bundle"]))
            else:
                lines.append(
                    f"replica {tag}{rep.get('addr', '?')}: NO BUNDLE "
                    f"({rep.get('error')})"
                )
        return "\n".join(lines)
    lines.append(f"debug bundle ({ver})")
    lines.extend(_one_bundle_lines(doc))
    return "\n".join(lines)


# --- tail-sampled exemplars --------------------------------------------


def load_exemplar_file(path: str) -> list[dict]:
    """Exemplar records from an ``exemplars.jsonl`` path or a debug dir
    holding one (rotated ``.1`` generation included, oldest first)."""
    from sieve_torch.service.exemplar import EXEMPLAR_FILE, load_exemplars

    if os.path.isdir(path):
        path = os.path.join(path, EXEMPLAR_FILE)
    out: list[dict] = []
    if os.path.exists(path + ".1"):
        out.extend(load_exemplars(path + ".1"))
    try:
        out.extend(load_exemplars(path))
    except OSError as e:
        if not out:
            raise TraceLoadError(f"{path}: {e.strerror or e}") from None
    if not out:
        raise TraceLoadError(f"{path}: no exemplar records")
    return out


def exemplar_report(recs: list[dict], top: int = 10) -> str:
    """Terminal rendering of kept exemplars (pure function): retention
    breakdown, kept-latency sparkline, then the ``top`` slowest kept
    requests with their span trees and downstream shard exemplars."""
    by_reason: dict[str, int] = {}
    by_outcome: dict[str, int] = {}
    for r in recs:
        by_reason[r.get("reason", "?")] = by_reason.get(
            r.get("reason", "?"), 0) + 1
        by_outcome[r.get("outcome", "?")] = by_outcome.get(
            r.get("outcome", "?"), 0) + 1
    lines = [
        f"exemplars: {len(recs)} kept",
        "  by reason:  " + "  ".join(
            f"{k}={v}" for k, v in sorted(by_reason.items())),
        "  by outcome: " + "  ".join(
            f"{k}={v}" for k, v in sorted(by_outcome.items())),
        "  kept latency (ms, keep order): "
        + _sparkline([r.get("ms") for r in recs]),
    ]
    slow = sorted(recs, key=lambda r: r.get("ms") or 0.0,
                  reverse=True)[:top]
    lines.append(f"  slowest {len(slow)} kept:")
    for r in slow:
        tag = (f"[{r.get('role', '?')}] {r.get('op', '?'):<10} "
               f"{(r.get('ms') or 0.0):>9.3f} ms  "
               f"reason={r.get('reason')} outcome={r.get('outcome')}")
        if r.get("ctx"):
            tag += f"  ctx={r['ctx']}"
        if r.get("shards") is not None:
            tag += f"  shards={r['shards']}"
        lines.append(f"    {tag}")
        for s in (r.get("spans") or [])[-8:]:
            dur = s.get("dur")
            dur_ms = f"{dur / 1e3:.3f} ms" if dur is not None else "-"
            lines.append(f"      {s.get('name', '?'):<28} {dur_ms:>12}")
        for d in r.get("downstream") or []:
            lines.append(
                f"      ↳ shard {d.get('shard', '?')} "
                f"{d.get('addr', '?')}: {d.get('op', '?')} "
                f"{(d.get('ms') or 0.0):.3f} ms "
                f"reason={d.get('reason')} "
                f"spans={len(d.get('spans') or ())}"
            )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="summarize a sieve --trace file (Chrome trace-event "
        "JSON) as per-phase totals, device-idle windows, and slowest spans"
    )
    p.add_argument("trace_file")
    p.add_argument("--top", type=int, default=10,
                   help="how many slowest spans to list")
    p.add_argument("--cluster", action="store_true",
                   help="distributed view of a merged cpu-cluster trace: "
                        "per-worker utilization, rpc-wait vs compute, "
                        "stragglers, clock-alignment error")
    p.add_argument("--routed", action="store_true",
                   help="fleet view of a merged router trace: rpc.route "
                        "<-> shard rpc.query correlation, per-replica "
                        "tracks, clock-alignment error")
    p.add_argument("--bundle", action="store_true",
                   help="render a flight-recorder postmortem bundle "
                        "(bundle.json, fleet_bundle.json, or a bundle "
                        "directory) instead of a trace")
    p.add_argument("--exemplars", action="store_true",
                   help="render a tail-sampled exemplar file "
                        "(exemplars.jsonl or the --debug-dir holding "
                        "one): retention breakdown + slowest kept span "
                        "trees")
    args = p.parse_args(argv)
    if args.exemplars:
        try:
            recs = load_exemplar_file(args.trace_file)
        except TraceLoadError as e:
            print(f"trace_report: error: {e}", file=sys.stderr)
            return 1
        print(exemplar_report(recs, top=args.top))
        return 0
    if args.bundle:
        try:
            doc = load_bundle(args.trace_file)
        except TraceLoadError as e:
            print(f"trace_report: error: {e}", file=sys.stderr)
            return 1
        print(bundle_report(doc))
        return 0
    try:
        events = load_all(args.trace_file)
    except TraceLoadError as e:
        print(f"trace_report: error: {e}", file=sys.stderr)
        return 1
    if args.cluster:
        print(cluster_report(events, top=args.top))
        return 0
    if args.routed:
        print(routed_report(events))
        return 0
    spans = sorted((e for e in events if e.get("ph") == "X"),
                   key=lambda e: e["ts"])
    if not spans:
        print("no span events in trace", file=sys.stderr)
        return 1
    print(report(spans, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
