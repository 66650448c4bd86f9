"""Live fleet telemetry: poll a sieve router + every shard replica into
one refreshing terminal table. The port of the reference's
``tools/fleet_top.py``: the same fleet, or the same replies, render the
same text and JSON and exit with the same code in both. Host code: it
loads no torch.

Each poll asks the router for health (which names every shard replica
address), stats, and the new ``metrics`` wire op, then asks each replica
for the same three. The rendered table shows, per replica: lane queue
depths, shed/demotion rates, LRU and cold-cache hit rates, cold dispatch
rate, the cold-backend class column (``mesh/DxF`` = D mesh devices at
last-drain chunk fanout F, or the loop backend name),
the segment-store column (hit ratio / demotions, plus a ``T<n>``
torn-entry marker), covered_hi, the worst per-op SLO
burn, and the ``hot frame`` column (the top self-time frame
from a cached low-rate pull of each process's continuous profiler,
refreshed at most every 10s) — plus a router header
with request rate, totals-cache hit rate, telemetry merge/gap counters,
and fabric coverage contiguity. Rates are deltas between consecutive
polls; the first frame shows totals only.

Percentiles with zero observations render as ``-`` — never a fake 0.

``--json`` takes one poll and prints the raw snapshot as a
single JSON document for scripts and cron probes — no table, no screen
clear — exiting 1 if the router is unreachable or any shard/replica row
would render DOWN or UNREACHABLE.

Usage:
    python -m sieve_torch.tools.fleet_top 127.0.0.1:7733 [--interval 2.0] [--once]
    python -m sieve_torch.tools.fleet_top 127.0.0.1:7733 --json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any

from sieve_torch.profile import self_times
from sieve_torch.service.client import ClientPool, ServiceClient
from sieve_torch.tools.trace_report import _sparkline

_CLEAR = "\x1b[2J\x1b[H"

# snapshots of trend history per sparkline cell (--observe-dir)
_TREND_DEPTH = 30

# the hot-frame column refreshes its per-endpoint profile
# pull at most this often — a watch session must not turn the profiler
# into a per-poll tax
_PROF_REFRESH_S = 10.0


def _hot_frame(profile: dict | None) -> str:
    """Top SELF-time frame of one endpoint's profile document, or ``-``
    (profiler disabled, or no samples yet)."""
    if not profile:
        return "-"
    merged = {r["stack"]: {"count": r["count"], "role": r.get("role")}
              for r in profile.get("stacks") or []}
    rows = self_times(merged, 1)
    if not rows:
        return "-"
    return f"{rows[0]['frame']} {rows[0]['share']:.0%}"


def _hot_frame_cached(cli: "ServiceClient", addr: str,
                      prof_cache: dict | None) -> str:
    """The endpoint's hot frame from a cached low-rate profile pull.

    A failed pull (old server, ``svc_prof_gap`` drop) degrades to the
    cached cell — never the row's health."""
    if prof_cache is None:
        try:
            return _hot_frame(cli.profile())
        except Exception:  # noqa: BLE001
            return "-"
    now = time.time()
    ent = prof_cache.get(addr)
    if ent is not None and now - ent[0] < _PROF_REFRESH_S:
        return ent[1]
    cell = ent[1] if ent is not None else "-"
    try:
        cell = _hot_frame(cli.profile())
    except Exception:  # noqa: BLE001 — keep the stale cell
        pass
    prof_cache[addr] = (now, cell)
    return cell


def _poll(addr: str, timeout_s: float,
          pool: ClientPool | None = None,
          prof_cache: dict | None = None) -> dict[str, Any]:
    """health + stats + metrics of one endpoint, or a named error.

    With a ``pool`` the endpoint's pipelined connection is
    reused across refresh cycles — one TCP connect per target for the
    whole watch session instead of one per poll — and a transport
    failure invalidates just that entry so the next cycle reconnects
    (counted in ``pool.reconnects``)."""
    try:
        if pool is not None:
            cli = pool.get(addr)
            return {
                "addr": addr,
                "health": cli.health(),
                "stats": cli.stats(),
                "metrics": cli.metrics(),
                "hot_frame": _hot_frame_cached(cli, addr, prof_cache),
                "error": None,
            }
        with ServiceClient(addr, timeout_s=timeout_s) as cli:
            return {
                "addr": addr,
                "health": cli.health(),
                "stats": cli.stats(),
                "metrics": cli.metrics(),
                "hot_frame": _hot_frame_cached(cli, addr, prof_cache),
                "error": None,
            }
    except Exception as e:  # noqa: BLE001 — a dead replica is a table row
        if pool is not None:
            pool.invalidate(addr)
        return {"addr": addr, "health": None, "stats": None,
                "metrics": None, "hot_frame": "-",
                "error": f"{type(e).__name__}: {e}"}


def fleet_snapshot(router_addr: str, timeout_s: float = 5.0,
                   pool: ClientPool | None = None,
                   prof_cache: dict | None = None) -> dict:
    """One poll of the whole fleet (pure data; rendering is separate).

    Returns ``{"ts": epoch_s, "router": {...}, "shards": [...]}`` where
    each shard entry carries the router's view (range, status) plus a
    polled row per replica address. Pass one :class:`ClientPool` across
    consecutive calls to reuse every endpoint's connection, and one
    ``prof_cache`` dict to rate-limit the hot-frame profile pulls
    to one per endpoint per ``_PROF_REFRESH_S``."""
    router = _poll(router_addr, timeout_s, pool, prof_cache)
    shards: list[dict[str, Any]] = []
    h = router["health"]
    if h is not None:
        for ent in h.get("shards", []):
            shards.append({
                "shard": ent.get("shard"),
                "lo": ent.get("lo"),
                "hi": ent.get("hi"),
                "status": ent.get("status"),
                "replicas": [
                    _poll(a, timeout_s, pool, prof_cache)
                    for a in ent.get("addrs", [])
                ],
            })
    return {"ts": time.time(), "router": router, "shards": shards}


def fleet_ok(snap: dict) -> bool:
    """True when every row of a snapshot would render healthy.

    False if the router itself is unreachable, any shard's router-side
    status is down/unreachable, or any replica poll came back without a
    health block (the table's DOWN rows)."""
    if snap["router"]["health"] is None:
        return False
    for sh in snap["shards"]:
        if str(sh.get("status", "")).lower() in ("down", "unreachable"):
            return False
        for rep in sh["replicas"]:
            if rep["health"] is None:
                return False
    return True


def ring_trends(observe_dir: str,
                depth: int = _TREND_DEPTH) -> dict[str, dict[str, list]]:
    """Per-endpoint signal series from the observer's snapshot ring:
    ``{addr: {signal: [newest depth values...]}}``. The
    observer daemon persists the ring; this reader tolerates a racing
    appender (torn tails skip) and an absent file (empty trends)."""
    from sieve_torch.service.observe import RING_FILE, read_ring

    out: dict[str, dict[str, list]] = {}
    path = os.path.join(observe_dir, RING_FILE)
    for snap in read_ring(path)[-depth:]:
        for tgt in snap.get("targets", []):
            sig = tgt.get("signals")
            if not isinstance(sig, dict):
                continue  # gap row: no fabricated point
            series = out.setdefault(tgt.get("addr", "?"), {})
            for name, val in sig.items():
                series.setdefault(name, []).append(val)
    return out


def _trend_cell(trends: dict | None, addr: str, signal: str) -> str:
    if not trends or addr not in trends:
        return "-"
    return _sparkline(trends[addr].get(signal) or [])


def _rate(cur: dict | None, prev: dict | None, key: str,
          dt: float | None) -> str:
    """Per-second delta between polls, or the running total on frame 1."""
    if cur is None:
        return "-"
    v = cur.get(key)
    if v is None:
        return "-"
    if prev is None or dt is None or dt <= 0 or prev.get(key) is None:
        return str(v)
    return f"{max(0, v - prev[key]) / dt:.1f}/s"


def _ratio(num: int | None, den: int | None) -> str:
    if not den:
        return "-"
    return f"{100.0 * (num or 0) / den:.0f}%"


def _worst_burn(stats: dict | None) -> str:
    """Worst per-op SLO burn from a replica's ``slo`` stats block; ``-``
    when no SLOs are set or no op has observations yet."""
    if not stats:
        return "-"
    slo = stats.get("slo") or {}
    burns = [v.get("burn") for v in slo.values()
             if isinstance(v, dict) and v.get("burn") is not None]
    if not burns:
        return "-"
    worst = max(burns)
    return f"{worst:.2f}x" + ("!" if worst > 1.0 else "")


def _store_cell(stats: dict | None) -> str:
    """``hit%/demotions`` from the nested segment-store stats block,
    or ``-`` when the replica runs without a store."""
    if not stats:
        return "-"
    st = stats.get("store")
    if not st:
        return "-"
    hits = st.get("hits") or 0
    misses = st.get("misses") or 0
    hit = _ratio(hits, hits + misses)
    cell = f"{hit}/{st.get('demotions', 0)}"
    torn = st.get("torn") or 0
    return cell + (f" T{torn}" if torn else "")


def _cold_cell(stats: dict | None) -> str:
    """Cold-plane worker class: ``mesh/DxF`` for a mesh
    replica (D devices, F chunks in the last drain fanout), the plain
    backend name otherwise, ``-`` for pre-mesh servers."""
    if not stats:
        return "-"
    backend = stats.get("cold_backend")
    if not backend:
        return "-"
    if str(backend).startswith("mesh") and stats.get("mesh_devices"):
        return (f"mesh/{stats.get('mesh_devices')}"
                f"x{stats.get('mesh_fanout', 0)}")
    return str(backend)


def _prev_stats(prev: dict | None, shard: int | None,
                addr: str) -> dict | None:
    if prev is None:
        return None
    for sh in prev.get("shards", []):
        if sh.get("shard") != shard:
            continue
        for rep in sh.get("replicas", []):
            if rep.get("addr") == addr:
                return rep.get("stats")
    return None


def render(snap: dict, prev: dict | None = None,
           trends: dict | None = None) -> str:
    """One text frame from a :func:`fleet_snapshot` (pure function).

    ``trends`` (from :func:`ring_trends`, the ``--observe-dir`` mode)
    appends per-endpoint hot-qps and shed-rate sparkline columns fed
    from the observer daemon's snapshot ring."""
    lines: list[str] = []
    dt = (snap["ts"] - prev["ts"]) if prev else None
    r = snap["router"]
    rh, rs, rm = r["health"], r["stats"], r["metrics"]
    if rh is None:
        return f"router {r['addr']}: UNREACHABLE ({r['error']})"
    covered = rh.get("covered_hi") or 0
    hi = rh.get("range_hi") or 0
    contiguous = covered >= hi
    tot_hit = (rm.get("router.totals_hit") or {}).get("value", 0)
    tot_miss = (rm.get("router.totals_miss") or {}).get("value", 0)
    lines.append(
        f"router {r['addr']}  status={rh.get('status')}  "
        f"shards={rh.get('shard_count')}  "
        f"range=[{rh.get('range_lo')}, {hi})  "
        f"covered_hi={covered} "
        f"({'contiguous' if contiguous else 'GAP'})"
    )
    prs = prev["router"]["stats"] if prev and prev["router"]["stats"] else None
    lines.append(
        f"  requests={_rate(rs, prs, 'requests', dt)}  "
        f"scattered={_rate(rs, prs, 'scattered', dt)}  "
        f"totals-cache hit={_ratio(tot_hit, tot_hit + tot_miss)}  "
        f"telemetry merged={rs.get('telemetry_merged', 0)} "
        f"gaps={rs.get('telemetry_gaps', 0)}  "
        f"failovers={rs.get('failovers', 0)}  "
        f"hot={r.get('hot_frame', '-')}"
    )
    lines.append("")
    trend_hdr = (f" {'hot trend':>{_TREND_DEPTH}} "
                 f"{'shed trend':>{_TREND_DEPTH}}"
                 if trends is not None else "")
    lines.append(
        f"  {'replica':<22} {'st':<4} {'hot':>4} {'cold':>4} "
        f"{'shed':>8} {'demote':>8} {'lru':>5} {'ccache':>6} "
        f"{'colddisp':>9} {'cbackend':>10} {'store':>12} "
        f"{'covered_hi':>11} {'slo burn':>9} {'hot frame':<28}"
        + trend_hdr
    )
    for sh in snap["shards"]:
        for rep in sh["replicas"]:
            name = f"s{sh['shard']} {rep['addr']}"
            if rep["health"] is None:
                lines.append(f"  {name:<22} DOWN ({rep['error']})")
                continue
            h, st = rep["health"], rep["stats"]
            ps = _prev_stats(prev, sh["shard"], rep["addr"])
            shed = (st.get("shed", 0) + st.get("lane_shed_hot", 0)
                    + st.get("lane_shed_cold", 0))
            shed_r = _rate({"shed_all": shed},
                           {"shed_all": ((ps.get("shed", 0)
                                          + ps.get("lane_shed_hot", 0)
                                          + ps.get("lane_shed_cold", 0))
                                         if ps else None)},
                           "shed_all", dt)
            lru = _ratio(st.get("lru_hits"),
                         (st.get("lru_hits") or 0)
                         + (st.get("cold_computes") or 0))
            ccache = _ratio(st.get("cold_cache_hits"),
                            (st.get("cold_cache_hits") or 0)
                            + (st.get("cold_dispatches") or 0))
            trend_cells = (
                f" {_trend_cell(trends, rep['addr'], 'hot_qps'):>{_TREND_DEPTH}}"
                f" {_trend_cell(trends, rep['addr'], 'shed_rate'):>{_TREND_DEPTH}}"
                if trends is not None else ""
            )
            lines.append(
                f"  {name:<22} {str(h.get('status', '?'))[:4]:<4} "
                f"{h.get('queue_depth_hot', 0):>4} "
                f"{h.get('queue_depth_cold', 0):>4} "
                f"{shed_r:>8} {_rate(st, ps, 'demoted', dt):>8} "
                f"{lru:>5} {ccache:>6} "
                f"{_rate(st, ps, 'cold_dispatches', dt):>9} "
                f"{_cold_cell(st):>10} "
                f"{_store_cell(st):>12} "
                f"{h.get('covered_hi', 0):>11} {_worst_burn(st):>9} "
                f"{rep.get('hot_frame', '-'):<28}"
                + trend_cells
            )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="live fleet table over a sieve router and its shard "
                    "replicas (health + stats + the metrics wire op)"
    )
    p.add_argument("router_addr", help="router host:port")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between polls (default 2)")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="per-endpoint RPC timeout")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit (no screen clear)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="one poll, raw snapshot as a single JSON document; "
                        "exit 1 if any row is DOWN or UNREACHABLE")
    p.add_argument("--observe-dir", default=None,
                   help="a `python -m sieve_torch observe` --observe-dir: adds "
                        "per-replica hot-qps / shed-rate sparkline "
                        "columns fed from the observer's snapshot ring")
    args = p.parse_args(argv)
    if args.as_json:
        snap = fleet_snapshot(args.router_addr, timeout_s=args.timeout)
        print(json.dumps(snap))
        return 0 if fleet_ok(snap) else 1
    prev: dict | None = None
    # one pipelined client per endpoint, reused across refresh cycles
    # a watch session costs one connect per target, not one
    # per poll; reconnects are counted and shown in the header
    # the hot-frame cells refresh from a rate-limited profile pull
    # one per endpoint per _PROF_REFRESH_S, not per poll
    prof_cache: dict = {}
    with ClientPool(timeout_s=args.timeout) as pool:
        try:
            while True:
                snap = fleet_snapshot(args.router_addr,
                                      timeout_s=args.timeout, pool=pool,
                                      prof_cache=prof_cache)
                trends = (ring_trends(args.observe_dir)
                          if args.observe_dir else None)
                frame = render(snap, prev, trends=trends)
                if args.once:
                    print(frame)
                    return 0 if snap["router"]["health"] is not None else 1
                print(f"{_CLEAR}{time.strftime('%H:%M:%S')}  "
                      f"(every {args.interval:g}s, ctrl-C to quit)  "
                      f"[conns={pool.connects} "
                      f"reconnects={pool.reconnects}]")
                print(frame, flush=True)
                prev = snap
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
