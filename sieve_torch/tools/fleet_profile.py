"""Fleet-wide flame pull: merge every process's continuous-profiler
table into ONE flamegraph-compatible collapsed file. The port of the reference's
``tools/fleet_profile.py``: the same fleet gives the same merge, tables
and exit code in both. Host code: it loads no torch.

Asks the router for its ``profile`` wire op (answered inline by the
per-connection reader, so a wedged worker pool still profiles), reads
the shard replica addresses out of the router's health reply, pulls
each replica's profile the same way, and merges them — each stack key
prefixed with its process label, so the flame keeps one cell per
process. Writes:

* ``fleet_profile.collapsed`` — ``stack count`` lines, hottest first
  (``flamegraph.pl`` / speedscope load this directly), and
* ``fleet_profile.json`` — the raw per-process documents plus the
  merged table, for ``--diff`` and the tests.

Also prints a top-N per-frame SELF-time table (samples where the frame
was the leaf — time in the frame itself, not its callees).

Exit 1 when the router is unreachable or any advertised replica failed
to hand over a profile (e.g. a ``svc_prof_gap`` chaos drop) — the
partial merge is still written, each missing process named, and the
next pull heals.

Diff two captures (anomaly-correlated flame diff)::

    python -m sieve_torch.tools.fleet_profile --diff before.json after.json

compares per-frame self-time SHARES (captures of different lengths
stay comparable); the top positive delta is the frame that got hotter.

Usage:
    python -m sieve_torch.tools.fleet_profile 127.0.0.1:7733 [--out DIR]
        [--timeout S] [--top N]
    python -m sieve_torch.tools.fleet_profile --diff OLD.json NEW.json [--top N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any

from sieve_torch.profile import (
    collapse_lines,
    diff_shares,
    merge_stacks,
    role_tagged_fraction,
    self_times,
)
from sieve_torch.service.client import ClientPool

FLEET_PROFILE_VERSION = "sieve-fleet-profile/1"
COLLAPSED_FILE = "fleet_profile.collapsed"
PROFILE_FILE = "fleet_profile.json"


def _pull(addr: str, pool: ClientPool) -> dict[str, Any]:
    """One endpoint's health + inline profile, or a named error."""
    try:
        cli = pool.get(addr)
        return {"addr": addr, "health": cli.health(),
                "profile": cli.profile(), "error": None}
    except Exception as e:  # noqa: BLE001 — a dropped reply is a gap row
        pool.invalidate(addr)
        return {"addr": addr, "health": None, "profile": None,
                "error": f"{type(e).__name__}: {e}"}


def collect(router_addr: str, pool: ClientPool) -> dict:
    """Pull router + every advertised replica; merge (pure data).

    Process labels — ``router`` and ``shard<k>[.r<i>]`` — become the
    first flame cell; a replica whose profiler is disabled (hz=0)
    contributes no stacks but is not an error."""
    router = _pull(router_addr, pool)
    router["label"] = "router"
    replicas: list[dict[str, Any]] = []
    h = router["health"]
    if h is not None:
        for ent in h.get("shards", []):
            addrs = ent.get("addrs", [])
            for i, addr in enumerate(addrs):
                rep = _pull(addr, pool)
                rep["shard"] = ent.get("shard")
                rep["label"] = (f"shard{ent.get('shard')}"
                                + (f".r{i}" if len(addrs) > 1 else ""))
                replicas.append(rep)
    merged = merge_stacks([
        (p["label"], p["profile"])
        for p in [router, *replicas] if p["profile"] is not None
    ])
    return {
        "profile": FLEET_PROFILE_VERSION,
        "ts": time.time(),
        "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "router": router,
        "replicas": replicas,
        "merged": {k: [v["count"], v["role"]] for k, v in merged.items()},
        "role_tagged_fraction": round(role_tagged_fraction(merged), 4),
    }


def load_merged(path: str) -> dict[str, dict]:
    """The merged stack table out of a saved ``fleet_profile.json``."""
    with open(path) as f:
        doc = json.load(f)
    return {k: {"count": v[0], "role": v[1]}
            for k, v in doc.get("merged", {}).items()}


def _print_self_times(merged: dict[str, dict], top: int) -> None:
    rows = self_times(merged, top)
    print(f"{'self':>6}  {'share':>6}  frame")
    for r in rows:
        print(f"{r['self']:>6}  {r['share']:>6.1%}  {r['frame']}")


def run_diff(old_path: str, new_path: str, top: int) -> int:
    old, new = load_merged(old_path), load_merged(new_path)
    rows = diff_shares(old, new, top)
    print(f"{'delta':>7}  {'before':>7}  {'after':>7}  frame")
    for r in rows:
        print(f"{r['delta']:>+7.1%}  {r['before']:>7.1%}  "
              f"{r['after']:>7.1%}  {r['frame']}")
    print(json.dumps({
        "event": "fleet_profile_diff",
        "old": old_path, "new": new_path,
        "top_delta": rows[0]["frame"] if rows else None,
        "frames": len(rows),
    }), flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="merge the continuous-profiler tables of a sieve "
                    "router and every shard replica into one "
                    "flamegraph-compatible collapsed capture"
    )
    p.add_argument("router_addr", nargs="?", default=None,
                   help="router host:port (omit with --diff)")
    p.add_argument("--out", default=None,
                   help="output directory (default fleet-profile-<stamp>)")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="per-endpoint RPC timeout")
    p.add_argument("--top", type=int, default=15,
                   help="rows in the self-time / diff table")
    p.add_argument("--diff", nargs=2, metavar=("OLD", "NEW"),
                   help="diff two saved fleet_profile.json captures "
                        "(per-frame self-time share deltas)")
    args = p.parse_args(argv)

    if args.diff:
        return run_diff(args.diff[0], args.diff[1], args.top)
    if not args.router_addr:
        p.error("router_addr is required unless --diff is given")

    with ClientPool(timeout_s=args.timeout) as pool:
        fleet = collect(args.router_addr, pool)
    merged = {k: {"count": v[0], "role": v[1]}
              for k, v in fleet["merged"].items()}

    out = args.out or f"fleet-profile-{time.strftime('%Y%m%d-%H%M%S')}"
    os.makedirs(out, exist_ok=True)
    collapsed_path = os.path.join(out, COLLAPSED_FILE)
    with open(collapsed_path, "w") as f:
        f.write("\n".join(collapse_lines(merged)) + "\n")
    json_path = os.path.join(out, PROFILE_FILE)
    with open(json_path, "w") as f:
        json.dump(fleet, f, indent=1)

    _print_self_times(merged, args.top)
    unreachable = [p_["label"] for p_ in
                   [fleet["router"], *fleet["replicas"]]
                   if p_["error"] is not None]
    print(json.dumps({
        "event": "fleet_profile",
        "collapsed": collapsed_path,
        "json": json_path,
        "processes": 1 + len(fleet["replicas"]) - len(unreachable),
        "unreachable": unreachable,
        "samples": sum(r["count"] for r in merged.values()),
        "role_tagged_fraction": fleet["role_tagged_fraction"],
    }), flush=True)
    return 1 if unreachable else 0


if __name__ == "__main__":
    sys.exit(main())
