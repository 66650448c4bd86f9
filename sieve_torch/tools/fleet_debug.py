"""Fleet-wide postmortem collection: pull every process's inline
flight-recorder bundle into ONE merged fleet bundle. The port of the reference's
``tools/fleet_debug.py``: the same fleet writes the same bundle and
exits with the same code in both. Host code: it loads no torch.

Asks the router for its ``debug`` wire op (answered inline by the
reader thread, so a wedged worker pool still dumps), reads the shard
replica addresses out of the router's health reply, pulls each
replica's bundle the same way, and writes the merged document as
``fleet_bundle.json`` under ``--out``. Render it with::

    python -m sieve_torch.tools.trace_report <out>/fleet_bundle.json --bundle

Exit 1 when the router is unreachable or any advertised replica failed
to hand over a bundle — a partial postmortem is still written (each
missing process carries its named error), but scripts must see the gap.

Usage:
    python -m sieve_torch.tools.fleet_debug 127.0.0.1:7733 [--out DIR] [--timeout S]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any

from sieve_torch.debug import FLEET_BUNDLE_VERSION
from sieve_torch.service.client import ClientPool, ServiceClient

FLEET_BUNDLE_FILE = "fleet_bundle.json"


def _pull(addr: str, timeout_s: float,
          pool: ClientPool | None = None) -> dict[str, Any]:
    """One endpoint's health + inline debug bundle, or a named error.

    With a ``pool`` the endpoint's pipelined connection is
    reused across calls; a transport failure invalidates just that
    entry (counted in ``pool.reconnects`` on the next pull)."""
    try:
        if pool is not None:
            cli = pool.get(addr)
            return {
                "addr": addr,
                "health": cli.health(),
                "bundle": cli.debug(),
                "error": None,
            }
        with ServiceClient(addr, timeout_s=timeout_s) as cli:
            return {
                "addr": addr,
                "health": cli.health(),
                "bundle": cli.debug(),
                "error": None,
            }
    except Exception as e:  # noqa: BLE001 — a dead process is a gap row
        if pool is not None:
            pool.invalidate(addr)
        return {"addr": addr, "health": None, "bundle": None,
                "error": f"{type(e).__name__}: {e}"}


def collect(router_addr: str, timeout_s: float = 10.0,
            pool: ClientPool | None = None) -> dict:
    """One merged fleet bundle (pure data; writing is separate).

    The router's health reply advertises every shard replica address;
    each is pulled for its own inline bundle and tagged with its shard
    index. ``processes`` counts how many actually handed one over.
    Pass one :class:`ClientPool` across repeated collections to reuse
    every endpoint's connection."""
    router = _pull(router_addr, timeout_s, pool)
    replicas: list[dict[str, Any]] = []
    h = router["health"]
    if h is not None:
        for ent in h.get("shards", []):
            for addr in ent.get("addrs", []):
                rep = _pull(addr, timeout_s, pool)
                rep["shard"] = ent.get("shard")
                replicas.append(rep)
    processes = sum(
        1 for p in [router, *replicas] if p["bundle"] is not None
    )
    return {
        "bundle": FLEET_BUNDLE_VERSION,
        "ts": time.time(),
        "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "router": router,
        "replicas": replicas,
        "processes": processes,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="pull the flight-recorder bundle of a sieve router "
                    "and every shard replica into one merged fleet bundle"
    )
    p.add_argument("router_addr", help="router host:port")
    p.add_argument("--out", default=None,
                   help="output directory (default fleet-debug-<stamp>)")
    p.add_argument("--timeout", type=float, default=10.0,
                   help="per-endpoint RPC timeout")
    args = p.parse_args(argv)
    # one pipelined client per endpoint for the whole collection
    # the router is pulled once for its bundle and again
    # implicitly via health; both ride the same connection
    with ClientPool(timeout_s=args.timeout) as pool:
        fleet = collect(args.router_addr, timeout_s=args.timeout,
                        pool=pool)
    out = args.out or f"fleet-debug-{time.strftime('%Y%m%d-%H%M%S')}"
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, FLEET_BUNDLE_FILE)
    with open(path, "w") as f:
        json.dump(fleet, f, indent=1)
    unreachable = [p_["addr"] for p_ in [fleet["router"], *fleet["replicas"]]
                   if p_["bundle"] is None]
    print(json.dumps({
        "event": "fleet_bundle",
        "path": path,
        "processes": fleet["processes"],
        "unreachable": unreachable,
    }), flush=True)
    return 1 if unreachable else 0


if __name__ == "__main__":
    sys.exit(main())
