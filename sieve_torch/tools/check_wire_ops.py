"""Static check: the port's server and router wire surfaces cannot
drift. The port of the reference's ``tools/check_wire_ops.py``.

The router fronts the exact wire protocol the single server speaks, and
a wire op added to ``sieve_torch/service/server.py`` and forgotten in
``sieve_torch/service/router.py`` would bounce with ``bad_request:
unknown op`` only at runtime, behind a fleet. This tool regex-harvests
every literal op (``op == "..."``) and message type (``mtype == "..."``)
each dispatcher handles and asserts:

* every server query op is routed (and vice versa — the router must
  not invent ops the server cannot answer);
* every server message type is either routed or explicitly listed in
  ``router.UNROUTED_TYPES`` (typed-rejected, with the reason written
  next to the constant);
* the ``batch`` op and the ``profile`` message type appear on BOTH
  sides.

The LIVE leg, ``check_encodings``, sieves an n=2,000 ledger on the
``cuda`` backend (the fused kernel on a card, its plain version with
``--device cpu``), serves it from an in-process service and replays
every query op through a v1 (JSON) and a v2 (binary columns) client,
asserting the decoded results are byte-for-byte identical under
canonical JSON — the codec cannot change an answer, only its framing.
``check`` itself stays static (it loads no torch); ``main`` runs both
legs.

Usage: python -m sieve_torch.tools.check_wire_ops [--device D]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVER_PY = os.path.join(_PKG, "service", "server.py")
ROUTER_PY = os.path.join(_PKG, "service", "router.py")

# literal comparisons in the dispatchers; != catches the
# `if mtype != "query"` fall-through style
_OP_RE = re.compile(r'\bop\s*(?:==|!=)\s*"(\w+)"')
_MTYPE_RE = re.compile(r'\bmtype\s*(?:==|!=)\s*"(\w+)"')


def harvest(path: str) -> tuple[set[str], set[str]]:
    """(query ops, message types) a dispatcher source handles."""
    with open(path) as f:
        src = f.read()
    return set(_OP_RE.findall(src)), set(_MTYPE_RE.findall(src))


def check() -> list[str]:
    """Every wire-surface drift found; empty list means parity holds."""
    from sieve_torch.service import router as _router_mod

    server_ops, server_types = harvest(SERVER_PY)
    router_ops, router_types = harvest(ROUTER_PY)
    unrouted = set(getattr(_router_mod, "UNROUTED_TYPES", ()))
    problems: list[str] = []
    for op in sorted(server_ops - router_ops):
        problems.append(
            f"server op {op!r} is not handled by the router "
            "(add it to SieveRouter._execute or reject it explicitly)"
        )
    for op in sorted(router_ops - server_ops):
        problems.append(
            f"router op {op!r} has no server-side handler "
            "(SieveService._execute does not know it)"
        )
    for t in sorted(server_types - router_types - unrouted):
        problems.append(
            f"server message type {t!r} is neither routed nor listed "
            "in router.UNROUTED_TYPES"
        )
    for t in sorted(unrouted & router_types):
        problems.append(
            f"message type {t!r} is in router.UNROUTED_TYPES but the "
            "router handles it — stale entry"
        )
    for side, ops in (("server", server_ops), ("router", router_ops)):
        if "batch" not in ops:
            problems.append(f"the batch op is missing from the {side}")
    for side, types in (("server", server_types),
                        ("router", router_types)):
        if "profile" not in types:
            problems.append(f"the profile op is missing from the {side}")
    return problems


#: every query op, exercised with both a success and (where the op can
#: fail per-request) an error-shaped call — the live parity leg replays
#: each through both encodings
_ENCODING_PROBES: tuple[dict, ...] = (
    {"op": "pi", "x": 2},
    {"op": "pi", "x": 97},
    {"op": "pi", "x": 1_999},
    {"op": "is_prime", "x": 2},
    {"op": "is_prime", "x": 91},
    {"op": "count", "lo": 10, "hi": 1_500, "kind": "primes"},
    {"op": "count", "lo": 10, "hi": 1_500, "kind": "twins"},
    {"op": "count", "lo": 900, "hi": 10, "kind": "primes"},  # error
    {"op": "nth_prime", "k": 25},
    {"op": "primes", "lo": 0, "hi": 64},
    {"op": "primes", "lo": 100, "hi": 1_900},
    {"op": "primes", "lo": 1_999, "hi": 2_000},
    {"op": "nosuch"},  # error
)


def _strip(reply: dict) -> dict:
    """Drop per-call noise (timings, trace ids) before comparison."""
    return {k: v for k, v in reply.items()
            if k not in ("id", "elapsed_ms", "t_recv", "t_sent")}


def encoding_replies(device: str = "cuda") -> dict:
    """The live leg's replies: an n=2,000 wheel30 ledger in 2 segments
    sieved on the ``cuda`` backend on ``device`` (the card must exist),
    served in process, every probe through a v1 and a v2 client, then the
    batch of all probes through both. Returns ``{"wire_v": v2's version,
    "v1"/"v2": stripped replies, "batch_v1"/"batch_v2": the batch replies,
    "launches": fused launches during the leg, "device": the device}``."""
    import tempfile

    from sieve_torch.backends.cuda import resolve_device
    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local
    from sieve_torch.kernels.cuda_mark import mark_fused
    from sieve_torch.service import ServiceClient, ServiceSettings, SieveService

    dev = resolve_device(device)
    launches0 = mark_fused.launches
    out: dict = {"device": str(dev), "v1": [], "v2": []}
    with tempfile.TemporaryDirectory(prefix="wire_enc_") as tmp:
        cfg = SieveConfig(n=2_000, backend="cuda", device=str(dev),
                          packing="wheel30", n_segments=2, quiet=True,
                          checkpoint_dir=tmp)
        run_local(cfg)
        settings = ServiceSettings(workers=2, queue_limit=16,
                                   default_deadline_s=10.0, refresh_s=0.0)
        with SieveService(cfg, settings) as svc:
            with ServiceClient(svc.addr, timeout_s=30,
                               negotiate=False) as v1, \
                    ServiceClient(svc.addr, timeout_s=30,
                                  negotiate=True) as v2:
                out["wire_v"] = v2.wire_v
                if v2.wire_v >= 2:
                    for probe in _ENCODING_PROBES:
                        out["v1"].append(_strip(v1.query(**probe)))
                        out["v2"].append(_strip(v2.query(**probe)))
                    items = [dict(p) for p in _ENCODING_PROBES]
                    out["batch_v1"] = v1.query_batch(items)
                    out["batch_v2"] = v2.query_batch(items)
    out["launches"] = mark_fused.launches - launches0
    return out


def check_encodings(got: dict) -> list[str]:
    """Live parity over ``encoding_replies``' result: every op through v1
    JSON and v2 binary must decode to identical results (and the batch of
    all probes member-for-member too). Returns mismatches; empty list
    means the codec is neutral."""
    import json

    if got["wire_v"] < 2:
        return ["v2 client failed to negotiate binary "
                f"framing (got wire_v={got['wire_v']})"]
    problems: list[str] = []
    for probe, a, b in zip(_ENCODING_PROBES, got["v1"], got["v2"]):
        if json.dumps(a, sort_keys=True) != json.dumps(b, sort_keys=True):
            problems.append(
                f"encoding divergence on {probe!r}: v1={a!r} v2={b!r}"
            )
    ba, bb = got["batch_v1"], got["batch_v2"]
    if json.dumps(ba, sort_keys=True) != json.dumps(bb, sort_keys=True):
        problems.append(
            f"encoding divergence on the batch op: v1={ba!r} v2={bb!r}"
        )
    return problems


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the live leg's ledger is sieved: cuda (the "
                         "fused kernel; the card must exist) or cpu (its "
                         "plain version)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    problems = check()
    static_n = len(problems)
    replies = None
    if not problems:
        # only bother booting the live service when the static surface
        # is coherent — a drift would fail the replay anyway
        replies = encoding_replies(args.device)
        problems = check_encodings(replies)
    for p in problems:
        print(f"check_wire_ops: {p}", file=sys.stderr)
    if problems:
        print(f"check_wire_ops: FAILED ({len(problems)} "
              f"{'drift(s)' if static_n else 'encoding mismatch(es)'})",
              file=sys.stderr)
        return 1
    server_ops, server_types = harvest(SERVER_PY)
    print(
        f"check_wire_ops: ok ({len(server_ops)} ops, "
        f"{len(server_types)} message types in parity; "
        f"{len(_ENCODING_PROBES)} probes + batch byte-identical "
        "under v1 JSON and v2 binary; the ledger sieved on "
        f"{replies['device']} with {replies['launches']} fused launches)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
