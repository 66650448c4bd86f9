"""The port's range-sharded fabric against the reference's
(sieve/service/{shards,router}.py).

The reference's counting run writes one ledger per packing (``N``, 4
segments); it is split 2+2 at a segment boundary ``E`` into two shard
directories, and every server of every fabric gets its own byte-identical
copy of its shard's directory (each server writes the segment store it
keeps there). A fabric is shard 0 ``[2, E)`` and shard 1 ``[E, N + 1)``
(served with ``range_lo=E``) behind one router. The reference fabric is
the reference's servers on ``cpu-numpy`` behind the reference's router;
the port's fabric is the port's servers on ``cpu-numpy`` or on ``cuda``
with ``device="cpu"`` (the fused kernel's plain version) behind the port's
router. Mixed fabrics put the port's router over the reference's servers
and the reference's router over the port's servers. Every fabric gets the
same queries with equal settings, in v1 and in v2 frames; its replies must
equal the reference fabric's except for the wall-clock fields
``WALL_CLOCK`` of tests/test_torch_service.py, with the replicas'
addresses named by their place in the map. From ``stats`` the
latency-driven ``exemplars_kept`` and ``exemplar_pulls`` are left out.

Then the reference's tests/test_router.py on the port's fabric (shards on
``cuda``/``device="cpu"``): ShardMap's errors by name and message, its
wire-ins and geometry (each equal to the reference's), routing math
against the oracle, pairs straddling the edge, the deadline partial (the
same contiguous prefix as the reference's), a whole shard down, shed
propagation, drain, ``svc_shard_down``, failover, the health and stats
key schemas, the probe-TTL counters, ``--range-lo``, and the router's
events against the schema. RouterSettings' fields, defaults, ``validate``
errors and ``from_env`` variables equal the reference's. The reference's
trace-report test runs on the port's tool in
tests/test_torch_trace_report.py, and its shard-smoke test on the port's
smoke in tests/test_torch_fleet_smokes.py.
"""

import dataclasses
import json
import re
import shutil
import socket
import time
import types
from pathlib import Path

import numpy as np
import pytest

import sieve.service as ref_service
import sieve.service.router as ref_router
import sieve.service.shards as ref_shards
from sieve.checkpoint import Ledger as RefLedger
from sieve.config import SieveConfig as RefConfig
from sieve.coordinator import run_local as ref_run_local
from sieve.seed import seed_primes
import sieve_torch.service as port_service
import sieve_torch.service.router as port_router
import sieve_torch.service.shards as port_shards
from sieve_torch.chaos import ANY_WORKER, KINDS, ROUTER_REQUEST_KINDS, parse_chaos
from sieve_torch.config import PACKINGS, SieveConfig
from sieve_torch.metrics import registry, validate_record
from sieve_torch.service import (
    ReplicaSet,
    RouterSettings,
    ServiceClient,
    Shard,
    ShardMap,
    SieveRouter,
    SieveService,
)
from tests.test_torch_service import memsink, plain  # noqa: F401 — fixture

N = 50_000
P = seed_primes(200_000)
STATS_VOLATILE = frozenset({"exemplars_kept", "exemplar_pulls"})


def o_pi(x):
    return int(np.searchsorted(P, x, side="right"))


def o_count(lo, hi):
    return int(np.searchsorted(P, hi, side="left")
               - np.searchsorted(P, lo, side="left"))


def o_primes(lo, hi):
    return [int(v) for v in P[(P >= lo) & (P < hi)]]


def o_pairs(lo, hi, gap):
    w = P[(P >= lo) & (P < hi)]
    if w.size < 2:
        return 0
    idx = np.searchsorted(w, w + gap)
    ok = idx < w.size
    return int(np.count_nonzero(w[idx[ok]] == w[ok] + gap))


# --- the two packages, side by side ------------------------------------------


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's servers (config, backend, placement) or router."""

    svc: types.ModuleType
    config: type
    backend: str
    device: str | None

    def cfg(self, checkpoint_dir, packing="wheel30", **kw):
        base = dict(n=N, backend=self.backend, packing=packing, n_segments=4,
                    quiet=True, checkpoint_dir=checkpoint_dir)
        if self.device is not None:
            base["device"] = self.device
        base.update(kw)
        return self.config(**base)

    def settings(self, **kw):
        base = dict(workers=2, queue_limit=16, default_deadline_s=10.0,
                    refresh_s=0.0)
        base.update(kw)
        return self.svc.ServiceSettings(**base)


REF = Side(ref_service, RefConfig, "cpu-numpy", None)
PORT_NUMPY = Side(port_service, SieveConfig, "cpu-numpy", "cpu")
PORT_CUDA = Side(port_service, SieveConfig, "cuda", "cpu")


def split_ledger(src_dir, dest: Path, packing="wheel30"):
    """Split the source ledger's 4 segments 2+2 into two shard dirs
    under ``dest``; returns (shard0_dir, shard1_dir, E), E on a segment
    boundary."""
    segs = sorted(
        RefLedger.open_readonly(REF.cfg(str(src_dir), packing)).completed().values(),
        key=lambda r: r.lo,
    )
    E = segs[2].lo
    dirs = (dest / "shard0", dest / "shard1")
    for d, part in zip(dirs, (segs[:2], segs[2:])):
        led = RefLedger.open(REF.cfg(str(d), packing))
        for r in part:
            led.record(r)
    return str(dirs[0]), str(dirs[1]), E


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """Per packing: pristine (shard0_dir, shard1_dir, E), never served in
    place."""
    out = {}
    for packing in PACKINGS:
        root = tmp_path_factory.mktemp(f"fabric_{packing}")
        ref_run_local(REF.cfg(str(root / "src"), packing))
        out[packing] = split_ledger(root / "src", root, packing)
    return out


_copies = iter(range(10**9))


def fresh_copy(src: str, tmp_path: Path) -> str:
    dest = tmp_path / f"copy{next(_copies)}"
    shutil.copytree(src, dest)
    return str(dest)


class Fabric:
    """Shard 0 and shard 1 (``shard1_replicas`` servers) of ``shards``
    behind a router of ``router``; each server over its own copy."""

    def __init__(self, split, tmp_path, packing="wheel30", shards=PORT_CUDA,
                 router=PORT_CUDA, router_settings=None, shard1_chaos=None,
                 shard1_replicas=1, wire_v2=True, shard_settings=None):
        d0, d1, self.E = split
        sset = dict(shard_settings or {})
        self.svcs = []
        try:
            self.svcs.append(shards.svc.SieveService(
                shards.cfg(fresh_copy(d0, tmp_path), packing),
                shards.settings(**sset)).start())
            for i in range(shard1_replicas):
                self.svcs.append(shards.svc.SieveService(
                    shards.cfg(fresh_copy(d1, tmp_path), packing,
                               chaos=shard1_chaos if i == 0 else None),
                    shards.settings(range_lo=self.E, **sset)).start())
            self.map = router.svc.ShardMap([
                router.svc.Shard(2, self.E, (self.svcs[0].addr,)),
                router.svc.Shard(self.E, N + 1,
                                 tuple(s.addr for s in self.svcs[1:])),
            ])
            rs = router_settings or {}
            self.router = router.svc.SieveRouter(
                self.map, router.svc.RouterSettings(
                    **{"quiet": True, "wire_v2": wire_v2, **rs})).start()
        except BaseException:
            for s in self.svcs:
                s.stop()
            raise
        self.cli = router.svc.ServiceClient(self.router.addr, timeout_s=30,
                                            negotiate=wire_v2)

    def named(self, reply):
        """``reply`` as plain data with each replica's address replaced
        by its place in the map."""
        text = json.dumps(plain(reply), sort_keys=True)
        for i, s in enumerate(self.svcs):
            text = text.replace(s.addr, f"replica{i}")
        return json.loads(text)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cli.close()
        self.router.stop()
        for s in self.svcs:
            s.stop()


def _dead_addr():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here anymore
    return f"127.0.0.1:{port}"


# --- every routed op: the port's and the mixed fabrics == the reference's ----


BAD = "bad_request"


def _script(E):
    """(label, call on a client, oracle, ``BAD`` or None) for every routed
    op."""
    members = [{"op": "pi", "x": E - 1}, {"op": "pi", "x": N},
               {"op": "is_prime", "x": int(P[o_pi(E)])},
               {"op": "count", "lo": E - 500, "hi": E + 500},
               {"op": "count", "lo": 9, "hi": 4},
               {"op": "pi", "x": N + 2000}]
    q = [
        ("pi", {"x": N}, o_pi(N)),
        ("pi", {"x": 0}, 0),
        ("pi", {"x": 2}, 1),
        ("pi", {"x": E - 1}, o_pi(E - 1)),
        ("pi", {"x": E}, o_pi(E)),
        ("pi", {"x": E + 1}, o_pi(E + 1)),
        ("pi", {"x": N + 3000}, o_pi(N + 3000)),  # cold extension
        ("count", {"lo": E - 400, "hi": E + 400}, o_count(E - 400, E + 400)),
        ("count", {"lo": E - 400, "hi": E + 400, "kind": "twins"},
         o_pairs(E - 400, E + 400, 2)),
        ("count", {"lo": E - 400, "hi": E + 400, "kind": "cousins"},
         o_pairs(E - 400, E + 400, 4)),
        ("count", {"lo": 2, "hi": N + 1, "kind": "twins"},
         o_pairs(2, N + 1, 2)),
        ("count", {"lo": E - 1, "hi": E + 1}, o_count(E - 1, E + 1)),
        ("count", {"lo": 0, "hi": 100}, o_count(2, 100)),
        ("nth_prime", {"k": o_pi(E - 1) + 7}, int(P[o_pi(E - 1) + 6])),
        ("nth_prime", {"k": 10}, int(P[9])),
        ("nth_prime", {"k": o_pi(N) + 40}, int(P[o_pi(N) + 39])),
        ("primes", {"lo": E - 60, "hi": E + 60}, o_primes(E - 60, E + 60)),
        ("is_prime", {"x": int(P[o_pi(E)])}, True),
        ("is_prime", {"x": int(P[o_pi(E)]) + 1}, False),
        ("is_prime", {"x": 1}, False),
        ("count", {"lo": 9, "hi": 4}, BAD),
        ("count", {"lo": 2, "hi": 100, "kind": "sexy"}, BAD),
        ("nth_prime", {"k": 0}, BAD),
        ("frobnicate", {}, BAD),
    ]
    out = [(f"{op} {kw}", (lambda c, op=op, kw=kw: c.query(op, **kw)), want)
           for op, kw, want in q]
    out.append(("batch", lambda c: c.query_batch(members), None))
    out.append(("health", lambda c: c.health(), None))
    out.append(("stats", lambda c: {k: v for k, v in c.stats().items()
                                    if k not in STATS_VOLATILE}, None))
    out.append(("chaos refused", lambda c: c.inject_chaos("svc_shard_down:0@s99"),
                None))
    return out


# probes cached for the whole script, so no probe count depends on timing
_PARITY_ROUTER = {"probe_ttl_s": 60.0}
_ref_replies: dict = {}


def _run_script(fabric) -> list:
    got = []
    for label, call, want in _script(fabric.E):
        r = fabric.named(call(fabric.cli))
        if want is BAD:
            assert r["error"] == BAD, (label, r)
        elif want is not None:
            assert r.get("ok") and r["value"] == want, (label, r)
            assert r["source"] == "router", (label, r)
        got.append((label, r))
    return got


def _reference_replies(splits, packing, wire, tmp_path):
    key = (packing, wire)
    if key not in _ref_replies:
        with Fabric(splits[packing], tmp_path, packing, REF, REF,
                    router_settings=_PARITY_ROUTER, wire_v2=wire == "v2") as f:
            assert f.cli.wire_v == (2 if wire == "v2" else 1)
            _ref_replies[key] = _run_script(f)
    return _ref_replies[key]


FABRICS = [
    pytest.param((PORT_CUDA, PORT_CUDA), id="port-cuda"),
    pytest.param((PORT_NUMPY, PORT_NUMPY), id="port-numpy"),
    pytest.param((REF, PORT_CUDA), id="port-router-ref-shards"),
    pytest.param((PORT_CUDA, REF), id="ref-router-port-shards"),
]


@pytest.mark.parametrize("wire", ["v1", "v2"])
@pytest.mark.parametrize("packing", PACKINGS)
@pytest.mark.parametrize("fabric", FABRICS)
def test_fabric_replies_equal_reference(splits, tmp_path, fabric, packing, wire):
    shards, router = fabric
    want = _reference_replies(splits, packing, wire, tmp_path)
    with Fabric(splits[packing], tmp_path, packing, shards, router,
                router_settings=_PARITY_ROUTER, wire_v2=wire == "v2") as f:
        assert f.cli.wire_v == (2 if wire == "v2" else 1)
        got = _run_script(f)
        st = f.cli.stats()
    for (label, g), (_, w) in zip(got, want):
        assert g == w, label
    assert st["totals_cached"] == 2  # both full-shard totals learned
    assert st["spliced"] >= 2  # edge pair windows were stitched
    assert st["bad_requests"] == 4 and st["wire_downgrades"] == 0


# --- ShardMap: errors, wire-ins and geometry equal the reference's ----------


A, B = ("127.0.0.1:1",), ("127.0.0.1:2",)
BAD_MAPS = [
    pytest.param(lambda m: m.ShardMap([m.Shard(2, 100, A), m.Shard(120, 200, B)]),
                 "gap in shard map", id="gap"),
    pytest.param(lambda m: m.ShardMap([m.Shard(2, 100, A), m.Shard(90, 200, B)]),
                 "overlap in shard map", id="overlap"),
    pytest.param(lambda m: m.ShardMap([m.Shard(100, 200, A), m.Shard(2, 100, B)]),
                 "unsorted shard map", id="unsorted"),
    pytest.param(lambda m: m.ShardMap([]), "empty", id="empty"),
    pytest.param(lambda m: m.Shard(2, 10, A), "MIN_SPAN", id="narrow"),
    pytest.param(lambda m: m.Shard(0, 100, A), "lo must be >= 2", id="low"),
    pytest.param(lambda m: m.Shard(100, 100, A), "range empty", id="range-empty"),
    pytest.param(lambda m: m.Shard(2, 100, ()), "no addrs", id="no-addrs"),
    pytest.param(lambda m: m.ShardMap.from_flags(["2:1000"]), "bad --shard",
                 id="flag-form"),
    pytest.param(lambda m: m.ShardMap.from_flags(["2:x=127.0.0.1:1"]),
                 "bad shard bound", id="flag-bound"),
    pytest.param(lambda m: m.ShardMap.from_dict({"nope": []}), '"shards"',
                 id="json-key"),
    pytest.param(lambda m: m.ShardMap([m.Shard(2, 100, A)]).shard_for(1),
                 "below shard map range", id="below"),
    pytest.param(lambda m: m.ShardMap([m.Shard(2, 100, A)]).shards_in(0, 50),
                 "below shard map range", id="window-below"),
]


@pytest.mark.parametrize("build,match", BAD_MAPS)
def test_shardmap_errors_equal_reference(build, match):
    with pytest.raises(ValueError, match=match) as port_err:
        build(port_shards)
    with pytest.raises(ValueError) as ref_err:
        build(ref_shards)
    assert str(port_err.value) == str(ref_err.value)


def test_shardmap_flags_and_json_roundtrip(tmp_path):
    flags = ["2:1e3=127.0.0.1:7701,127.0.0.1:7702", "1e3:10**4=127.0.0.1:7711"]
    m = ShardMap.from_flags(flags)
    assert (m.lo, m.hi, len(m)) == (2, 10_000, 2)
    assert m.shards[0].addrs == ("127.0.0.1:7701", "127.0.0.1:7702")
    assert m.to_dict() == ref_shards.ShardMap.from_flags(flags).to_dict()
    path = tmp_path / "map.json"
    path.write_text(json.dumps(m.to_dict()))
    m2 = ShardMap.from_json(str(path))
    assert m2.to_dict() == m.to_dict()
    assert ref_shards.ShardMap.from_json(str(path)).to_dict() == m.to_dict()
    assert port_shards.MIN_SPAN == ref_shards.MIN_SPAN


def test_shardmap_geometry():
    def geometry(mod):
        m = mod.ShardMap([mod.Shard(2, 100, ("a",)), mod.Shard(100, 200, ("b",)),
                          mod.Shard(200, 300, ("c",))])
        return (m.edges(), [m.shard_for(x) for x in (2, 99, 100, 199, 200, 299,
                                                     10**9)],
                [m.shards_in(lo, hi) for lo, hi in ((50, 250), (150, 180),
                                                    (250, 400), (100, 100))])
    edges, owners, windows = geometry(port_shards)
    assert edges == [100, 200]
    assert owners == [0, 0, 1, 1, 2, 2, 2]  # beyond hi: last shard's cold tier
    assert windows == [[(0, 50, 100), (1, 100, 200), (2, 200, 250)],
                       [(1, 150, 180)], [(2, 250, 400)], []]
    assert geometry(ref_shards) == (edges, owners, windows)


# --- svc_shard_down grammar --------------------------------------------------


def test_svc_shard_down_grammar():
    assert "svc_shard_down" in KINDS
    assert ROUTER_REQUEST_KINDS == ("svc_shard_down",)
    (d,) = parse_chaos("svc_shard_down:1@s3:2.0")
    assert (d.kind, d.worker, d.seg_id, d.param) == ("svc_shard_down", 1, 3, 2.0)
    (d,) = parse_chaos("svc_shard_down:any@s5")
    assert (d.worker, d.param) == (ANY_WORKER, 1.0)  # default window
    assert d.to_wire() == {"kind": "svc_shard_down", "param": 1.0,
                           "worker": ANY_WORKER}
    with pytest.raises(ValueError, match="worker must be an integer"):
        parse_chaos("svc_shard_down:x@s3")
    with pytest.raises(ValueError, match="param must be a number"):
        parse_chaos("svc_shard_down:0@s3:soon")


# --- settings: the reference's fields, defaults, errors and variables --------


def _env_names(module) -> set[str]:
    src = Path(module.__file__).read_text()
    start = src.index("def from_env")
    body = src[start:src.index("return dataclasses.replace", start)]
    return set(re.findall(r'"(SIEVE_[A-Z0-9_]+)"', body))


BAD_ROUTER_SETTINGS = [
    {"default_deadline_s": 0}, {"timeout_s": -1.0}, {"probe_timeout_s": True},
    {"probe_ttl_s": -1.0}, {"drain_s": float("nan")}, {"rounds": 0},
    {"rounds": 1.5}, {"debug_cooldown_s": -2}, {"metrics_sample_s": -0.5},
    {"exemplar_slack": 0.5}, {"exemplar_baseline": 0}, {"exemplar_ring": -1},
    {"prof_hz": -1.0}, {"prof_stacks": 0},
]


def test_router_settings_equal_reference(monkeypatch):
    port_fields = [(f.name, f.default) for f in dataclasses.fields(RouterSettings)]
    ref_fields = [(f.name, f.default)
                  for f in dataclasses.fields(ref_router.RouterSettings)]
    assert port_fields == ref_fields
    refused = 0
    for bad in BAD_ROUTER_SETTINGS:
        errs = []
        for cls in (RouterSettings, ref_router.RouterSettings):
            try:
                cls(**bad).validate()
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], bad
        refused += errs[0] is not None
    assert refused >= 10
    names = _env_names(port_router)
    assert names == _env_names(ref_router) and names
    values = {n: "3" for n in names}
    values.update({"SIEVE_SVC_EXEMPLARS": "0", "SIEVE_PROF_IDLE": "1",
                   "SIEVE_SVC_EXEMPLAR_SLACK": "2.5"})
    for n, v in values.items():
        monkeypatch.setenv(n, v)
    got = dataclasses.asdict(RouterSettings.from_env(rounds=4))
    assert got == dataclasses.asdict(ref_router.RouterSettings.from_env(rounds=4))
    assert (got["exemplars"], got["rounds"], got["prof_hz"]) == (False, 4, 3.0)


def test_router_stats_and_relay_tables_equal_reference():
    assert port_router._RELAY_KINDS == ref_router._RELAY_KINDS
    assert port_router.UNROUTED_TYPES == ref_router.UNROUTED_TYPES
    assert port_router._REPLICA_PID_BASE == ref_router._REPLICA_PID_BASE


# --- routing on the port's fabric --------------------------------------------


@pytest.mark.parametrize("edge,kind,pair", [
    (1032, "twins", (1031, 1033)),
    (1050, "twins", (1049, 1051)),
    (1491, "cousins", (1489, 1493)),
])
def test_pair_splice_straddles_edge(memsink, edge, kind, pair):  # noqa: F811
    gap = {"twins": 2, "cousins": 4}[kind]
    # the scenario is only honest if the pair really straddles the edge
    assert pair[0] < edge <= pair[1] and pair[1] - pair[0] == gap
    assert o_count(pair[0], pair[0] + 1) and o_count(pair[1], pair[1] + 1)
    n, lo, hi = 4000, edge - 200, edge + 200
    replies = []
    for side in (REF, PORT_CUDA):  # cold-only shard servers, both packages
        cold = side.cfg(None, "odds", n=n, n_segments=2)
        svcs = [side.svc.SieveService(cold, side.settings()).start(),
                side.svc.SieveService(cold, side.settings(range_lo=edge)).start()]
        m = side.svc.ShardMap([side.svc.Shard(2, edge, (svcs[0].addr,)),
                               side.svc.Shard(edge, n + 1, (svcs[1].addr,))])
        try:
            with side.svc.SieveRouter(m, side.svc.RouterSettings(quiet=True)) as r, \
                    side.svc.ServiceClient(r.addr, timeout_s=30) as cli:
                rep = cli.query("count", lo=lo, hi=hi, kind=kind)
                replies.append(plain(rep))
        finally:
            for s in svcs:
                s.stop()
    assert replies[1] == replies[0]
    assert replies[1]["ok"] and replies[1]["value"] == o_pairs(lo, hi, gap)
    spliced = [rec for rec in memsink.records if rec.get("event") == "router_spliced"]
    assert spliced and spliced[-1]["edge"] == edge
    assert spliced[-1]["pair_kind"] == kind
    assert spliced[-1]["pairs"] >= 1  # the straddler was counted


def test_scatter_partial_is_the_reference_prefix(splits, tmp_path):
    # shard 1's first request stalls past the whole budget: the reply is
    # a typed deadline_exceeded whose partial covers the contiguous
    # prefix [2, E) that shard 0 answered, in both packages
    replies = []
    for side in (REF, PORT_CUDA):
        with Fabric(splits["wheel30"], tmp_path, shards=side, router=side,
                    shard1_chaos="svc_stall:any@s1:1.2") as f:
            rep = f.cli.query("pi", x=N, deadline_s=0.6)
            assert rep["error"] == "deadline_exceeded" and rep["shard"] == 1
            part = rep["partial"]
            assert part["answered_hi"] >= f.E
            assert part["pi_so_far"] == o_count(2, part["answered_hi"])
            assert f.cli.stats()["deadline_exceeded"] == 1
            replies.append({k: rep[k] for k in ("error", "shard", "partial")})
    assert replies[1] == replies[0]


def test_whole_shard_down_is_typed_unavailable(splits, tmp_path):
    d0, _d1, E = splits["wheel30"]
    svc = SieveService(PORT_CUDA.cfg(fresh_copy(d0, tmp_path)),
                       PORT_CUDA.settings()).start()
    m = ShardMap([Shard(2, E, (svc.addr,)), Shard(E, N + 1, (_dead_addr(),))])
    try:
        with SieveRouter(m, RouterSettings(quiet=True, rounds=1,
                                           probe_timeout_s=1.0)) as r, \
                ServiceClient(r.addr, timeout_s=30) as cli:
            rep = cli.query("count", lo=E + 10, hi=E + 2000)
            assert rep["error"] == "unavailable"
            assert rep["shard"] == 1
            assert rep["shard_range"] == [E, N + 1]
            assert "shard 1" in rep["detail"]
            # the healthy shard keeps answering exact through the outage
            good = cli.query("count", lo=10_000, hi=20_000)
            assert good["ok"] and good["value"] == o_count(10_000, 20_000)
            assert cli.stats()["unavailable_replies"] >= 1
    finally:
        svc.stop()


def test_shed_propagation_carries_lane_and_shard(splits, tmp_path):
    with Fabric(splits["wheel30"], tmp_path, shard1_chaos="svc_flood:any@s1:cold",
                router_settings={"rounds": 1}) as f:
        rep = f.cli.query("count", lo=f.E + 10, hi=f.E + 2000)
        assert rep["error"] == "overloaded"
        assert rep["lane"] == "cold"  # lane rides through the router
        assert rep["shard"] == 1
        assert f.cli.stats()["shed_relayed"] == 1


def test_router_drains_typed(splits, tmp_path):
    with Fabric(splits["wheel30"], tmp_path) as f:
        assert f.cli.query("pi", x=100)["ok"]
        f.router.drain()
        assert f.cli.query("pi", x=100)["error"] == "draining"
        assert f.cli.stats()["draining_replies"] == 1
        assert f.router.wait_drained(5.0)


def test_svc_shard_down_window_scoped_to_shard(splits, tmp_path):
    with Fabric(splits["wheel30"], tmp_path) as f:
        E, cli = f.E, f.cli
        assert cli.query("pi", x=N)["ok"]  # caches both shard totals
        f.router.inject_chaos(f"svc_shard_down:0@s{f.router._seq + 1}:0.5")
        # the drawing request itself targets shard 1 and stays exact
        assert cli.query("is_prime", x=int(P[o_pi(E)]))["value"] is True
        rep = cli.query("count", lo=10_000, hi=20_000)  # needs shard 0
        assert rep["error"] == "unavailable" and rep["shard"] == 0
        # cached immutable totals still compose during the window
        assert cli.query("pi", x=N)["value"] == o_pi(N)
        time.sleep(0.55)
        deadline = time.monotonic() + 5
        while True:
            rep = cli.query("count", lo=10_000, hi=20_000)
            if rep.get("ok"):
                assert rep["value"] == o_count(10_000, 20_000)
                break
            assert time.monotonic() < deadline
            time.sleep(0.1)
        assert cli.stats()["shard_down_windows"] == 1


def test_svc_shard_down_any_hits_every_shard(splits, tmp_path):
    with Fabric(splits["wheel30"], tmp_path) as f:
        f.router.inject_chaos(f"svc_shard_down:any@s{f.router._seq + 1}:0.4")
        assert f.cli.query("is_prime", x=7919)["error"] == "unavailable"
        assert f.cli.query("is_prime", x=f.E + 3)["error"] == "unavailable"
        assert f.cli.stats()["shard_down_windows"] == 2  # one per shard


def test_router_fails_over_within_shard(splits, tmp_path):
    with Fabric(splits["wheel30"], tmp_path, shard1_replicas=2) as f:
        E = f.E
        assert f.cli.query("count", lo=E + 10, hi=E + 2000)["ok"]
        f.svcs[1].stop()  # kill the first shard-1 replica
        # the set round-robins: whichever query lands on the dead replica
        # first must fail over, every reply exact
        for _ in range(4):
            rep = f.cli.query("count", lo=E + 10, hi=E + 2000)
            assert rep["ok"] and rep["value"] == o_count(E + 10, E + 2000)
        assert f.cli.stats()["failovers"] >= 1


def test_router_health_and_stats_keys_equal_reference(splits, tmp_path):
    keys = []
    for side in (REF, PORT_CUDA):
        with Fabric(splits["wheel30"], tmp_path, shards=side, router=side) as f:
            h = f.cli.health()
            assert (h["role"], h["status"], h["draining"]) == ("router", "ok", False)
            assert (h["range_lo"], h["range_hi"]) == (2, N + 1)
            assert h["covered_hi"] >= N + 1  # both ledgers fully cover
            assert [sh["shard"] for sh in h["shards"]] == [0, 1]
            assert all(sh["status"] == "ok" for sh in h["shards"])
            st = f.cli.stats()
            # a downed shard degrades fabric health and breaks contiguity
            f.svcs[1].stop()
            down = f.cli.health()
            assert down["status"] == "degraded"
            assert down["shards"][1]["status"] == "unavailable"
            assert down["covered_hi"] < N + 1
            keys.append((sorted(h), [sorted(sh) for sh in h["shards"]],
                         sorted(st)))
    assert keys[1] == keys[0]
    assert keys[1][0] == ["covered_hi", "draining", "id", "ok", "range_hi",
                          "range_lo", "role", "shard_count", "shards", "status",
                          "type"]
    assert "spliced" in keys[1][2] and "wire_downgrades" in keys[1][2]


def test_probe_ttl_caches_health_probes(splits, tmp_path):
    d0, _d1, _E = splits["wheel30"]
    svc = SieveService(PORT_CUDA.cfg(fresh_copy(d0, tmp_path)),
                       PORT_CUDA.settings()).start()

    def counters():
        return (registry().counter("router.probe_sent").value,
                registry().counter("router.probe_cached").value)

    try:
        with ReplicaSet([svc.addr], probe_ttl_s=60.0) as rs:
            sent0, cached0 = counters()
            for _ in range(3):
                assert rs.pi(1000) == o_pi(1000)
            sent, cached = counters()
            assert sent - sent0 == 1  # one real probe...
            assert cached - cached0 == 2  # ...then the TTL cache serves
        with ReplicaSet([svc.addr], probe_ttl_s=0.0) as rs:
            sent0, _ = counters()
            for _ in range(2):
                assert rs.pi(1000) == o_pi(1000)
            assert counters()[0] - sent0 == 2  # ttl 0: every call probes
    finally:
        svc.stop()


def test_range_lo_server_rejects_global_and_below_range(splits, tmp_path):
    _d0, d1, E = splits["wheel30"]
    with SieveService(PORT_CUDA.cfg(fresh_copy(d1, tmp_path)),
                      PORT_CUDA.settings(range_lo=E)) as svc, \
            ServiceClient(svc.addr, timeout_s=30) as cli:
        assert cli.health()["range_lo"] == E
        rep = cli.query("pi", x=N)  # global-prefix op: the router's job
        assert rep["error"] == "bad_request" and "router" in rep["detail"]
        rep = cli.query("count", lo=2, hi=E + 100)
        assert rep["error"] == "bad_request"
        assert f"range_lo={E}" in rep["detail"]
        # in-range ops anchor at the base and answer exact
        assert cli.count(E, N + 1) == o_count(E, N + 1)
        assert cli.count(E + 10, E + 5000) == o_count(E + 10, E + 5000)
        assert cli.nth_prime(5) == o_primes(E, N)[4]  # 5th prime >= E


def test_is_prime_on_plain_server(splits, tmp_path):
    d0, _d1, _E = splits["wheel30"]
    with SieveService(PORT_CUDA.cfg(fresh_copy(d0, tmp_path)),
                      PORT_CUDA.settings()) as svc, \
            ServiceClient(svc.addr, timeout_s=30) as cli:
        assert [cli.is_prime(x) for x in (7919, 7917, 2, 1, 0)] == \
            [True, False, True, False, False]


def test_router_events_validate_against_schema(splits, tmp_path, memsink):  # noqa: F811
    with Fabric(splits["wheel30"], tmp_path) as f:
        f.cli.query("count", lo=f.E - 50, hi=f.E + 50, kind="twins")
        f.router.inject_chaos(f"svc_shard_down:1@s{f.router._seq + 1}:0.2")
        f.cli.query("is_prime", x=f.E + 3)  # draws + hits the window
        # the wire chaos gate defaults closed on the router too
        assert f.cli.inject_chaos("svc_shard_down:0@s99").get("error") == \
            "bad_request"
        f.router.drain()
    kinds = {r["event"] for r in memsink.records
             if r["event"].startswith("router_")}
    assert {"router_request", "router_spliced", "router_shard_down",
            "router_chaos_refused", "router_drain"} <= kinds
    for rec in memsink.records:
        if rec["event"].startswith("router_"):
            validate_record(rec)  # raises on any missing schema key
