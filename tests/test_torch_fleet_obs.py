"""Fleet tracing and live telemetry through the port's router: the port of
tests/test_fleet_obs.py and of the fleet half of tests/test_debug.py.

The router forwards a child trace context per downstream call and a
retried call gets a fresh attempt suffix; the shard servers piggyback
their span rings in batches and the ``telemetry`` op flushes the rest;
``svc_trace_drop`` nulls a payload, which the router counts as a
telemetry gap with a ``router_trace_gap`` event; two shard servers and the
router run as ``python -m sieve_torch serve`` and ``route`` processes and
the router's ``--trace`` file merges a rebased track per replica with
>= 95% of routes correlated to exactly one shard query; the ``metrics``
op answers on server and router; SLO burn and the telemetry-batch
settings; the router's ``debug`` op and its ``router_shard_down`` bundle.
Shard servers run the ``cuda`` backend on ``device="cpu"`` (the fused
kernel's plain version). The reference's tests of ``tools/fleet_top.py``
and ``tools/fleet_debug.py`` run on the port's tools in
tests/test_torch_fleet_tools.py, and those of ``tools/trace_report.py`` in
tests/test_torch_trace_report.py.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from sieve.coordinator import run_local as ref_run_local
from sieve_torch import trace
from sieve_torch.chaos import parse_chaos
from sieve_torch.debug import BUNDLE_VERSION
from sieve_torch.metrics import registry, validate_record
from sieve_torch.service import (
    ReplicaSet,
    RouterSettings,
    ServiceClient,
    ServiceSettings,
    Shard,
    ShardMap,
    SieveRouter,
    SieveService,
)
from sieve_torch.service.client import CallTimeout
from tests.test_torch_router import (
    N,
    PORT_CUDA,
    REF,
    Fabric,
    fresh_copy,
    o_count,
    o_pi,
    split_ledger,
)
from tests.test_torch_service import memsink  # noqa: F401 — fixture

REPO = Path(__file__).resolve().parent.parent
PROC_WAIT_S = 60


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet_src")
    ref_run_local(REF.cfg(str(root / "src")))
    return split_ledger(root / "src", root)


@pytest.fixture(autouse=True)
def _clean_tracer():
    """Each test starts and ends with a disabled, unbounded tracer."""
    yield
    trace.drain_events()
    trace.disable()
    trace.set_event_limit(None)


def _shard0(split, tmp_path, **settings):
    d0, _d1, _E = split
    return SieveService(PORT_CUDA.cfg(fresh_copy(d0, tmp_path),
                                      chaos=settings.pop("chaos", None)),
                        PORT_CUDA.settings(**settings))


def _wait(cond, timeout_s=5.0, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# --- ctx propagation ---------------------------------------------------------


def test_client_stamps_ctx_and_router_forwards_children(split, tmp_path):
    trace.enable()
    with Fabric(split, tmp_path) as f:
        assert f.cli.is_prime(17)
        lo = f.E + 10
        assert f.cli.count(lo, lo + 50) == o_count(lo, lo + 50)
    trace.disable()
    events = trace.get_tracer().events()
    routes = [e for e in events if e.get("name") == "rpc.route"]
    queries = [e for e in events if e.get("name") == "rpc.query"]
    assert len(routes) == 2
    for r in routes:
        rctx = (r.get("args") or {}).get("ctx", "")
        # the ServiceClient stamped run_id/<seq>.0 before the router saw it
        head, tail = rctx.rsplit("/", 1)
        assert head and tail.endswith(".0")
        kids = [q for q in queries
                if (q.get("args") or {}).get("ctx", "").rsplit("/", 1)[0] == rctx]
        assert len(kids) == 1, f"route {rctx} should have one child"
        kctx = kids[0]["args"]["ctx"]
        # child = <route ctx>/s<shard>.<call>.<attempt>
        assert kctx.startswith(rctx + "/s")
        assert kctx.rsplit(".", 1)[1] == "0"  # first wire attempt


def test_replica_retry_gets_fresh_attempt_ctx(split, tmp_path, monkeypatch):
    seen = []
    orig_call = ServiceClient._call
    state = {"failed": False}

    def flaky(self, msg):
        if msg.get("type") == "query":
            seen.append(msg["ctx"])
            if not state["failed"]:
                state["failed"] = True
                raise CallTimeout("injected: first attempt dies")
        return orig_call(self, msg)

    monkeypatch.setattr(ServiceClient, "_call", flaky)
    with _shard0(split, tmp_path) as svc:
        rs = ReplicaSet([svc.addr], timeout_s=10, rounds=3, backoff_base_s=0.0,
                        backoff_cap_s=0.0, circuit_cooldown_s=0.0)
        reply = rs.query("pi", ctx="root/7", x=1000)
        rs.close()
    assert reply["ok"] and reply["value"] == o_pi(1000)
    # same base, fresh .attempt per wire try: retried spans never alias
    assert seen == ["root/7.0", "root/7.1"]


def test_counter_tracks_are_throttled_not_transition_logged():
    tr = trace.Tracer()
    tr.enable()
    tr.counter("q.depth", 1)
    tr.counter("q.depth", 2)  # same interval: dropped
    tr.counter("q.other", 5)  # first sample of another track: lands
    assert [e["name"] for e in tr.events() if e["ph"] == "C"] == \
        ["q.depth", "q.other"]
    tr._counter_interval_us = 0.0  # interval elapsed
    tr.counter("q.depth", 3)
    vals = [e["args"]["value"] for e in tr.events()
            if e["ph"] == "C" and e["name"] == "q.depth"]
    assert vals == [1, 3]


# --- telemetry piggyback, flush op, chaos drop ------------------------------


def test_piggyback_batches_and_flush_op_drains(split, tmp_path):
    trace.enable()
    with _shard0(split, tmp_path, telemetry_ship=True,
                 telemetry_batch=10_000) as svc:
        rs = ReplicaSet([svc.addr], timeout_s=10)
        reply = rs.query("pi", telemetry=True, x=1000)
        # below the batch threshold: the reply must NOT pay a serialize
        assert reply["ok"] and "telemetry" not in reply
        # but the explicit flush op always drains the ring
        flushed = rs.telemetry_flush()
        assert len(flushed) == 1
        tele = flushed[0]["telemetry"]
        assert tele["dropped"] >= 0
        assert any(e.get("name") == "rpc.query" for e in tele["events"])
        assert flushed[0]["probe"]["addr"] == svc.addr
        assert flushed[0]["t_recv"] <= flushed[0]["t_sent"]
        # batch=1: the very next traced reply carries the ring inline
        svc.settings.telemetry_batch = 1
        reply2 = rs.query("pi", telemetry=True, x=2000)
        assert reply2["telemetry"]["events"]
        rs.close()


def test_svc_trace_drop_discards_ring_and_nulls_payload(split, tmp_path,
                                                        memsink):  # noqa: F811
    trace.enable()
    with _shard0(split, tmp_path, chaos="svc_trace_drop:any@s1",
                 telemetry_ship=True, telemetry_batch=1) as svc:
        rs = ReplicaSet([svc.addr], timeout_s=10)
        r1 = rs.query("pi", telemetry=True, x=1000)
        # request 1: answered exactly, telemetry explicitly lost
        assert r1["ok"] and r1["value"] == o_pi(1000)
        assert r1["telemetry"] is None
        r2 = rs.query("pi", telemetry=True, x=2000)
        # the dropped ring was discarded, not deferred
        ctxs = [(e.get("args") or {}).get("ctx") for e in r2["telemetry"]["events"]
                if e.get("name") == "rpc.query"]
        assert len(ctxs) == 1  # only request 2's span, not request 1's
        assert svc.stats()["trace_drops"] == 1
        rs.close()
    drops = [r for r in memsink.records if r.get("event") == "service_trace_drop"]
    assert len(drops) == 1 and drops[0]["op"] == "pi"
    validate_record(drops[0])


def test_svc_trace_drop_is_a_counted_router_trace_gap(split, tmp_path,
                                                      memsink):  # noqa: F811
    trace.enable()
    with Fabric(split, tmp_path, shard1_chaos="svc_trace_drop:any@s1",
                shard_settings={"telemetry_ship": True, "telemetry_batch": 1}) as f:
        lo = f.E + 10
        assert f.cli.count(lo, lo + 50) == o_count(lo, lo + 50)  # dropped
        assert f.cli.count(lo, lo + 60) == o_count(lo, lo + 60)  # merged
        st = f.cli.stats()
    assert st["telemetry_gaps"] == 1
    assert st["telemetry_merged"] >= 1
    gaps = [r for r in memsink.records if r.get("event") == "router_trace_gap"]
    assert len(gaps) == 1 and gaps[0]["shard"] == 1
    validate_record(gaps[0])


def test_chaos_grammar_svc_trace_drop():
    d = parse_chaos("svc_trace_drop:any@s3")
    assert len(d) == 1 and d[0].kind == "svc_trace_drop"
    assert d[0].seg_id == 3 and d[0].param is None
    with pytest.raises(ValueError, match="takes no param"):
        parse_chaos("svc_trace_drop:any@s3:2")


# --- two shard servers and the router as processes: one merged trace ---------


def _spawn(argv, tmp_path, tag, env):
    """``python -m sieve_torch <argv>`` with stdout to a file; its first
    JSON line (the address line) once it is printed."""
    out, err = tmp_path / f"{tag}.out", tmp_path / f"{tag}.err"
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen([sys.executable, "-m", "sieve_torch", *argv],
                                env=env, cwd=str(REPO), stdout=fo, stderr=fe)
    t0 = time.monotonic()
    while True:
        lines = out.read_text().splitlines()
        if lines:
            return proc, json.loads(lines[0]), out
        if proc.poll() is not None or time.monotonic() - t0 > PROC_WAIT_S:
            proc.kill()
            raise AssertionError(f"{tag}: no address line: {err.read_text()[-2000:]}")
        time.sleep(0.05)


def test_two_shard_processes_and_route_process_merge_one_trace(split, tmp_path):
    d0, d1, E = split
    env = dict(os.environ, PYTHONPATH=str(REPO), SIEVE_SVC_TELEMETRY="1")
    trace_file = tmp_path / "fleet.json"
    procs = []
    try:
        addrs = []
        for i, (d, extra) in enumerate(((d0, []), (d1, ["--range-lo", str(E)]))):
            p, head, _ = _spawn(
                ["serve", "--addr", "127.0.0.1:0", "--n", str(N), "--segments", "4",
                 "--packing", "wheel30", "--checkpoint-dir", fresh_copy(d, tmp_path),
                 "--refresh-s", "0", "--device", "cpu", "--quiet", *extra],
                tmp_path, f"shard{i}", env)
            procs.append(p)
            assert head["event"] == "serving"
            addrs.append(head["addr"])
        p, head, route_out = _spawn(
            ["route", "--addr", "127.0.0.1:0", "--quiet", "--trace", str(trace_file),
             "--shard", f"2:{E}={addrs[0]}", "--shard", f"{E}:{N + 1}={addrs[1]}"],
            tmp_path, "route", env)
        procs.append(p)
        assert head["event"] == "routing" and head["range"] == [2, N + 1]
        with ServiceClient(head["addr"], timeout_s=30) as cli:
            for i in range(20):  # point routes on both sides of E
                x = (97 * (i + 1)) % N
                assert cli.is_prime(x) == bool(o_count(x, x + 1))
            for i in range(20):  # in-shard windowed counts
                lo = (211 * (i + 1)) % (N - 300)
                if lo < E <= lo + 200:
                    lo = E  # keep the window inside one shard
                assert cli.count(lo, lo + 200) == o_count(lo, lo + 200)
            assert cli.pi(N - 1) == o_pi(N - 1)  # one 2-shard scatter
            stats = cli.stats()
            cli.shutdown()  # the router drains, flushes every ring, saves
        assert procs[2].wait(timeout=PROC_WAIT_S) == 0
        drained = json.loads(route_out.read_text().splitlines()[-1])
        assert drained["event"] == "drained" and drained["clean"]
        assert drained["stats"]["requests"] == 41
        for a in addrs:
            with ServiceClient(a, timeout_s=10) as c:
                c.shutdown()
        assert [q.wait(timeout=PROC_WAIT_S) for q in procs[:2]] == [0, 0]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait(timeout=PROC_WAIT_S)
    events = json.loads(trace_file.read_text())["traceEvents"]
    # ONE trace, one rebased track per shard replica
    tracks = {e["args"]["name"]: e["pid"] for e in events
              if e.get("ph") == "M" and e.get("name") == "process_name"
              and str((e.get("args") or {}).get("name", "")).startswith("shard")}
    assert len(tracks) == 2
    replica_pids = set(tracks.values())
    routes = [e for e in events if e.get("name") == "rpc.route"]
    assert len(routes) == 41
    kids_by_base = {}
    for q in (e for e in events if e.get("name") == "rpc.query"
              and e.get("pid") in replica_pids):
        base = (q.get("args") or {}).get("ctx", "").rsplit("/", 1)[0]
        kids_by_base.setdefault(base, []).append(q)
    exactly_one = sum(
        1 for r in routes
        if len(kids_by_base.get((r.get("args") or {}).get("ctx"), [])) == 1)
    assert exactly_one / len(routes) >= 0.95
    assert stats["telemetry_gaps"] == 0
    assert any(e.get("name") == "clock.align" for e in events)


# --- the metrics op, SLO burn, settings --------------------------------------


def test_metrics_op_on_server_and_router(split, tmp_path):
    with Fabric(split, tmp_path) as f:
        assert f.cli.is_prime(101)
        raw = f.cli._call({"type": "metrics"})
        assert raw["ok"] and raw["role"] == "router"
        snap = raw["metrics"]
        assert snap["router.requests"]["type"] == "counter"
        with ServiceClient(f.svcs[0].addr, timeout_s=10) as scli:
            assert scli._call({"type": "metrics"})["role"] == "service"
            assert scli.metrics()["service.requests"]["value"] >= 1
        # histograms with zero observations snapshot None, never 0
        empty = [v for v in snap.values()
                 if v.get("type") == "histogram" and v["count"] == 0]
        assert all(v["mean"] is None for v in empty)


def test_slo_burn_event_gauges_and_stats(split, tmp_path, memsink):  # noqa: F811
    with _shard0(split, tmp_path, slo_ms={"pi": 0.0001, "count": 50.0},
                 slo_window=8) as svc, ServiceClient(svc.addr, timeout_s=10) as cli:
        assert cli.pi(1000) == o_pi(1000)
        slo = svc.stats()["slo"]
    # pi burned (no real query finishes in 0.1us); the event is typed
    assert slo["pi"]["burn"] > 1.0 and slo["pi"]["burning"]
    assert slo["pi"]["n"] == 1
    # count never observed: percentile and burn are null, not 0
    assert slo["count"]["p95_ms"] is None and slo["count"]["burn"] is None
    burns = [r for r in memsink.records if r.get("event") == "service_slo_burn"]
    assert len(burns) == 1 and burns[0]["op"] == "pi"
    validate_record(burns[0])
    assert burns[0]["slo_ms"] == 0.0001
    assert registry().gauge("service.slo_burn.pi").value > 1.0
    assert registry().gauge("service.slo_burn").value > 1.0


def test_slo_env_parsing(monkeypatch):
    monkeypatch.setenv("SIEVE_SVC_SLO_MS_PI", "5")
    monkeypatch.setenv("SIEVE_SVC_SLO_MS_COUNT", "12.5")
    assert ServiceSettings.from_env().slo_ms == {"pi": 5.0, "count": 12.5}
    monkeypatch.setenv("SIEVE_SVC_SLO_MS_PI", "fast")
    with pytest.raises(ValueError, match="expected a number"):
        ServiceSettings.from_env()


def test_telemetry_batch_env_and_validation(monkeypatch):
    monkeypatch.setenv("SIEVE_SVC_TELEMETRY_BATCH", "64")
    assert ServiceSettings.from_env().telemetry_batch == 64
    with pytest.raises(ValueError, match="telemetry_batch"):
        ServiceSettings(telemetry_batch=0).validate()


# --- the router's recorder (the fleet half of tests/test_debug.py) ----------


def test_debug_op_on_router_and_shard_down_bundle(split, tmp_path):
    d0, d1, E = split
    dbgr = tmp_path / "dbgr"
    svcs = [SieveService(PORT_CUDA.cfg(fresh_copy(d0, tmp_path)),
                         PORT_CUDA.settings(metrics_sample_s=0.0)).start(),
            SieveService(PORT_CUDA.cfg(fresh_copy(d1, tmp_path)),
                         PORT_CUDA.settings(range_lo=E,
                                            metrics_sample_s=0.0)).start()]
    smap = ShardMap([Shard(2, E, (svcs[0].addr,)), Shard(E, N + 1, (svcs[1].addr,))])
    router = SieveRouter(smap, RouterSettings(quiet=True, debug_dir=str(dbgr),
                                              metrics_sample_s=0.0)).start()
    try:
        with ServiceClient(router.addr, timeout_s=30) as cli:
            assert cli.is_prime(101)
            b = cli.debug()
            assert b["bundle"] == BUNDLE_VERSION and b["role"] == "router"
            # shard 0 dark for 0.2s on the next request; the request
            # itself targets shard 1, so it stays exact
            router.inject_chaos(f"svc_shard_down:0@s{router._seq + 1}:0.2")
            lo = E + 10
            assert cli.count(lo, lo + 100) == o_count(lo, lo + 100)
            _wait(lambda: list(dbgr.glob("bundle-shard_down-*")),
                  what="shard_down bundle dir")
            with open(next(iter(dbgr.glob("bundle-shard_down-*")))
                      / "bundle.json") as f:
                doc = json.load(f)
            assert doc["role"] == "router"
            assert doc["detail"]["shard"] == 0
            time.sleep(0.25)  # window over: shard 0 exact again
            assert cli.pi(1000) == o_pi(1000)
    finally:
        router.stop()
        for s in svcs:
            s.stop()
