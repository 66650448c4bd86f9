"""The port's admission lanes, drain and failover (tests/test_lanes.py,
tests/test_failover.py and the client half of tests/test_wire.py).

The reference's tests, run on the port's server, client and settings with
the ``cuda`` backend on ``device="cpu"`` (the fused kernel's plain version
answers every cold chunk): settings validation naming the bad setting and
the env variable; malformed ``deadline_s`` typed; the health/stats key
schema; hot/cold classification; cold-lane sheds carrying ``lane`` while
hot queries answer; brownout halving the cold limit; demotion of a
misclassified hot query; ``svc_flood``; the ledger follower (swaps,
no-op rewrites, corrupt and vanished ledgers, ``svc_refresh_corrupt``, the
live thread); drain (typed ``draining``, in-flight answers kept, the
``shutdown`` op, ``svc_drain``); ``replica_down``; the ``CallTimeout``
desync; ``ReplicaSet`` failover (dead, draining, ``bad_request`` never
retried, all dead => ``unavailable``, ``query_many`` suffix-only
failover, whole-RPC batch failover); ``ClientPool`` connection reuse; the
wire chaos gate and the health freshness fields. The ledgers are written
by the port's counting run.
"""

import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from sieve.seed import seed_primes
from sieve_torch import metrics
from sieve_torch.chaos import parse_chaos
from sieve_torch.checkpoint import LEDGER_NAME, Ledger
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.metrics import MemorySink, validate_record
from sieve_torch.rpc import encode_msg, recv_msg
from sieve_torch.service import (
    CallTimeout,
    ClientPool,
    LedgerFollower,
    ReplicaSet,
    ServiceClient,
    ServiceError,
    ServiceSettings,
    SieveService,
)

N = 50_000
P = seed_primes(400_000)


def o_pi(x):
    return int(np.searchsorted(P, x, side="right"))


def o_count(lo, hi):
    return int(np.searchsorted(P, hi, side="left")
               - np.searchsorted(P, lo, side="left"))


def o_is_prime(x):
    return o_pi(x) - o_pi(x - 1) > 0


@pytest.fixture
def memsink():
    sink = MemorySink()
    metrics.add_sink(sink)
    yield sink
    metrics.remove_sink(sink)


@pytest.fixture(scope="module")
def ledger_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("lanes_ledger")
    run_local(_cfg(str(path), backend="cpu-numpy"))
    return path


@pytest.fixture(scope="module")
def src_dir(ledger_dir):
    """The fully sieved source dir the follower tests copy segments from."""
    return ledger_dir


def _cfg(checkpoint_dir: str, **kw) -> SieveConfig:
    base = dict(
        n=N, backend="cuda", device="cpu", packing="wheel30", n_segments=4,
        quiet=True, checkpoint_dir=checkpoint_dir,
    )
    base.update(kw)
    return SieveConfig(**base)


def _settings(**kw) -> ServiceSettings:
    base = dict(
        workers=2, queue_limit=16, default_deadline_s=10.0,
        cold_chunk=1 << 16, breaker_cooldown_s=0.4, refresh_s=0.0,
    )
    base.update(kw)
    return ServiceSettings(**base)


@pytest.fixture
def service(ledger_dir):
    with SieveService(_cfg(str(ledger_dir)), _settings()) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            yield svc, cli


def _dead_addr() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here anymore
    return f"127.0.0.1:{port}"


def _seed_serving(src_dir, dest: Path, n_segments: int) -> Ledger:
    """Writer's ledger on ``dest`` holding the first n_segments of src."""
    segs = sorted(
        Ledger.open_readonly(_cfg(str(src_dir))).completed().values(),
        key=lambda r: r.lo,
    )
    wled = Ledger.open(_cfg(str(dest)))
    for r in segs[:n_segments]:
        wled.record(r)
    return wled


def _remaining(src_dir, n_segments: int):
    segs = sorted(
        Ledger.open_readonly(_cfg(str(src_dir))).completed().values(),
        key=lambda r: r.lo,
    )
    return segs[n_segments:]


# --- settings validation ---------------------------------------


@pytest.mark.parametrize("field,value,needle", [
    ("queue_limit", 0, "queue_limit=0"),
    ("workers", -1, "workers=-1"),
    ("hot_queue_limit", 0, "hot_queue_limit=0"),
    ("cold_queue_limit", -3, "cold_queue_limit=-3"),
    ("hot_workers", -1, "hot_workers=-1"),
    ("cold_age_s", -0.5, "cold_age_s=-0.5"),
    ("cold_age_s", float("nan"), "cold_age_s=nan"),
    ("default_deadline_s", 0, "default_deadline_s=0"),
    ("breaker_fails", "3", "breaker_fails='3'"),
])
def test_validate_names_the_bad_setting(field, value, needle):
    with pytest.raises(ValueError) as ei:
        ServiceSettings(**{field: value}).validate()
    assert needle in str(ei.value)


def test_validate_accepts_defaults_and_lane_inheritance():
    s = ServiceSettings().validate()
    assert s.hot_queue_limit is None  # None inherits queue_limit: valid
    assert ServiceSettings(hot_workers=0).validate().hot_workers == 0


def test_bad_settings_fail_at_service_startup(ledger_dir):
    # the whole point of validate(): a bad knob dies at construction,
    # never as undefined runtime behavior in the admission plane
    with pytest.raises(ValueError, match="workers=0"):
        SieveService(_cfg(str(ledger_dir)), ServiceSettings(workers=0))


def test_env_parse_failure_names_the_variable(monkeypatch):
    monkeypatch.setenv("SIEVE_SVC_QUEUE", "lots")
    with pytest.raises(ValueError, match="SIEVE_SVC_QUEUE='lots'"):
        ServiceSettings.from_env()
    monkeypatch.delenv("SIEVE_SVC_QUEUE")
    monkeypatch.setenv("SIEVE_SVC_COLD_AGE_S", "fast")
    with pytest.raises(ValueError, match="SIEVE_SVC_COLD_AGE_S='fast'"):
        ServiceSettings.from_env()


def test_env_lane_knobs_parse(monkeypatch):
    monkeypatch.setenv("SIEVE_SVC_HOT_QUEUE", "8")
    monkeypatch.setenv("SIEVE_SVC_HOT_WORKERS", "2")
    monkeypatch.setenv("SIEVE_SVC_COLD_AGE_S", "0.25")
    s = ServiceSettings.from_env()
    assert (s.hot_queue_limit, s.hot_workers, s.cold_age_s) == (8, 2, 0.25)
    assert s.cold_queue_limit is None  # unset env keeps the None default


# --- malformed deadline_s --------------------------------------


@pytest.mark.parametrize("dl", [-1, 0, "nope", float("inf"), True])
def test_bad_deadline_is_typed_bad_request(service, dl):
    svc, cli = service
    r = cli.query("pi", x=1000, deadline_s=dl)
    assert r["ok"] is False
    assert r["error"] == "bad_request"
    assert "deadline_s" in r["detail"]
    # the client connection survives a typed refusal
    assert cli.pi(30_000) == o_pi(30_000)
    assert svc.stats()["bad_requests"] >= 1


# --- health/stats reply schema snapshot ------------------------


def test_health_and_stats_key_schema_snapshot(service):
    """Key-set snapshot: a removed or renamed field in either control
    reply is an operator-visible wire break and must show up here."""
    svc, cli = service
    assert cli.pi(30_000) == o_pi(30_000)
    assert sorted(cli.health()) == [
        "brownout", "cold_backend", "covered_hi", "draining", "id",
        "mesh_devices", "mesh_fanout", "ok", "proc",
        "queue_depth", "queue_depth_cold", "queue_depth_hot", "range_lo",
        "refreshes", "snapshot_age_s", "status", "store", "total_primes",
        "type",
    ]
    assert sorted(cli.stats()) == [
        "bad_requests", "batch_members", "batch_requests", "brownout",
        "coalesced", "cold_admitted", "cold_backend",
        "cold_batched_chunks", "cold_cache_hits", "cold_computes",
        "cold_dispatches", "cold_persisted", "cold_store_hits",
        "covered_hi",
        "deadline_exceeded", "degraded", "degraded_replies", "demoted",
        "draining", "draining_replies", "dropped_segments",
        "exemplars_kept", "exemplars_seen",
        "hot_admitted", "hot_workers_dedicated", "index_hits",
        "internal_errors", "lane_shed_cold", "lane_shed_hot",
        "lru_entries", "lru_hits", "materialized", "mesh_devices",
        "mesh_fallbacks", "mesh_fanout", "mesh_launches", "persist_cold",
        "proc_index", "procs", "profile_gaps", "profile_pulls",
        "queue_depth", "queue_depth_cold",
        "queue_depth_hot", "range_lo", "refresh_attempts",
        "refresh_failed", "refreshes", "requests", "segments", "shed",
        "slo", "slow_consumer_closed", "snapshot_age_s", "store",
        "store_errors", "store_hits", "telemetry_replies",
        "total_primes", "trace_drops", "wire_v2_conns",
    ]


# --- classification ----------------------------------------------------------


def test_classification_hot_vs_cold(service):
    svc, cli = service
    idx = svc.index
    hi = idx.covered_hi
    q = lambda **m: svc._classify(m, idx)
    assert q(op="pi", x=hi - 1) == "hot"
    assert q(op="pi", x=2 * hi) == "cold"
    assert q(op="count", lo=10, hi=hi) == "hot"
    assert q(op="count", lo=10, hi=hi + 1000) == "cold"
    assert q(op="count", lo=10, hi=2 * hi, kind="twin") == "cold"
    assert q(op="nth_prime", k=idx.total_primes) == "hot"
    assert q(op="nth_prime", k=idx.total_primes + 1) == "cold"
    assert q(op="primes", lo=10, hi=hi) == "hot"
    assert q(op="primes", lo=10, hi=hi + 1) == "cold"
    # malformed / unknown queries are hot: a typed bad_request is cheap
    # and must never queue behind a cold flood
    assert q(op="pi", x="bad") == "hot"
    assert q(op="count", lo=50, hi=10) == "hot"  # hi < lo: bad_request
    assert q(op="no_such_op") == "hot"
    assert q(op="pi") == "hot"  # missing arg


def test_cold_cache_promotes_to_hot(service):
    svc, cli = service
    x = svc.index.covered_hi + 10_000
    assert svc._classify({"op": "pi", "x": x}, svc.index) == "cold"
    assert cli.pi(x) == o_pi(x)  # fills the cold chunk cache
    assert svc._classify({"op": "pi", "x": x}, svc.index) == "hot"
    assert svc.stats()["cold_admitted"] >= 1
    assert cli.pi(x) == o_pi(x)
    assert svc.stats()["hot_admitted"] >= 1


# --- cold flood: sheds carry lane, hot lane keeps answering ------------------


def test_cold_shed_carries_lane_while_hot_answers(ledger_dir, memsink):
    settings = _settings(
        workers=2, hot_workers=1, queue_limit=16, cold_queue_limit=1,
        cold_delay_s=0.4, cold_age_s=5.0,
    )
    with SieveService(_cfg(str(ledger_dir)), settings) as svc:
        hi = svc.index.covered_hi
        replies = []
        rlock = threading.Lock()

        def cold_query(i):
            x = hi + (i + 1) * (1 << 16) - 1
            with ServiceClient(svc.addr, timeout_s=30) as c:
                r = c.query("pi", x=x)
                with rlock:
                    replies.append((x, r))

        threads = [threading.Thread(target=cold_query, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        # the dedicated hot worker keeps answering under the flood
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            for x in range(5_000, 45_000, 5_000):
                assert cli.pi(x) == o_pi(x)
        for t in threads:
            t.join()
        shed = [(x, r) for x, r in replies if not r["ok"]]
        assert shed, "cold lane at limit 1 must shed under 6 queries"
        for _x, r in shed:
            assert r["error"] == "overloaded"
            assert r["lane"] == "cold"
            assert "cold lane" in r["detail"]
        for x, r in replies:
            if r["ok"]:
                assert r["value"] == o_pi(x)  # admitted cold stays exact
        st = svc.stats()
        assert st["lane_shed_cold"] == len(shed)
        assert st["lane_shed_hot"] == 0
    evs = [x for x in memsink.records
           if x["event"] == "service_lane_shed"]
    assert evs and all(e["lane"] == "cold" for e in evs)
    for x in memsink.records:
        validate_record(x)


def test_brownout_halves_cold_limit(ledger_dir):
    # unstarted service: no workers drain the lanes we stuff by hand
    svc = SieveService(
        _cfg(str(ledger_dir)),
        _settings(hot_queue_limit=8, cold_queue_limit=8),
    )
    assert svc.brownout() is False
    with svc._lane_cond:
        assert svc._lane_limit_locked("cold") == 8
    svc._lanes["hot"].extend(object() for _ in range(4))  # half of 8
    assert svc.brownout() is True
    with svc._lane_cond:
        assert svc._lane_limit_locked("cold") == 4
        assert svc._lane_limit_locked("hot") == 8  # hot never halves
    svc._lanes["hot"].clear()
    assert svc.brownout() is False


# --- demotion: a misclassified hot query hands off to the cold lane ----------


def test_misclassified_hot_query_demotes_and_answers(ledger_dir, memsink):
    with SieveService(_cfg(str(ledger_dir)),
                      _settings(workers=2, hot_workers=1)) as svc:
        svc._classify = lambda msg, idx: "hot"  # force misclassification
        x = svc.index.covered_hi + 5_000
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.pi(x) == o_pi(x)  # exact despite the wrong lane
        st = svc.stats()
        assert st["demoted"] >= 1
        assert st["hot_admitted"] >= 1
        # the demoted re-enqueue must not double-count the request
        assert st["requests"] == 1
    evs = [x for x in memsink.records if x["event"] == "service_demoted"]
    assert evs and evs[0]["op"] == "pi" and evs[0]["chunks"] >= 1
    for x in memsink.records:
        validate_record(x)


# --- svc_flood chaos + ReplicaSet failover -----------------------------------


def test_svc_flood_grammar():
    (d,) = parse_chaos("svc_flood:any@s3:hot")
    assert (d.kind, d.seg_id, d.param) == ("svc_flood", 3, "hot")
    (d,) = parse_chaos("svc_flood:any@s1")
    assert d.param == "cold"  # default lane
    with pytest.raises(ValueError, match="must be a lane"):
        parse_chaos("svc_flood:any@s1:luke")
    with pytest.raises(ValueError, match="must be a lane"):
        parse_chaos("svc_flood:any@s1:0.5")


def test_svc_flood_injects_lane_shed(service, memsink):
    svc, cli = service
    svc.inject_chaos(f"svc_flood:any@s{svc._seq + 1}:cold")
    r = cli.query("pi", x=1_000)  # would classify hot; flood wins
    assert r["ok"] is False
    assert r["error"] == "overloaded"
    assert r["lane"] == "cold"
    assert "svc_flood" in r["detail"]
    assert cli.pi(1_000) == o_pi(1_000)  # one-shot: next request admits
    assert svc.stats()["lane_shed_cold"] >= 1
    evs = [x for x in memsink.records if x["event"] == "service_lane_shed"]
    assert evs and evs[-1]["lane"] == "cold"
    for x in memsink.records:
        validate_record(x)


def test_replicaset_fails_over_on_flood_shed(ledger_dir):
    cfg = _cfg(str(ledger_dir))
    with SieveService(cfg, _settings()) as a, \
            SieveService(cfg, _settings()) as b:
        # round-robin starts at replica 0: A sheds typed overloaded
        # (lane cold) via the injected flood, the set retries B —
        # exact answer, no client-visible error, no client change
        a.inject_chaos(f"svc_flood:any@s{a._seq + 1}:cold")
        with ReplicaSet([a.addr, b.addr], timeout_s=10,
                        backoff_base_s=0.01) as rs:
            assert rs.pi(30_000) == o_pi(30_000)
            assert rs.failovers >= 1
        assert a.stats()["lane_shed_cold"] >= 1


# --- live follow -------------------------------------------------------------


def test_follower_swaps_and_inherits_lru(src_dir, tmp_path, memsink):
    wled = _seed_serving(src_dir, tmp_path, 2)
    with SieveService(_cfg(str(tmp_path)), _settings()) as svc:
        fol = LedgerFollower(svc, refresh_s=1.0)  # no thread: poll by hand
        old = svc.index
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.pi(20_000) == o_pi(20_000)  # warms the LRU
            assert fol.poll_once() == "unchanged"
            for r in _remaining(src_dir, 2):
                wled.record(r)
            assert fol.poll_once() == "swapped"
            new = svc.index
            assert new is not old
            assert new.lru is old.lru  # hot queries stay hot across swaps
            assert new.covered_hi > old.covered_hi
            assert svc._refreshes == 1
            # the freshly covered range answers from the index, exact
            assert cli.pi(N - 1) == o_pi(N - 1)
            h = cli.health()
            assert h["covered_hi"] == new.covered_hi
            assert h["refreshes"] == 1
    ev = [x for x in memsink.records if x["event"] == "service_refreshed"]
    assert len(ev) == 1
    assert ev[0]["covered_hi"] > ev[0]["prev_covered_hi"]
    validate_record(ev[0])


def test_follower_identical_rewrite_is_noop(src_dir, tmp_path):
    wled = _seed_serving(src_dir, tmp_path, 2)
    with SieveService(_cfg(str(tmp_path)), _settings()) as svc:
        fol = LedgerFollower(svc, refresh_s=1.0)
        old = svc.index
        # idempotent re-record: new mtime, identical content/checksum
        wled.record(next(iter(wled.completed().values())))
        assert fol.poll_once() == "unchanged"
        assert svc.index is old
        assert svc._refreshes == 0


def test_follower_corrupt_read_is_skipped_refresh(src_dir, tmp_path, memsink):
    wled = _seed_serving(src_dir, tmp_path, 2)
    ledger_path = tmp_path / LEDGER_NAME
    good = ledger_path.read_text()
    with SieveService(_cfg(str(tmp_path)), _settings()) as svc:
        fol = LedgerFollower(svc, refresh_s=1.0)
        old = svc.index
        ledger_path.write_text(good[: len(good) // 2])  # torn write
        assert fol.poll_once() == "failed"
        assert svc.index is old  # keeps serving the previous snapshot
        assert svc._refresh_failed == 1
        # recovery: the writer restores a (longer) good ledger
        for r in _remaining(src_dir, 2):
            wled.record(r)
        assert fol.poll_once() == "swapped"
        assert svc.index.covered_hi > old.covered_hi
    ev = [x for x in memsink.records
          if x["event"] == "service_refresh_failed"]
    assert len(ev) == 1 and "LedgerCorrupt" in ev[0]["reason"]
    validate_record(ev[0])


def test_follower_vanished_ledger_never_regresses(src_dir, tmp_path, memsink):
    _seed_serving(src_dir, tmp_path, 2)
    ledger_path = tmp_path / LEDGER_NAME
    with SieveService(_cfg(str(tmp_path)), _settings()) as svc:
        fol = LedgerFollower(svc, refresh_s=1.0)
        old = svc.index
        # the coordinator's quarantine window: the file is gone between
        # polls — an empty snapshot would regress covered_hi, so skip
        ledger_path.unlink()
        assert fol.poll_once() == "failed"
        assert svc.index is old
        assert svc.index.covered_hi == old.covered_hi
    ev = [x for x in memsink.records
          if x["event"] == "service_refresh_failed"]
    assert len(ev) == 1 and "regress" in ev[0]["reason"]


def test_svc_refresh_corrupt_chaos_then_recovery(src_dir, tmp_path):
    wled = _seed_serving(src_dir, tmp_path, 2)
    with SieveService(_cfg(str(tmp_path)), _settings()) as svc:
        fol = LedgerFollower(svc, refresh_s=1.0)
        svc.inject_chaos(f"svc_refresh_corrupt:any@s{fol.attempts + 1}")
        for r in _remaining(src_dir, 2):
            wled.record(r)
        assert fol.poll_once() == "failed"  # directive consumed, one-shot
        assert fol.poll_once() == "swapped"  # very next poll recovers
        assert svc.index.covered_hi == N + 1


def test_follower_thread_follows_live_writer(src_dir, tmp_path):
    wled = _seed_serving(src_dir, tmp_path, 2)
    settings = _settings(refresh_s=0.05)
    with SieveService(_cfg(str(tmp_path)), settings) as svc:
        assert svc.follower is not None
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            h0 = cli.health()
            for r in _remaining(src_dir, 2):
                wled.record(r)
                time.sleep(0.1)
            deadline = time.monotonic() + 10
            while cli.health()["refreshes"] < 1:
                assert time.monotonic() < deadline, "follower never swapped"
                time.sleep(0.05)
            h1 = cli.health()
            assert h1["covered_hi"] > h0["covered_hi"]
            assert cli.pi(N - 1) == o_pi(N - 1)


# --- graceful drain ----------------------------------------------------------


def test_drain_sheds_typed_draining(src_dir, memsink):
    with SieveService(_cfg(str(src_dir)), _settings()) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.pi(100) == o_pi(100)
            svc.drain()
            r = cli.query("pi", x=100)
            assert r["error"] == "draining"
            assert "draining" in r["detail"]
            assert cli.health()["draining"] is True
            assert svc.wait_drained(5)
            assert svc.stats()["draining_replies"] == 1
            # the listener is closed: new connections are refused
            host, port = svc.addr.split(":")
            with pytest.raises(OSError):
                socket.create_connection((host, int(port)), timeout=1)
    ev = [x for x in memsink.records if x["event"] == "service_drain"]
    assert len(ev) == 1
    validate_record(ev[0])


def test_drain_answers_inflight_queries(src_dir):
    settings = _settings(cold_delay_s=0.3)
    with SieveService(_cfg(str(src_dir)), settings) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli, \
                ServiceClient(svc.addr, timeout_s=30) as cli2:
            box = {}

            def fire():
                box["reply"] = cli.query("pi", x=150_000)  # cold: ~0.3 s

            t = threading.Thread(target=fire)
            t.start()
            time.sleep(0.1)  # inside the simulated cold latency
            svc.drain()
            shed = cli2.query("pi", x=100)
            assert shed["error"] == "draining"
            t.join(timeout=30)
            assert not t.is_alive()
            assert box["reply"]["ok"], box["reply"]
            assert box["reply"]["value"] == o_pi(150_000)
            assert svc.wait_drained(10)


def test_shutdown_wire_message_drains(src_dir):
    with SieveService(_cfg(str(src_dir)), _settings()) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            r = cli.shutdown()
            assert r["ok"] and r["draining"]
            assert cli.query("pi", x=100)["error"] == "draining"
            assert svc.wait_drained(5)


def test_svc_drain_chaos_directive(src_dir):
    with SieveService(_cfg(str(src_dir)), _settings()) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            svc.inject_chaos(f"svc_drain:any@s{svc._seq + 1}")
            r = cli.query("pi", x=100)
            assert r["error"] == "draining"
            assert svc._draining


# --- replica_down + CallTimeout ----------------------------------------------


def test_replica_down_drops_connections(src_dir):
    with SieveService(_cfg(str(src_dir)), _settings()) as svc:
        with ServiceClient(svc.addr, timeout_s=5) as cli:
            svc.inject_chaos(f"replica_down:any@s{svc._seq + 1}:0.4")
            with pytest.raises((ConnectionError, OSError)):
                cli.pi(100)
            # inside the window a fresh connection is dropped too
            with ServiceClient(svc.addr, timeout_s=5) as cli2, \
                    pytest.raises((ConnectionError, OSError)):
                cli2.pi(100)
        deadline = time.monotonic() + 5
        while True:  # after the window the replica answers again
            try:
                with ServiceClient(svc.addr, timeout_s=5) as cli3:
                    assert cli3.pi(100) == o_pi(100)
                break
            except (ConnectionError, OSError):
                assert time.monotonic() < deadline
                time.sleep(0.1)


def test_call_timeout_closes_desynced_socket(src_dir):
    """Regression: a timed-out call used to leave its
    request in flight, so the next call read the PREVIOUS reply."""
    with SieveService(_cfg(str(src_dir)), _settings()) as svc:
        with ServiceClient(svc.addr, timeout_s=0.3) as cli:
            svc.inject_chaos(f"svc_stall:any@s{svc._seq + 1}:1.0")
            with pytest.raises(CallTimeout) as ei:
                cli.pi(100)
            assert ei.value.kind == "timeout"
            # the poisoned connection fails fast — it must never hand the
            # stalled pi(100) reply to a different request
            with pytest.raises(ConnectionError, match="desynced"):
                cli.pi(200_000_000)


# --- ReplicaSet --------------------------------------------------------------


def test_replicaset_fails_over_from_dead_replica(src_dir):
    with SieveService(_cfg(str(src_dir)), _settings()) as svc:
        with ReplicaSet([_dead_addr(), svc.addr], timeout_s=10,
                        rounds=2, backoff_base_s=0.01) as rs:
            assert rs.pi(30_000) == o_pi(30_000)
            assert rs.nth_prime(100) == int(P[99])


def test_replicaset_fails_over_from_draining_replica(src_dir):
    s1 = SieveService(_cfg(str(src_dir)), _settings()).start()
    s2 = SieveService(_cfg(str(src_dir)), _settings()).start()
    try:
        addrs = [s1.addr, s2.addr]  # before drain closes s1's listener
        s1.drain()
        with ReplicaSet(addrs, timeout_s=10,
                        rounds=2, backoff_base_s=0.01) as rs:
            for _ in range(4):  # round-robin must steer off s1 every time
                assert rs.pi(30_000) == o_pi(30_000)
            assert s2.stats()["requests"] >= 4
    finally:
        s1.stop()
        s2.stop()


def test_replicaset_never_retries_bad_request(src_dir):
    with SieveService(_cfg(str(src_dir)), _settings()) as svc:
        with ReplicaSet([svc.addr, svc.addr], timeout_s=10) as rs:
            r = rs.query("count", lo=9, hi=4)
            assert r["error"] == "bad_request"
            assert rs.failovers == 0  # returned from the first replica
            with pytest.raises(ServiceError) as ei:
                rs.count(9, 4)
            assert ei.value.kind == "bad_request"


def test_replicaset_all_dead_is_typed_unavailable():
    rs = ReplicaSet([_dead_addr(), _dead_addr()], timeout_s=2,
                    rounds=2, backoff_base_s=0.01, backoff_cap_s=0.02)
    with pytest.raises(ServiceError) as ei:
        rs.pi(100)
    assert ei.value.kind == "unavailable"


# --- wire chaos gate + health fields -----------------------------------------


def test_wire_chaos_gate_refuses_and_events(src_dir, memsink):
    with SieveService(_cfg(str(src_dir)), _settings()) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            r = cli.inject_chaos("svc_shed:any@s1")
            assert not r["ok"] and r["error"] == "bad_request"
            assert "--allow-chaos" in r["detail"]
            assert len(svc.chaos) == 0  # nothing was scheduled
            assert cli.pi(100) == o_pi(100)  # and nothing sheds
    ev = [x for x in memsink.records
          if x["event"] == "service_chaos_refused"]
    assert len(ev) == 1 and ev[0]["spec"] == "svc_shed:any@s1"
    validate_record(ev[0])


def test_wire_chaos_allowed_when_enabled(src_dir):
    with SieveService(_cfg(str(src_dir)),
                      _settings(wire_chaos=True)) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            r = cli.inject_chaos(f"svc_shed:any@s{svc._seq + 1}")
            assert r["ok"] and r["injected"] == 1
            assert cli.query("pi", x=100)["error"] == "overloaded"


def test_health_freshness_fields(src_dir):
    with SieveService(_cfg(str(src_dir)), _settings()) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            h = cli.health()
            assert h["covered_hi"] == svc.index.covered_hi
            assert h["refreshes"] == 0
            assert h["draining"] is False
            assert h["snapshot_age_s"] >= 0
            s = cli.stats()
            for key in ("refreshes", "refresh_failed", "refresh_attempts",
                        "snapshot_age_s", "draining"):
                assert key in s


# --- ReplicaSet: pipelined failover ------------------------------------------


def test_query_many_pipelines_in_request_order(ledger_dir):
    with SieveService(_cfg(str(ledger_dir)),
                      _settings(queue_limit=64)) as svc:
        with ReplicaSet([svc.addr], timeout_s=30) as rs:
            reqs = [{"op": "pi", "x": 100},
                    {"op": "count", "lo": 10_000, "hi": 40_000},
                    {"op": "is_prime", "x": 12_347},
                    {"op": "pi", "x": 30_000}]
            out = rs.query_many(reqs, window=2)
            assert [r["ok"] for r in out] == [True] * 4
            assert out[0]["value"] == o_pi(100)
            assert out[1]["value"] == o_count(10_000, 40_000)
            assert bool(out[2]["value"]) == o_is_prime(12_347)
            assert out[3]["value"] == o_pi(30_000)
            for r in out:
                assert r["probe"]["addr"] == svc.addr
                assert r["probe"]["t_done"] >= r["probe"]["t_send"]
            assert rs.failovers == 0


def test_query_many_mid_pipeline_kill_fails_over_suffix_only(ledger_dir):
    cfg = _cfg(str(ledger_dir))
    with SieveService(cfg, _settings()) as a, \
            SieveService(cfg, _settings()) as b:
        with ReplicaSet([a.addr, b.addr], timeout_s=30,
                        circuit_cooldown_s=5.0) as rs:
            # replica A's 3rd query cuts the connection (dead-replica
            # chaos) and keeps dropping new ones for 0.5 s, so the
            # unanswered suffix must fail over to B
            a.inject_chaos(f"replica_down:any@s{a._seq + 3}:0.5")
            reqs = [{"op": "pi", "x": x}
                    for x in (100, 5_000, 12_345, 30_000, 45_000, 49_999)]
            out = rs.query_many(reqs, window=2)
            assert [r["value"] for r in out] == [o_pi(r["x"])
                                                 for r in reqs]
            addrs = [r["probe"]["addr"] for r in out]
            # the head was answered by A before the kill and is KEPT —
            # only the unanswered suffix moved to B
            assert addrs[0] == a.addr
            assert addrs[2:] == [b.addr] * 4
            assert rs.failovers >= 1


def test_query_many_typed_finals_and_unavailable(ledger_dir):
    with SieveService(_cfg(str(ledger_dir)), _settings()) as svc:
        with ReplicaSet([svc.addr], timeout_s=30) as rs:
            out = rs.query_many([{"op": "pi", "x": 100},
                                 {"op": "nope"}])
            assert out[0]["value"] == o_pi(100)
            assert out[1]["error"] == "bad_request"  # final, not retried
            assert rs.failovers == 0
    with ReplicaSet([_dead_addr()], timeout_s=2, rounds=1,
                    probe_timeout_s=0.5) as rs:
        out = rs.query_many([{"op": "pi", "x": 100}])
        assert out[0]["ok"] is False
        assert out[0]["error"] == "unavailable"
        assert "no replica answered" in out[0]["detail"]


def test_replicaset_query_batch_fails_over_whole_rpc(ledger_dir):
    with SieveService(_cfg(str(ledger_dir)), _settings()) as svc:
        with ReplicaSet([_dead_addr(), svc.addr], timeout_s=30,
                        probe_timeout_s=0.5) as rs:
            out = rs.query_batch([{"op": "pi", "x": 100},
                                  {"op": "is_prime", "x": 12_347}])
            assert out[0]["value"] == o_pi(100)
            assert bool(out[1]["value"]) == o_is_prime(12_347)


# --- ClientPool --------------------------------------------------------------


def test_client_pool_reuses_connections_across_cycles(ledger_dir):
    cfg = _cfg(str(ledger_dir))
    with SieveService(cfg, _settings()) as a, \
            SieveService(cfg, _settings()) as b:
        with ClientPool(timeout_s=10) as pool:
            first = {addr: pool.get(addr) for addr in (a.addr, b.addr)}
            for _ in range(3):  # three refresh cycles, zero new sockets
                for addr in (a.addr, b.addr):
                    cli = pool.get(addr)
                    assert cli is first[addr]
                    assert cli.health()["ok"]
            assert pool.connects == 2
            assert pool.reconnects == 0
            # a transport failure invalidates ONE entry; only that
            # endpoint reconnects (and the reconnect is counted)
            pool.invalidate(a.addr)
            assert pool.get(a.addr) is not first[a.addr]
            assert pool.get(b.addr) is first[b.addr]
            assert (pool.connects, pool.reconnects) == (3, 1)
            # a client that died in place (server cut it) also
            # reconnects on the next get
            pool.get(a.addr).close()
            assert pool.get(a.addr).health()["ok"]
            assert (pool.connects, pool.reconnects) == (4, 2)


