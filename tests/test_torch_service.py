"""The port's query server against the reference's (sieve/service/server.py).

Each comparison runs the reference's ``SieveService`` (``cpu-numpy``, as
its own tests run it) and the port's side by side, in one process, over
one ledger: the reference's counting run writes it once and each server
gets a byte-identical copy of the directory, because each server is the
writer of the segment store it keeps there. Both get equal
``ServiceSettings`` kwargs. The port's server runs with ``cpu-numpy`` and
with ``cuda`` on ``device="cpu"`` (the fused kernel's plain version).

Replies must be equal except for the wall-clock fields named in
``WALL_CLOCK``: ``elapsed_ms`` (handler latency), ``t_recv``/``t_sent``
(trace-epoch timestamps), ``snapshot_age_s`` (seconds since the ledger
was read) and ``ctx`` (the client's random run id). From ``stats`` the
latency-driven ``exemplars_kept`` (the sampler keeps outliers of its own
rolling p95) and the ``slo`` windows are left out as well.

This is the port of tests/test_service.py:200-557 (the wire ops against
an oracle, the typed overloaded / deadline_exceeded / degraded / draining
outcomes, coalescing, breaker recovery, the service chaos kinds,
``--range-lo``) and of its ``serve`` CLI test, on the port's CLI: the
address line, queries, the ``shutdown`` op and exit 0; ``--procs 2``;
``--backend cuda`` without a card, which exits 2 before it listens. The
settings' fields, defaults and ``from_env`` variables equal the
reference's.
"""

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import sieve.metrics as ref_metrics
import sieve.service.server as ref_server
import sieve_torch.service.server as port_server
from sieve.config import SieveConfig as RefConfig
from sieve.coordinator import run_local as ref_run_local
from sieve.seed import seed_primes
from sieve.service import ServiceClient as RefClient
from sieve_torch import metrics
from sieve_torch.config import SieveConfig
from sieve_torch.metrics import MemorySink, validate_record
from sieve_torch.service import ServiceClient, ServiceSettings, SieveService

REPO = Path(__file__).resolve().parent.parent
N = 50_000
ORACLE_HI = 200_000
P = seed_primes(ORACLE_HI)

WALL_CLOCK = frozenset({"elapsed_ms", "t_recv", "t_sent", "snapshot_age_s",
                        "ctx"})
STATS_VOLATILE = frozenset({"exemplars_kept", "slo"})

#: the port's server variants: (backend, device)
PORT_BACKENDS = [
    pytest.param(("cpu-numpy", "cpu"), id="cpu-numpy"),
    pytest.param(("cuda", "cpu"), id="cuda-plain"),
]


def o_pi(x):
    return int(np.searchsorted(P, x, side="right"))


def o_count(lo, hi):
    return int(np.searchsorted(P, hi, side="left")
               - np.searchsorted(P, lo, side="left"))


def o_pairs(lo, hi, gap):
    w = P[(P >= lo) & (P < hi)]
    idx = np.searchsorted(w, w + gap)
    ok = idx < w.size
    return int(np.count_nonzero(w[idx[ok]] == w[ok] + gap))


def cfg_kw(checkpoint_dir, **kw) -> dict:
    base = dict(n=N, packing="wheel30", n_segments=4, quiet=True,
                checkpoint_dir=checkpoint_dir)
    base.update(kw)
    return base


def settings_kw(**kw) -> dict:
    base = dict(workers=2, queue_limit=16, default_deadline_s=10.0,
                cold_chunk=1 << 16, breaker_cooldown_s=0.4)
    base.update(kw)
    return base


def plain(x):
    """A reply as plain data without its wall-clock fields."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items() if k not in WALL_CLOCK}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def plain_stats(s: dict) -> dict:
    return {k: v for k, v in plain(s).items() if k not in STATS_VOLATILE}


def write_ledger(path: Path, **kw) -> Path:
    """The reference's counting run writes the ledger both servers read."""
    ref_run_local(RefConfig(**cfg_kw(str(path), backend="cpu-numpy", **kw)))
    return path


@pytest.fixture(scope="module")
def ledger_dir(tmp_path_factory):
    """A pristine sieved checkpoint dir: never served in place."""
    return write_ledger(tmp_path_factory.mktemp("svc_ledger"))


@pytest.fixture(params=PORT_BACKENDS)
def port_backend(request):
    return request.param


@pytest.fixture
def memsink():
    sink = MemorySink()
    metrics.add_sink(sink)
    yield sink
    metrics.remove_sink(sink)


def _copy(src, dest: Path):
    if src is None:
        return None
    shutil.copytree(src, dest)
    return str(dest)


def port_service(checkpoint_dir, port_backend, cfg=None, **settings):
    backend, device = port_backend
    return SieveService(
        SieveConfig(**cfg_kw(checkpoint_dir, backend=backend, device=device,
                             **(cfg or {}))),
        ServiceSettings(**settings_kw(**settings)))


@contextlib.contextmanager
def served_pair(tmp_path, ledger, port_backend, cfg=None, **settings):
    """(reference server, port server), started over copies of ``ledger``
    (None: cold-only servers) with equal settings; both stop on exit."""
    ref_dir = _copy(ledger, tmp_path / "ref")
    port_dir = _copy(ledger, tmp_path / "port")
    ref = ref_server.SieveService(
        RefConfig(**cfg_kw(ref_dir, backend="cpu-numpy", **(cfg or {}))),
        ref_server.ServiceSettings(**settings_kw(**settings)))
    with ref, port_service(port_dir, port_backend, cfg, **settings) as port:
        yield ref, port


@contextlib.contextmanager
def client_pair(ref, port, negotiate=True, timeout_s=30):
    with RefClient(ref.addr, timeout_s=timeout_s, negotiate=negotiate) as a, \
            ServiceClient(port.addr, timeout_s=timeout_s,
                          negotiate=negotiate) as b:
        yield a, b


def assert_same(fn, a, b):
    """``fn`` on both clients gives equal replies (wall clock aside)."""
    got_ref, got_port = fn(a), fn(b)
    assert plain(got_port) == plain(got_ref)
    return got_port


@pytest.fixture
def service(ledger_dir, port_backend, tmp_path):
    with port_service(_copy(ledger_dir, tmp_path / "port"),
                      port_backend) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            yield svc, cli


# --- settings: the reference's fields, defaults and variables --------------


def _env_names(module) -> set[str]:
    src = Path(module.__file__).read_text()
    start = src.index("def from_env")
    body = src[start:src.index("return dataclasses.replace", start)]
    return set(re.findall(r'"(SIEVE_[A-Z0-9_]+)"', body))


def test_settings_fields_defaults_and_env_names_match_reference(monkeypatch):
    ref_fields = [(f.name, f.default) for f in
                  dataclasses.fields(ref_server.ServiceSettings)]
    port_fields = [(f.name, f.default) for f in
                   dataclasses.fields(ServiceSettings)]
    assert port_fields == ref_fields
    names = _env_names(port_server)
    assert names == _env_names(ref_server)
    assert port_server._SLO_ENV_PREFIX == ref_server._SLO_ENV_PREFIX
    # every variable set to a valid non-default value reads alike
    values = {n: "3" for n in names}
    values.update({"SIEVE_SVC_COLD_BACKEND": "mesh",
                   "SIEVE_SVC_DEBUG_DIR": "/nonexistent/dbg",
                   "SIEVE_SVC_SLO_MS_PI": "7.5",
                   "SIEVE_SVC_EXEMPLAR_SLACK": "2.5",
                   "SIEVE_METRICS_SAMPLE_S": "0.5"})
    for n, v in values.items():
        monkeypatch.setenv(n, v)
    got = dataclasses.asdict(ServiceSettings.from_env())
    want = dataclasses.asdict(ref_server.ServiceSettings.from_env())
    assert got == want
    assert got["cold_backend"] == "mesh" and got["slo_ms"] == {"pi": 7.5}
    assert ServiceSettings.from_env(workers=7).workers == 7


def test_error_kinds_match_reference():
    kinds = {k.__name__: v for k, v in port_server._ERROR_KIND.items()}
    assert kinds == {k.__name__: v for k, v in ref_server._ERROR_KIND.items()}
    assert port_server._STATS == ref_server._STATS


# --- every wire op, both servers, v1 and v2 ---------------------------------


def _ops(covered: int, total: int) -> list[tuple[str, dict]]:
    return [
        ("pi", {"x": 0}), ("pi", {"x": 2}), ("pi", {"x": 30_000}),
        ("pi", {"x": covered - 1}), ("pi", {"x": 90_000}),
        ("is_prime", {"x": 49_999}), ("is_prime", {"x": 89_989}),
        ("is_prime", {"x": 1}),
        ("count", {"lo": 10_000, "hi": 40_000}),
        ("count", {"lo": 40_000, "hi": 90_000}),
        ("count", {"lo": 7, "hi": 7}),
        ("count", {"lo": 2, "hi": 40_000, "kind": "twins"}),
        ("count", {"lo": 2, "hi": 40_000, "kind": "cousins"}),
        ("count", {"lo": 45_000, "hi": 55_000, "kind": "twins"}),
        ("nth_prime", {"k": 1}), ("nth_prime", {"k": 1000}),
        ("nth_prime", {"k": total + 50}),
        ("primes", {"lo": 49_990, "hi": 50_050}),
        ("primes", {"lo": 2, "hi": 3000}),
        ("pi", {"x": "nope"}), ("pi", {"x": True}),
        ("count", {"lo": 9, "hi": 4}),
        ("count", {"lo": 2, "hi": 9, "kind": "sexy"}),
        ("nth_prime", {"k": 0}), ("frobnicate", {}),
        ("primes", {"lo": 2, "hi": 10**7}),
    ]


@pytest.mark.parametrize("negotiate", [False, True], ids=["v1", "v2"])
def test_every_query_op_equals_reference(ledger_dir, port_backend, tmp_path,
                                         negotiate):
    ref_before = ref_metrics.registry().snapshot()
    with served_pair(tmp_path, ledger_dir, port_backend,
                     max_primes=20_000) as (ref, port):
        covered, total = port.index.covered_hi, port.index.total_primes
        assert (covered, total) == (ref.index.covered_hi,
                                    ref.index.total_primes)
        with client_pair(ref, port, negotiate) as (a, b):
            assert b.wire_v == a.wire_v == (2 if negotiate else 1)
            for op, kw in _ops(covered, total):
                r = assert_same(lambda c: c.query(op, **kw), a, b)
                if op == "pi" and isinstance(kw["x"], int) \
                        and not isinstance(kw["x"], bool):
                    assert r["value"] == o_pi(kw["x"])
            members = [{"op": "pi", "x": 30_000}, {"op": "pi", "x": 90_000},
                       {"op": "is_prime", "x": 49_999},
                       {"op": "count", "lo": 100, "hi": 80_000},
                       {"op": "count", "lo": 9, "hi": 4},
                       {"op": "pi", "x": "bad"}]
            out = assert_same(lambda c: c.query_batch(members), a, b)
            assert out[1]["value"] == o_pi(90_000)
            assert out[3]["value"] == o_count(100, 80_000)
            assert out[4]["error"] == "bad_request"
            assert_same(lambda c: c.health(), a, b)
            assert plain_stats(b.stats()) == plain_stats(a.stats())
            # metrics / debug / profile / exemplars carry clocks and
            # sampler state: their shape is the reference's (each registry
            # is process-wide and holds what earlier tests in this process
            # recorded: compare the service's names this run touched)
            ma, mb = a.metrics(), b.metrics()
            touched = {k for k, v in ma.items() if k.startswith("service")
                       and ref_before.get(k) != v}
            assert touched and touched <= set(mb)
            assert set(b.debug()) == set(a.debug())
            pa, pb = a.profile(), b.profile()
            assert set(pb) == set(pa) and pb["role"] == pa["role"]
            ea, eb = a.exemplars(n=5), b.exemplars(n=5)
            assert isinstance(eb, list) and isinstance(ea, list)
            # chaos is refused typed when the wire gate is closed
            assert_same(lambda c: c.inject_chaos("svc_shed:any@s99"), a, b)
            assert_same(lambda c: c.shutdown(), a, b)
        assert ref.wait_drained(10) and port.wait_drained(10)


def test_hello_negotiation_equals_reference(ledger_dir, port_backend, tmp_path):
    import socket

    from sieve_torch.rpc import recv_msg, send_msg

    with served_pair(tmp_path, ledger_dir, port_backend) as (ref, port):
        got = []
        for svc in (ref, port):
            host, p = svc.addr.rsplit(":", 1)
            with socket.create_connection((host, int(p)), timeout=10) as s:
                replies = []
                for wire in ([1, 2], [1], [2, 7], [], "x"):
                    send_msg(s, {"type": "hello", "id": 1, "wire": wire})
                    replies.append(recv_msg(s))
                got.append(replies)
        assert got[1] == got[0]
        assert [r["wire"] for r in got[1]] == [2, 1, 2, 1, 1]


def test_chaos_op_with_the_gate_open_equals_reference(ledger_dir, port_backend,
                                                      tmp_path):
    with served_pair(tmp_path, ledger_dir, port_backend,
                     wire_chaos=True) as (ref, port):
        with client_pair(ref, port) as (a, b):
            assert_same(lambda c: c.query("pi", x=100), a, b)
            assert ref._seq == port._seq
            spec = f"svc_shed:any@s{port._seq + 1}"
            r = assert_same(lambda c: c.inject_chaos(spec), a, b)
            assert r["ok"] and r["injected"] == 1
            r = assert_same(lambda c: c.query("pi", x=100), a, b)
            assert r["error"] == "overloaded" and "svc_shed" in r["detail"]
            assert_same(lambda c: c.inject_chaos("nonsense:any@s1"), a, b)


# --- the reference's service tests on the port ------------------------------


def test_ops_exact_over_tcp(service):
    svc, cli = service
    covered = svc.index.covered_hi
    assert cli.pi(0) == 0
    assert cli.pi(2) == 1
    assert cli.pi(30_000) == o_pi(30_000)
    assert cli.pi(covered - 1) == o_pi(covered - 1)
    assert cli.pi(90_000) == o_pi(90_000)
    assert cli.count(10_000, 40_000) == o_count(10_000, 40_000)
    assert cli.count(40_000, 90_000) == o_count(40_000, 90_000)
    assert cli.count(2, 40_000, "twins") == o_pairs(2, 40_000, 2)
    assert cli.count(2, 40_000, "cousins") == o_pairs(2, 40_000, 4)
    assert cli.nth_prime(1000) == int(P[999])
    beyond = svc.index.total_primes + 50
    assert cli.nth_prime(beyond) == int(P[beyond - 1])
    assert cli.is_prime(89_989) and not cli.is_prime(89_991)
    want = P[(P >= 49_990) & (P < 50_050)]
    assert list(cli.primes(49_990, 50_050)) == [int(v) for v in want]


def test_repeated_hot_query_is_an_index_hit(service):
    _svc, cli = service
    want = o_pi(30_000)
    assert cli.pi(30_000) == want
    s0 = cli.stats()
    for _ in range(3):
        assert cli.pi(30_000) == want
    s1 = cli.stats()
    assert s1["index_hits"] - s0["index_hits"] >= 3
    assert s1["cold_computes"] == s0["cold_computes"]
    assert s1["materialized"] == s0["materialized"]


def test_queue_saturation_sheds_typed_never_hangs(ledger_dir, port_backend,
                                                  tmp_path):
    with port_service(_copy(ledger_dir, tmp_path / "p"), port_backend,
                      workers=1, queue_limit=1, cold_delay_s=0.4) as svc:
        replies = []
        lock = threading.Lock()

        def fire():
            with ServiceClient(svc.addr, timeout_s=30) as c:
                r = c.query("pi", x=90_000)
                with lock:
                    replies.append(r)

        threads = [threading.Thread(target=fire) for _ in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads), "silent hang"
        assert len(replies) == 5
        shed = [r for r in replies if not r.get("ok")]
        assert shed, "queue_limit=1 with 5 concurrent colds never shed"
        for r in shed:
            assert r["error"] == "overloaded" and "detail" in r
        for r in replies:
            if r.get("ok"):
                assert r["value"] == o_pi(90_000)


def test_typed_outcomes_under_chaos_equal_reference(ledger_dir, port_backend,
                                                    tmp_path):
    """The same schedule, drawn on the same request numbers, gives the
    same typed outcome (kind and error) on both servers."""
    with served_pair(tmp_path, ledger_dir, port_backend) as (ref, port):
        with client_pair(ref, port) as (a, b):
            def step(spec, op, **kw):
                for svc in (ref, port):
                    svc.inject_chaos(spec.format(seq=svc._seq + 1))
                return assert_same(lambda c: c.query(op, **kw), a, b)

            r = step("svc_shed:any@s{seq}", "pi", x=100)
            assert r["error"] == "overloaded" and "svc_shed" in r["detail"]
            r = step("svc_stall:any@s{seq}:0.6", "pi", deadline_s=0.2,
                     x=30_000)
            assert r["error"] == "deadline_exceeded"
            assert r["partial"]["answered_hi"] >= 2
            r = step("svc_stall:any@s{seq}:0.05", "pi", deadline_s=5.0,
                     x=30_000)
            assert r["value"] == o_pi(30_000)
            r = step("backend_down:any@s{seq}:0.6", "pi", x=90_000)
            assert r["error"] == "degraded"
            r = step("svc_flood:any@s{seq}:cold", "pi", x=95_000)
            assert r["error"] == "overloaded" and r["lane"] == "cold"
            r = step("svc_drain:any@s{seq}", "pi", x=100)
            assert r["error"] == "draining"
            r = assert_same(lambda c: c.query("pi", x=100), a, b)
            assert r["error"] == "draining"


def test_injected_shed_and_stall_deadline(service, memsink):
    svc, cli = service
    svc.inject_chaos(f"svc_shed:any@s{svc._seq + 1}")
    r = cli.query("pi", x=100)
    assert r["error"] == "overloaded" and "svc_shed" in r["detail"]
    svc.inject_chaos(f"svc_stall:any@s{svc._seq + 1}:0.6")
    r = cli.query("pi", deadline_s=0.2, x=30_000)
    assert r["error"] == "deadline_exceeded"
    assert isinstance(r["partial"], dict) and r["partial"]["answered_hi"] >= 2
    svc.inject_chaos(f"svc_stall:any@s{svc._seq + 1}:0.05")
    assert cli.pi(30_000, deadline_s=5.0) == o_pi(30_000)
    shed = [x for x in memsink.records if x["event"] == "service_shed"]
    assert shed and shed[0]["op"] == "pi"
    for x in memsink.records:
        validate_record(x)


def test_overlapping_cold_queries_coalesce(ledger_dir, port_backend, tmp_path):
    with port_service(_copy(ledger_dir, tmp_path / "p"), port_backend,
                      workers=4, cold_delay_s=0.3) as svc:
        got, errs = [], []

        def q():
            try:
                with ServiceClient(svc.addr, timeout_s=30) as c:
                    got.append(c.pi(90_000))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        t1, t2 = threading.Thread(target=q), threading.Thread(target=q)
        t1.start()
        time.sleep(0.1)  # inside the leader's simulated 0.3 s compute
        t2.start()
        t1.join(30)
        t2.join(30)
        assert not errs
        assert got == [o_pi(90_000)] * 2
        with ServiceClient(svc.addr) as cli:
            s = cli.stats()
            assert s["coalesced"] >= 1
            c0 = s["cold_computes"]
            assert cli.pi(90_000) == o_pi(90_000)
            s2 = cli.stats()
            assert s2["cold_computes"] == c0
            assert s2["cold_cache_hits"] > s["cold_cache_hits"]


def test_backend_down_keeps_hot_index_up(service, memsink):
    svc, cli = service
    svc.inject_chaos(f"backend_down:any@s{svc._seq + 1}:0.6")
    assert cli.query("pi", x=90_000)["error"] == "degraded"
    assert cli.health()["status"] == "degraded"
    assert cli.pi(30_000) == o_pi(30_000)
    deadline = time.monotonic() + 10
    while cli.health()["status"] != "ok":
        assert time.monotonic() < deadline, "never recovered"
        time.sleep(0.05)
    assert cli.pi(90_000) == o_pi(90_000)
    deg = [x for x in memsink.records if x["event"] == "service_degraded"]
    assert [d["entering"] for d in deg] == [True, False]
    for d in deg:
        validate_record(d)


def test_breaker_opens_after_fail_streak(ledger_dir, port_backend, tmp_path):
    with port_service(_copy(ledger_dir, tmp_path / "p"), port_backend,
                      breaker_fails=2, breaker_cooldown_s=0.3) as svc:
        calls = []

        def boom(lo, hi, seeds, seg_id=0):
            calls.append(lo)
            raise RuntimeError("backend on fire")

        svc.cold._worker = type(
            "W", (), {"process_segment": staticmethod(boom),
                      "close": staticmethod(lambda: None)})()
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.query("pi", x=90_000)["error"] == "degraded"
            assert cli.query("pi", x=90_000)["error"] == "degraded"
            n = len(calls)
            r = cli.query("pi", x=90_000)
            assert r["error"] == "degraded" and "breaker" in r["detail"]
            assert len(calls) == n
            assert cli.pi(30_000) == o_pi(30_000)
            # recovery: a working worker again after the cooldown
            svc.cold._worker = None
            deadline = time.monotonic() + 10
            while cli.health()["status"] != "ok":
                assert time.monotonic() < deadline, "breaker never closed"
                time.sleep(0.05)
            assert cli.pi(90_000) == o_pi(90_000)


def test_range_lo_shard_equals_reference(ledger_dir, port_backend, tmp_path):
    with served_pair(tmp_path, ledger_dir, port_backend,
                     range_lo=20_000) as (ref, port):
        assert port.base == ref.base == 20_000
        with client_pair(ref, port) as (a, b):
            for op, kw in [("count", {"lo": 20_000, "hi": 40_000}),
                           ("count", {"lo": 30_000, "hi": 90_000}),
                           ("count", {"lo": 2, "hi": 40_000}),
                           ("pi", {"x": 30_000}),
                           ("nth_prime", {"k": 10}),
                           ("primes", {"lo": 25_000, "hi": 25_100}),
                           ("is_prime", {"x": 30_011})]:
                assert_same(lambda c: c.query(op, **kw), a, b)
            assert_same(lambda c: c.health(), a, b)
            assert b.count(20_000, 40_000) == o_count(20_000, 40_000)
            assert b.nth_prime(10) == int(P[P >= 20_000][9])


def test_cold_only_server_equals_reference(port_backend, tmp_path):
    """No checkpoint dir: every count is cold."""
    with served_pair(tmp_path, None, port_backend) as (ref, port):
        with client_pair(ref, port) as (a, b):
            for op, kw in [("pi", {"x": 150_000}), ("nth_prime", {"k": 9000}),
                           ("count", {"lo": 1000, "hi": 70_000}),
                           ("is_prime", {"x": 199_999})]:
                assert_same(lambda c: c.query(op, **kw), a, b)
            assert plain_stats(b.stats()) == plain_stats(a.stats())
            assert b.pi(150_000) == o_pi(150_000)


# --- the port's serve CLI ---------------------------------------------------


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["SIEVE_SVC_REFRESH_S"] = "0"
    return env


def _serve(args, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "sieve_torch", "serve", "--addr", "127.0.0.1:0",
         "--quiet", *args], env=_env(), cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, **kw)


def _ledger_args(ledger_dir):
    return ["--n", str(N), "--segments", "4", "--packing", "wheel30",
            "--checkpoint-dir", str(ledger_dir)]


@pytest.mark.parametrize("backend", ["cpu-numpy", "cuda"])
def test_serve_cli_end_to_end(ledger_dir, tmp_path, backend):
    d = _copy(ledger_dir, tmp_path / "d")
    proc = _serve([*_ledger_args(d), "--backend", backend, "--device", "cpu"])
    try:
        head = json.loads(proc.stdout.readline())
        assert head["event"] == "serving" and head["segments"] == 4
        assert head["covered_hi"] == N + 1
        with ServiceClient(head["addr"], timeout_s=30) as cli:
            assert cli.wire_v == 2
            assert cli.pi(30_000) == o_pi(30_000)
            assert cli.pi(90_000) == o_pi(90_000)  # cold, on the backend
            assert cli.health()["status"] == "ok"
            assert cli.query("count", lo=9, hi=4)["error"] == "bad_request"
            assert cli.shutdown()["draining"] is True
        out, err = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out, err)
    drained = json.loads(out.strip().splitlines()[-1])
    assert drained["event"] == "drained" and drained["clean"]
    assert drained["stats"]["cold_dispatches"] == 1


def test_serve_cli_without_card_exits_2(ledger_dir, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: --backend cuda serves on it")
    for extra in ([], ["--backend", "cuda"], ["--backend", "torch"],
                  ["--backend", "cuda", "--device", "cuda:0"],
                  ["--procs", "2"]):
        proc = _serve([*_ledger_args(ledger_dir), *extra])
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 2, (extra, out, err)
        assert "no CUDA device" in err and "serving" not in out
    # the host backends need no card
    assert not list(ledger_dir.glob("store"))  # nothing was served


def test_serve_cli_procs_share_one_port(ledger_dir, tmp_path):
    d = _copy(ledger_dir, tmp_path / "d")
    proc = _serve([*_ledger_args(d), "--backend", "cuda", "--device", "cpu",
                   "--procs", "2"])
    try:
        head = json.loads(proc.stdout.readline())
        assert head["event"] == "serving" and head["supervisor"]
        assert head["procs"] == 2
        seen = set()
        deadline = time.monotonic() + 60
        while len(seen) < 2 and time.monotonic() < deadline:
            with ServiceClient(head["addr"], timeout_s=30) as cli:
                h = cli.health()
                seen.add(h["proc"])
                assert cli.pi(30_000) == o_pi(30_000)
        assert seen == {0, 1}
        proc.terminate()
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (out, err)
    last = json.loads(out.strip().splitlines()[-1])
    assert last["supervisor"] and last["clean"] and last["rcs"] == [0, 0]
