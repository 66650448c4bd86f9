"""The port's wire plane against the reference's (tests/test_wire.py).

Pipelined framing on the port's server (replies correlate by id under
out-of-order completion; mid-pipeline sheds and deadline partials land on
the right ids; inline ops overtake queued work), one slow connection never
blocking another (``svc_slow_frame``, a slowloris reader, the bounded write
queue), the ``batch`` op (exact, per-member typed outcomes, whole-batch
container faults), v1 and v2 frames and ``hello`` negotiation (a
downgrade is logged), and the mixed pairs both ways: the port's client
against the reference's server and the reference's client against the
port's, in both wire versions. A columnar batch reply of the port's
server is byte-equal to the reference's in its columns, and equal in its
header but for ``elapsed_ms`` and the ``t_recv``/``t_sent`` timestamps.
"""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

import sieve.rpc as ref_rpc
import sieve.service as ref_service
from sieve.seed import seed_primes
from sieve_torch import rpc
from sieve_torch.rpc import encode_msg, recv_msg
from sieve_torch.service import ServiceClient, ServiceError, SieveService
from tests.test_torch_service import (  # noqa: F401 — fixtures
    PORT_BACKENDS,
    WALL_CLOCK,
    _copy,
    ledger_dir,
    memsink,
    o_count,
    o_pi,
    plain,
    port_backend,
    port_service,
    served_pair,
)
from sieve_torch.metrics import validate_record

P = seed_primes(200_000)


def o_is_prime(x):
    return o_pi(x) - o_pi(x - 1) > 0


def test_wire_constants_match_reference():
    assert (rpc.WIRE_V1, rpc.WIRE_V2, rpc.SUPPORTED_WIRE) == (
        ref_rpc.WIRE_V1, ref_rpc.WIRE_V2, ref_rpc.SUPPORTED_WIRE)


@pytest.fixture
def service(ledger_dir, port_backend, tmp_path):
    with port_service(_copy(ledger_dir, tmp_path / "p"), port_backend,
                      refresh_s=0.0) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            yield svc, cli


def _svc(ledger_dir, tmp_path, port_backend=("cpu-numpy", "cpu"), **kw):
    return port_service(_copy(ledger_dir, tmp_path / "p"), port_backend,
                        refresh_s=0.0, **kw)


# --- pipelined correlation --------------------------------------------------


def test_pipelined_replies_correlate_out_of_order(ledger_dir, tmp_path,
                                                  port_backend):
    with _svc(ledger_dir, tmp_path, port_backend, workers=4,
              cold_delay_s=0.4) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            cold_id = cli.submit("pi", x=90_000)
            hot = [(cli.submit("pi", x=x), x)
                   for x in (100, 5_000, 12_345, 30_000)]
            t0 = time.monotonic()
            hot_replies = cli.drain([rid for rid, _ in hot])
            assert time.monotonic() - t0 < 0.4
            assert cli.pending() == 1
            for rid, x in hot:
                r = hot_replies[rid]
                assert r["ok"] and r["id"] == rid and r["value"] == o_pi(x)
            cold = cli.drain([cold_id])[cold_id]
            assert cold["ok"] and cold["value"] == o_pi(90_000)
            assert cli.pending() == 0


def test_pipelined_deep_inflight_all_exact(ledger_dir, tmp_path):
    with _svc(ledger_dir, tmp_path, queue_limit=256) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            xs = [(7919 * (i + 1)) % 50_000 for i in range(64)]
            ids = [cli.submit("pi", x=x) for x in xs]
            assert cli.pending() == 64
            replies = cli.drain()
            for rid, x in zip(ids, xs):
                assert replies[rid]["value"] == o_pi(x), x


def test_mid_pipeline_shed_lands_on_the_right_id(service):
    svc, cli = service
    svc.inject_chaos(f"svc_shed:any@s{svc._seq + 3}")
    xs = [100, 5_000, 12_345, 30_000, 45_000]
    ids = [cli.submit("pi", x=x) for x in xs]
    replies = cli.drain(ids)
    for k, (rid, x) in enumerate(zip(ids, xs)):
        r = replies[rid]
        if k == 2:
            assert r["ok"] is False and r["error"] == "overloaded"
            assert "svc_shed" in r["detail"]
        else:
            assert r["ok"] and r["value"] == o_pi(x)


def test_mid_pipeline_deadline_partial_lands_on_the_right_id(ledger_dir,
                                                            tmp_path):
    with _svc(ledger_dir, tmp_path, workers=1) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            svc.inject_chaos(f"svc_stall:any@s{svc._seq + 1}:0.6")
            stalled = cli.submit("pi", x=30_000, deadline_s=0.2)
            ids = [cli.submit("pi", x=x) for x in (100, 12_345)]
            replies = cli.drain([stalled, *ids])
            r = replies[stalled]
            assert r["error"] == "deadline_exceeded"
            assert r["partial"]["answered_hi"] >= 2
            for rid, x in zip(ids, (100, 12_345)):
                assert replies[rid]["value"] == o_pi(x)


def test_inline_ops_overtake_queued_work(ledger_dir, tmp_path):
    with _svc(ledger_dir, tmp_path, workers=1, cold_delay_s=0.5) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            ids = [cli.submit("pi", x=90_000 + 10_000 * i) for i in range(3)]
            h = cli.health()
            s = cli.stats()
            assert h["ok"] and "queue_depth" in h
            assert s["hot_admitted"] + s["cold_admitted"] >= 1
            assert cli.pending() == 3 and not cli._replies
            replies = cli.drain(ids)
            for i, rid in enumerate(ids):
                assert replies[rid]["value"] == o_pi(90_000 + 10_000 * i)


def test_inline_reply_never_lost_mid_direct_send(service):
    svc, _ = service
    with ServiceClient(svc.addr, timeout_s=5) as cli:
        for i in range(60):
            rid = cli.submit("pi", x=20_000 + (i % 7))
            assert cli.health()["ok"]
            assert cli.drain([rid])[rid]["value"] == o_pi(20_000 + (i % 7))


# --- one slow connection never blocks another -------------------------------


def test_svc_slow_frame_throttles_one_conn_not_the_fleet(ledger_dir, tmp_path,
                                                         memsink):
    with _svc(ledger_dir, tmp_path, workers=4) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as slow, \
                ServiceClient(svc.addr, timeout_s=30) as fast:
            fast.pi(100)
            svc.inject_chaos(f"svc_slow_frame:any@s{svc._seq + 1}:2")
            rid = slow.submit("pi", x=30_000)
            time.sleep(0.05)
            box = {}

            def dribbled():
                t0 = time.monotonic()
                box["value"] = slow.drain([rid])[rid]["value"]
                box["elapsed"] = time.monotonic() - t0

            t = threading.Thread(target=dribbled)
            t.start()
            lat = []
            while t.is_alive():
                q0 = time.monotonic()
                assert fast.pi(12_345) == o_pi(12_345)
                lat.append(time.monotonic() - q0)
            t.join(30)
            assert box["value"] == o_pi(30_000)
            assert box["elapsed"] >= 0.1
            assert len(lat) >= 3
            p95 = sorted(lat)[max(0, int(len(lat) * 0.95) - 1)]
            assert p95 < box["elapsed"] / 2
    ev = [x for x in memsink.records if x["event"] == "service_slow_frame"]
    assert ev and ev[0]["bytes_per_tick"] == 2.0
    for x in ev:
        validate_record(x)


def test_slowloris_reader_never_blocks_normal_clients(service):
    svc, cli = service
    frame = encode_msg({"type": "query", "id": 1, "op": "pi", "x": 30_000})
    host, port = svc.addr.split(":")
    loris = socket.create_connection((host, int(port)), timeout=30)
    try:
        done = threading.Event()

        def dribble():
            try:
                for i in range(len(frame)):
                    loris.sendall(frame[i:i + 1])
                    time.sleep(0.4 / len(frame))
            finally:
                done.set()

        t = threading.Thread(target=dribble)
        t.start()
        cli.pi(100)
        lat = []
        while not done.is_set():
            q0 = time.monotonic()
            assert cli.pi(12_345) == o_pi(12_345)
            lat.append(time.monotonic() - q0)
        t.join(30)
        assert len(lat) >= 5
        assert sorted(lat)[max(0, int(len(lat) * 0.95) - 1)] < 0.2
        reply = recv_msg(loris)
        assert reply["id"] == 1 and reply["value"] == o_pi(30_000)
    finally:
        loris.close()


def test_slow_consumer_overflowing_write_queue_is_killed(ledger_dir, tmp_path,
                                                         memsink):
    with _svc(ledger_dir, tmp_path, write_queue_bytes=4096) as svc:
        with ServiceClient(svc.addr, timeout_s=30, negotiate=False) as cli:
            with pytest.raises((ConnectionError, OSError)):
                cli.primes(2, 30_000)
        with ServiceClient(svc.addr, timeout_s=30) as cli2:
            assert cli2.stats()["slow_consumer_closed"] == 1
            assert cli2.pi(100) == o_pi(100)
    ev = [x for x in memsink.records if x["event"] == "service_slow_consumer"]
    assert ev and ev[0]["limit"] == 4096


# --- the batch op -------------------------------------------------------------


def test_batch_exact_vs_oracle_hot_and_cold(service):
    svc, cli = service
    covered = svc.index.covered_hi
    items = [
        {"op": "pi", "x": 0}, {"op": "pi", "x": 30_000},
        {"op": "pi", "x": covered - 1}, {"op": "pi", "x": 90_000},
        {"op": "is_prime", "x": 1}, {"op": "is_prime", "x": 2},
        {"op": "is_prime", "x": 12_347},
        {"op": "count", "lo": 10_000, "hi": 40_000},
        {"op": "count", "lo": 40_000, "hi": 90_000},
        {"op": "count", "lo": 7, "hi": 7},
    ]
    s0 = cli.stats()
    out = cli.query_batch(items)
    s1 = cli.stats()
    assert s1["batch_requests"] == s0["batch_requests"] + 1
    assert s1["batch_members"] == s0["batch_members"] + len(items)
    assert [o["value"] for o in out] == [
        0, o_pi(30_000), o_pi(covered - 1), o_pi(90_000), False, True,
        o_is_prime(12_347), o_count(10_000, 40_000), o_count(40_000, 90_000), 0]
    assert [o["op"] for o in out] == [i["op"] for i in items]


def test_batch_malformed_members_fault_individually(service):
    _svc, cli = service
    out = cli.query_batch([
        {"op": "pi", "x": 100}, {"op": "nth_prime", "k": 3},
        {"op": "count", "lo": 2, "hi": 100, "kind": "twins"},
        {"op": "is_prime"}, "not an object", {"op": "pi", "x": 200},
    ])
    assert out[0]["value"] == o_pi(100) and out[5]["value"] == o_pi(200)
    for k in (1, 2, 3, 4):
        assert out[k]["ok"] is False and out[k]["error"] == "bad_request"
    assert "nth_prime" in out[1]["detail"] and "kind=primes" in out[2]["detail"]


def test_batch_container_faults_are_whole_batch(ledger_dir, tmp_path):
    with _svc(ledger_dir, tmp_path, batch_queries=4) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.query("batch", items="nope")["error"] == "bad_request"
            assert cli.query("batch", items=[])["error"] == "bad_request"
            with pytest.raises(ServiceError) as ei:
                cli.query_batch([{"op": "pi", "x": x} for x in range(5)])
            assert ei.value.kind == "bad_request"
            assert "batch_queries=4" in ei.value.detail
            out = cli.query_batch([{"op": "pi", "x": x} for x in (10, 20, 30, 40)])
            assert [o["value"] for o in out] == [o_pi(x) for x in (10, 20, 30, 40)]


def test_batch_cold_member_faults_spare_hot_members(service):
    svc, cli = service
    svc.inject_chaos(f"backend_down:any@s{svc._seq + 1}:0.6")
    out = cli.query_batch([{"op": "pi", "x": 30_000}, {"op": "pi", "x": 90_000}])
    assert out[0]["ok"] and out[0]["value"] == o_pi(30_000)
    assert out[1]["ok"] is False and out[1]["error"] == "degraded"


def test_batch_deadline_member_carries_partial(ledger_dir, tmp_path):
    with _svc(ledger_dir, tmp_path, cold_delay_s=0.5) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            out = cli.query_batch([{"op": "pi", "x": 30_000},
                                   {"op": "pi", "x": 90_000}], deadline_s=0.2)
            assert out[0]["ok"] and out[0]["value"] == o_pi(30_000)
            assert out[1]["error"] == "deadline_exceeded"
            assert out[1]["partial"]["answered_hi"] >= 2


# --- v1 and v2, negotiation ------------------------------------------------------


def test_wire_negotiation_picks_highest_mutual(ledger_dir, tmp_path):
    with _svc(ledger_dir, tmp_path) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as v2, \
                ServiceClient(svc.addr, timeout_s=30, negotiate=False) as v1:
            assert v2.wire_v == 2 and not v2.downgraded
            assert v1.wire_v == 1
            assert svc.stats()["wire_v2_conns"] == 1
            for x in (2, 97, 30_000):
                assert v1.query("pi", x=x)["value"] == o_pi(x)
                assert v2.query("pi", x=x)["value"] == o_pi(x)


def test_wire_downgrade_is_logged_not_silent(ledger_dir, tmp_path, memsink):
    with _svc(ledger_dir, tmp_path, wire_v2=False) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.wire_v == 1 and cli.downgraded
            assert cli.query("pi", x=97)["value"] == o_pi(97)
            assert svc.stats()["wire_v2_conns"] == 0
    events = [r for r in memsink.records if r["event"] == "wire_downgrade"]
    assert len(events) == 1 and events[0]["negotiated"] == 1
    validate_record(events[0])


def test_dual_encoding_parity_primes_both_reprs(ledger_dir, tmp_path):
    with _svc(ledger_dir, tmp_path) as svc:
        with ServiceClient(svc.addr, timeout_s=30, negotiate=False) as v1, \
                ServiceClient(svc.addr, timeout_s=30) as v2:
            for lo, hi in ((0, 30), (17, 18), (40_000, 40_001), (2, 20_000),
                           (25_000, 50_000)):
                a = v1.query("primes", lo=lo, hi=hi)["value"]
                b = v2.query("primes", lo=lo, hi=hi)["value"]
                assert list(a) == list(b)
                assert list(a) == [int(p) for p in P if max(lo, 2) <= p < hi]


# --- mixed pairs: either client against either server --------------------------


_MIXED_OPS = [("pi", {"x": 30_000}), ("pi", {"x": 90_000}),
              ("count", {"lo": 40_000, "hi": 90_000}),
              ("count", {"lo": 2, "hi": 30_000, "kind": "twins"}),
              ("nth_prime", {"k": 6000}), ("is_prime", {"x": 49_999}),
              ("primes", {"lo": 2, "hi": 20_000}),
              ("primes", {"lo": 49_990, "hi": 50_050}),
              ("pi", {"x": "bad"})]
_MIXED_BATCH = [{"op": "pi", "x": 30_000}, {"op": "is_prime", "x": 12_347},
                {"op": "count", "lo": 100, "hi": 80_000},
                {"op": "count", "lo": 20_000, "hi": 100}, {"op": "nosuch"}]


def _drive(cli) -> list:
    out = [cli.query(op, **kw) for op, kw in _MIXED_OPS]
    out.append(cli.query_batch(_MIXED_BATCH))
    out.append(cli.health())
    return [plain(x) for x in out]


@pytest.mark.parametrize("negotiate", [False, True], ids=["v1", "v2"])
def test_mixed_pairs_both_ways(ledger_dir, port_backend, tmp_path, negotiate):
    """Each client against each server: four pairs, one answer."""
    with served_pair(tmp_path, ledger_dir, port_backend) as (ref, port):
        got = {}
        for cname, Client in (("ref", ref_service.ServiceClient),
                              ("port", ServiceClient)):
            for sname, svc in (("ref", ref), ("port", port)):
                with Client(svc.addr, timeout_s=30, negotiate=negotiate) as c:
                    assert c.wire_v == (2 if negotiate else 1)
                    assert not c.downgraded
                    got[cname, sname] = _drive(c)
        want = got["ref", "ref"]
        for pair, replies in got.items():
            # the second client on a server finds the cold chunks cached
            for r, w in zip(replies, want):
                if isinstance(r, dict):
                    r = {k: v for k, v in r.items() if k not in ("source", "id")}
                    w = {k: v for k, v in w.items() if k not in ("source", "id")}
                assert r == w, pair
        assert want[1]["value"] == o_pi(90_000)


# --- columnar batch replies: the same bytes -----------------------------------


def _raw_batch_reply(addr: str, members: list[dict]) -> bytes:
    """One v2 ``batch`` round trip on a raw socket; the reply frame's body."""
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(encode_msg({"type": "hello", "id": 0, "wire": [1, 2]}))
        assert recv_msg(s)["wire"] == 2
        cols, _ops = rpc.batch_items_to_cols(members)
        s.sendall(rpc.encode_msg_v2({"type": "query", "id": 1, "op": "batch"},
                                    cols))
        (length,) = struct.unpack(">Q", _recv_exact(s, 8))
        return _recv_exact(s, length)


def _recv_exact(s, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        assert chunk, "peer closed mid-frame"
        buf += chunk
    return buf


def _split_v2(body: bytes) -> tuple[dict, bytes]:
    assert body[0] == 0x02
    (hlen,) = struct.unpack("<I", body[1:5])
    return json.loads(body[5:5 + hlen]), body[5 + hlen:]


def test_columnar_batch_reply_bytes_equal_reference(ledger_dir, port_backend,
                                                    tmp_path):
    members = [{"op": "pi", "x": x} for x in (0, 2, 97, 30_000, 49_999, 90_000)]
    members += [{"op": "is_prime", "x": x} for x in (1, 2, 12_347, 49_999)]
    members += [{"op": "count", "lo": 100, "hi": 80_000},
                {"op": "count", "lo": 9, "hi": 4}, {"op": "pi", "x": -5}]
    with served_pair(tmp_path, ledger_dir, port_backend) as (ref, port):
        rh, rcols = _split_v2(_raw_batch_reply(ref.addr, members))
        ph, pcols = _split_v2(_raw_batch_reply(port.addr, members))
    assert pcols == rcols  # the column payloads, byte for byte
    assert {k: v for k, v in ph.items() if k not in WALL_CLOCK} == \
        {k: v for k, v in rh.items() if k not in WALL_CLOCK}
    assert ph["_cols"] and ph["op"] == "batch"
