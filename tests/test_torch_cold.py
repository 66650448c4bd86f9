"""The port's batched cold plane against the reference's (the service half
of tests/test_batch.py and of tests/test_mesh_cold.py).

A concurrent cold burst costs at most one dispatch per distinct grid
chunk; ``svc_batch_partial`` degrades one chunk of a batch while the rest
answer exact, with the reference's typed error; ``--persist-cold`` writes
ledger rows equal to the reference's (every field but the wall-clock
``elapsed_s``), keeps the never-shrink guard, and a restart answers from
the index; the cold cache is an LRU. ``cold_backend="mesh"`` runs
:class:`~sieve_torch.backends.mesh_backend.MeshWorker` over CPU shards
(``SIEVE_MESH_COLD_DEVICES``): a burst costs one mesh launch per shape
group and drain, replies equal the loop backend's, ``svc_mesh_fail``
falls back typed to the loop worker with exact answers, and a mesh that
cannot start (no card) degrades once to ``loop (mesh failed)``.
``--persist-cold`` boundary entries answer a restarted server from the
segment store. The cold plane pins a bare ``cuda`` device to the card
the server was built on.
"""

import dataclasses
import shutil
import threading
import time

import pytest

import sieve.service.server as ref_server
from sieve.checkpoint import Ledger as RefLedger
from sieve.config import SieveConfig as RefConfig
from sieve_torch.chaos import ANY_WORKER, parse_chaos
from sieve_torch.checkpoint import COLD_SEG_BASE, Ledger
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.metrics import validate_record
from sieve_torch.service import ServiceClient, ServiceSettings, SieveService
from sieve_torch.service.server import ColdBackend, Degraded, _Flight, _pin_device
from tests.test_torch_service import (  # noqa: F401 — fixtures
    _copy,
    cfg_kw,
    ledger_dir,
    memsink,
    o_count,
    o_pi,
    port_backend,
    port_service,
    served_pair,
    settings_kw,
)


def _rows(completed: dict) -> dict:
    """Ledger rows without the wall-clock ``elapsed_s``."""
    out = {}
    for sid, r in completed.items():
        d = dataclasses.asdict(r)
        d.pop("elapsed_s")
        out[sid] = d
    return out


# --- burst batching -------------------------------------------------------------


def test_cold_burst_batches_to_distinct_chunks(ledger_dir, port_backend,
                                               tmp_path):
    # covered_hi is 50_001 and the grid cuts at 65_536: the two targets
    # need 3 distinct chunks, (50001, 65536) shared
    targets = [90_000, 120_000] * 6
    with port_service(_copy(ledger_dir, tmp_path / "p"), port_backend,
                      workers=8, queue_limit=32, cold_delay_s=0.25) as svc:
        got, errs = [], []

        def q(x):
            try:
                with ServiceClient(svc.addr, timeout_s=30) as c:
                    got.append((x, c.pi(x)))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=q, args=(x,)) for x in targets]
        threads[0].start()
        time.sleep(0.05)
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs
        assert sorted(got) == sorted((x, o_pi(x)) for x in targets)
        s = svc.stats()
        assert 1 <= s["cold_dispatches"] <= 3
        assert s["cold_batched_chunks"] <= 3 and s["cold_computes"] <= 3


def test_parse_svc_batch_partial():
    d = parse_chaos("svc_batch_partial:any@s2:1")[0]
    assert (d.kind, d.worker, d.seg_id, d.param) == (
        "svc_batch_partial", ANY_WORKER, 2, 1.0)
    assert parse_chaos("svc_batch_partial:any@s1")[0].param == 0.0


def test_svc_batch_partial_degrades_one_chunk_as_reference(
        ledger_dir, port_backend, tmp_path, memsink):
    k0, k1 = (50_001, 65_536), (65_536, 90_001)
    with served_pair(tmp_path, ledger_dir, port_backend) as (ref, port):
        outcomes = []
        for svc, flight in ((ref, ref_server._Flight), (port, _Flight)):
            with svc._cold_lock:
                f0 = svc._inflight[k0] = flight()
                f1 = svc._inflight[k1] = flight()
            svc.inject_chaos(f"svc_batch_partial:any@s{svc.batcher.batches + 1}:0")
            svc.batcher._dispatch([k0, k1])
            assert f0.event.is_set() and f1.event.is_set()
            res = dataclasses.asdict(f1.result)
            res.pop("elapsed_s")
            outcomes.append((type(f0.error).__name__, str(f0.error),
                             f1.error, res))
        assert outcomes[1] == outcomes[0]
        assert outcomes[1][0] == "Degraded"
        assert "svc_batch_partial" in outcomes[1][1]
        assert outcomes[1][3]["count"] == o_count(65_536, 90_001)
        assert outcomes[1][3]["seg_id"] == COLD_SEG_BASE + 65_536
    ev = [x for x in memsink.records if x["event"] == "service_batched"]
    assert len(ev) == 1 and ev[0]["failed"] == 1 and ev[0]["chunks"] == 1
    validate_record(ev[0])


def test_svc_batch_partial_over_the_wire(ledger_dir, port_backend, tmp_path):
    with port_service(_copy(ledger_dir, tmp_path / "p"), port_backend) as svc:
        svc.inject_chaos(f"svc_batch_partial:any@s{svc.batcher.batches + 1}:1")
        with ServiceClient(svc.addr, timeout_s=30) as c:
            r = c.query("pi", x=90_000)  # chunk 1 of (head, tail) fails
            assert r["error"] == "degraded" and "svc_batch_partial" in r["detail"]
            assert c.pi(60_000) == o_pi(60_000)  # the head chunk survived
            assert c.pi(90_000) == o_pi(90_000)  # one-shot: the tail heals


# --- --persist-cold write-back --------------------------------------------------


def test_persist_cold_ledger_rows_equal_reference(ledger_dir, port_backend,
                                                  tmp_path):
    from sieve.service import ServiceClient as RefClient

    persisted = []
    with served_pair(tmp_path, ledger_dir, port_backend,
                     persist_cold=True) as (ref, port):
        for svc, Client in ((ref, RefClient), (port, ServiceClient)):
            with Client(svc.addr, timeout_s=30) as c:
                assert c.pi(90_000) == o_pi(90_000)
                assert c.stats()["cold_persisted"] == 2
                assert c.pi(60_000) == o_pi(60_000)  # clipped: never shrinks
                assert c.stats()["cold_persisted"] == 2
                assert c.count(100_000, 140_000) == o_count(100_000, 140_000)
                persisted.append(c.stats()["cold_persisted"])
    assert persisted[1] == persisted[0] > 2
    got = _rows(Ledger.open_readonly(SieveConfig(
        **cfg_kw(str(tmp_path / "port")))).completed())
    want = _rows(RefLedger.open_readonly(RefConfig(
        **cfg_kw(str(tmp_path / "ref")))).completed())
    assert got == want
    assert len(got) > 4 + 2  # the four segments and the cold chunks
    led = Ledger.open_readonly(SieveConfig(**cfg_kw(str(tmp_path / "port"))))
    assert led.recorded_hi(COLD_SEG_BASE + 50_001) == 65_536
    # the grid chunk (65536, 131072) grew over the clipped (65536, 90001)
    assert led.recorded_hi(COLD_SEG_BASE + 65_536) == 131_072


def test_persist_cold_write_back_and_restart(tmp_path, port_backend):
    ck = str(tmp_path / "ck")
    run_local(SieveConfig(**cfg_kw(ck, backend="cpu-numpy")))
    with port_service(ck, port_backend, persist_cold=True) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.stats()["persist_cold"] is True
            assert cli.pi(90_000) == o_pi(90_000)
            assert cli.stats()["cold_persisted"] == 2
            assert cli.pi(60_000) == o_pi(60_000)
            assert cli.stats()["cold_persisted"] == 2
    with port_service(ck, port_backend) as svc2:
        with ServiceClient(svc2.addr, timeout_s=30) as cli:
            assert cli.pi(90_000) == o_pi(90_000)
            s = cli.stats()
            assert s["covered_hi"] >= 90_001
            assert s["cold_computes"] == 0 and s["cold_dispatches"] == 0
            assert s["persist_cold"] is False


def test_cold_cache_lru_eviction(ledger_dir, tmp_path):
    with port_service(_copy(ledger_dir, tmp_path / "p"), ("cuda", "cpu"),
                      cold_chunk=1 << 14, cold_cache_entries=2) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.pi(90_000) == o_pi(90_000)
            s1 = cli.stats()
            assert list(svc._cold_cache) == [(65_536, 81_920), (81_920, 90_001)]
            assert cli.pi(90_000) == o_pi(90_000)
            s2 = cli.stats()
            assert s2["cold_cache_hits"] - s1["cold_cache_hits"] == 2
            assert s2["cold_computes"] - s1["cold_computes"] == 1
            assert list(svc._cold_cache) == [(81_920, 90_001), (50_001, 65_536)]


# --- the mesh cold plane over CPU shards -------------------------------------------


@pytest.fixture
def mesh4(monkeypatch):
    monkeypatch.setenv("SIEVE_MESH_COLD_DEVICES", "4")


def _mesh_service(ledger_dir, tmp_path, **kw):
    return port_service(_copy(ledger_dir, tmp_path / "m"), ("cuda", "cpu"),
                        **{"cold_backend": "mesh", **kw})


def test_mesh_cold_burst_one_round_per_drain(ledger_dir, tmp_path, mesh4,
                                             memsink):
    targets = [90_000, 120_000] * 10
    with _mesh_service(ledger_dir, tmp_path, workers=8,
                       cold_delay_s=0.25) as svc:
        got, errs = [], []

        def q(x):
            try:
                with ServiceClient(svc.addr, timeout_s=30) as c:
                    got.append((x, c.pi(x)))
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(e)

        threads = [threading.Thread(target=q, args=(x,)) for x in targets]
        threads[0].start()
        time.sleep(0.05)
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(60)
        assert not errs
        assert sorted(got) == sorted((x, o_pi(x)) for x in targets)
        with ServiceClient(svc.addr) as cli:
            s, h = cli.stats(), cli.health()
        assert 1 <= s["cold_dispatches"] <= 3
        assert s["mesh_fallbacks"] == 0
        assert 1 <= s["mesh_launches"] <= 2 * s["cold_dispatches"]
        for out in (s, h):
            assert out["cold_backend"] == "mesh"
            assert out["mesh_devices"] == 4
            assert out["mesh_fanout"] >= 1
        assert svc.cold._mesh_worker.launches >= s["mesh_launches"]
    ev = [x for x in memsink.records if x["event"] == "service_mesh_dispatch"]
    assert ev and all(x["devices"] == 4 for x in ev)
    for x in ev:
        validate_record(x)


def test_mesh_replies_equal_loop_backend(ledger_dir, tmp_path, mesh4):
    queries = [(50_001, 90_000), (65_000, 120_001), (2, 118_000)]
    answers = {}
    for backend in ("mesh", "loop"):
        with port_service(_copy(ledger_dir, tmp_path / backend),
                          ("cuda", "cpu"), cold_backend=backend) as svc:
            with ServiceClient(svc.addr, timeout_s=30) as c:
                answers[backend] = [c.count(lo, hi) for lo, hi in queries]
            st = svc.stats()
            assert st["cold_backend"] == backend and st["cold_dispatches"] >= 1
    assert answers["mesh"] == answers["loop"] == [o_count(lo, hi)
                                                   for lo, hi in queries]


def test_parse_svc_mesh_fail():
    d = parse_chaos("svc_mesh_fail:any@s2")[0]
    assert (d.kind, d.worker, d.seg_id) == ("svc_mesh_fail", ANY_WORKER, 2)


def test_svc_mesh_fail_degrades_to_exact_loop(ledger_dir, tmp_path, mesh4,
                                              memsink):
    with _mesh_service(ledger_dir, tmp_path) as svc:
        svc.inject_chaos("svc_mesh_fail:any@s1")
        with ServiceClient(svc.addr, timeout_s=30) as c:
            assert c.pi(90_000) == o_pi(90_000)    # through the fallback
            assert c.pi(120_000) == o_pi(120_000)  # the mesh again
        s = svc.stats()
        assert s["mesh_fallbacks"] == 1 and s["mesh_launches"] >= 1
        assert s["cold_backend"] == "mesh"
        assert s["degraded_replies"] == 0 and s["internal_errors"] == 0
    ev = [x for x in memsink.records if x["event"] == "service_mesh_fallback"]
    assert len(ev) == 1 and "svc_mesh_fail" in ev[0]["reason"]
    validate_record(ev[0])


def test_mesh_init_failure_degrades_once(ledger_dir, tmp_path, memsink,
                                         monkeypatch):
    """A mesh asked of a card that is not there: one typed fallback, then
    the loop worker answers for good."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with port_service(_copy(ledger_dir, tmp_path / "m"), ("cpu-numpy", "cuda"),
                      cold_backend="mesh") as svc:
        with ServiceClient(svc.addr, timeout_s=30) as c:
            assert c.pi(90_000) == o_pi(90_000)
            assert c.pi(120_000) == o_pi(120_000)
        s = svc.stats()
        assert s["mesh_launches"] == 0 and s["mesh_fallbacks"] == 1
        assert s["cold_backend"] == "loop (mesh failed)"
        assert s["mesh_devices"] == 0
    ev = [x for x in memsink.records if x["event"] == "service_mesh_fallback"]
    assert len(ev) == 1 and "init" in ev[0]["reason"]
    assert "no CUDA device" in ev[0]["reason"]


def test_cold_backend_setting_validated():
    with pytest.raises(ValueError, match="cold_backend"):
        ServiceSettings(cold_backend="gpu").validate()
    assert ServiceSettings.from_env().cold_backend == "loop"


def test_persist_cold_store_restart_hot(tmp_path):
    dir_a = tmp_path / "a"
    run_local(SieveConfig(**cfg_kw(str(dir_a), backend="cpu-numpy")))
    dir_b = tmp_path / "b"
    shutil.copytree(dir_a, dir_b)
    queries = [(50_001, 90_000), (2, 120_000)]
    with port_service(str(dir_a), ("cuda", "cpu"), persist_cold=True) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as c:
            first = [c.count(lo, hi) for lo, hi in queries]
        assert svc.stats()["cold_persisted"] >= 1
    assert first == [o_count(lo, hi) for lo, hi in queries]
    shutil.copytree(dir_a / "store", dir_b / "store")
    with port_service(str(dir_b), ("cuda", "cpu"), persist_cold=True) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as c:
            again = [c.count(lo, hi) for lo, hi in queries]
        s = svc.stats()
    assert again == first
    assert s["cold_store_hits"] >= 1 and s["cold_computes"] == 0


# --- device placement of the cold plane -----------------------------------------


def test_pin_device_names_the_constructing_threads_card(monkeypatch):
    import torch

    cpu = SieveConfig(n=100, backend="cuda", device="cpu")
    assert _pin_device(cpu) is cpu
    bare = SieveConfig(n=100, backend="cuda", device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _pin_device(bare) is bare  # no card: the worker raises later
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert _pin_device(bare).device == "cuda:3"
    indexed = SieveConfig(n=100, backend="torch", device="cuda:1")
    assert _pin_device(indexed) is indexed
    # the config hash (the ledger key) does not see the device
    assert _pin_device(bare).config_hash() == bare.config_hash()
    cold = ColdBackend(bare, ServiceSettings())
    assert cold.config.device == "cuda:3"
