"""The recorders on the port's server: the server halves of
tests/test_debug.py (from :305) and tests/test_profile.py (from :333).

``svc_crash`` kills a worker thread for real (``ChaosCrash`` escapes the
handler's nets), the flight recorder freezes a crash bundle under
``debug_dir`` and the surviving workers answer exactly; the ``debug`` op
answers inline and an SLO burn freezes a bundle, and with the recorder
off the op answers null; the ``profile`` op answers the sampler's
snapshot, null with the sampler off, and ``svc_prof_gap`` drops the K-th
pull and heals; the ``exemplars`` op keeps a typed-error request. The
router's halves belong to the fabric and are not here.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from sieve.seed import seed_primes
from sieve_torch.chaos import ChaosCrash, parse_chaos
from sieve_torch.checkpoint import Ledger
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.debug import BUNDLE_VERSION
from sieve_torch.profile import PROFILE_VERSION
from sieve_torch.service import ServiceClient, ServiceSettings, SieveService
from sieve_torch.service.client import CallTimeout
from tests.test_torch_service import memsink  # noqa: F401 — fixture

N = 50_000
P = seed_primes(200_000)


def o_pi(x):
    return int(np.searchsorted(P, x, side="right"))


def o_count(lo, hi):
    return int(np.searchsorted(P, hi, side="left")
               - np.searchsorted(P, lo, side="left"))


def _cfg(checkpoint_dir, **kw):
    base = dict(n=N, backend="cuda", device="cpu", packing="wheel30",
                n_segments=4, quiet=True, checkpoint_dir=checkpoint_dir)
    base.update(kw)
    return SieveConfig(**base)


def _settings(**kw):
    base = dict(workers=2, queue_limit=16, default_deadline_s=10.0,
                cold_chunk=1 << 16, breaker_cooldown_s=0.4, refresh_s=0.0,
                metrics_sample_s=0.0)
    base.update(kw)
    return ServiceSettings(**base)


@pytest.fixture(scope="module")
def src_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("rec_ledger")
    run_local(_cfg(str(path), backend="cpu-numpy"))
    return path


def _shard0(src_dir, tmp_path) -> str:
    """A ledger of the first two segments: a server over it has cold work."""
    segs = sorted(Ledger.open_readonly(_cfg(str(src_dir))).completed().values(),
                  key=lambda r: r.lo)
    d = tmp_path / "shard0"
    led = Ledger.open(_cfg(str(d)))
    for r in segs[:2]:
        led.record(r)
    return str(d)


def _wait(cond, timeout_s=5.0, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# --- svc_crash ------------------------------------------------------------------


def test_chaos_grammar_svc_crash():
    d = parse_chaos("svc_crash:any@s3")
    assert len(d) == 1 and d[0].kind == "svc_crash"
    assert d[0].seg_id == 3 and d[0].param is None
    with pytest.raises(ValueError, match="takes no param"):
        parse_chaos("svc_crash:any@s3:2")
    assert issubclass(ChaosCrash, RuntimeError)


def test_svc_crash_kills_worker_and_fires_crash_bundle(src_dir, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    d0 = _shard0(src_dir, tmp_path)
    dbg = tmp_path / "dbg"
    with SieveService(_cfg(d0, chaos="svc_crash:any@s1"),
                      _settings(debug_dir=str(dbg))) as svc, \
            ServiceClient(svc.addr, timeout_s=2) as cli:
        with pytest.raises((CallTimeout, ConnectionError)):
            cli.pi(1000)
        _wait(lambda: svc.recorder.last_bundle is not None, what="crash bundle")
        b = svc.recorder.last_bundle
        assert b["trigger"] == "crash"
        assert "ChaosCrash" in b["detail"]["error"]
        dirs = list(dbg.glob("bundle-crash-*"))
        assert len(dirs) == 1
        with open(dirs[0] / "bundle.json") as f:
            doc = json.load(f)
        assert doc["bundle"] == BUNDLE_VERSION and doc["role"] == "service"
        with ServiceClient(svc.addr, timeout_s=10) as cli2:
            assert cli2.pi(1000) == o_pi(1000)
            assert cli2.count(100, 5000) == o_count(100, 5000)


# --- the debug op ---------------------------------------------------------------------


def test_debug_op_on_server_inline_and_slo_burn_bundle(src_dir, tmp_path):
    d0 = _shard0(src_dir, tmp_path)
    dbg = tmp_path / "dbg"
    with SieveService(_cfg(d0), _settings(slo_ms={"pi": 0.0001}, slo_window=8,
                                          debug_dir=str(dbg),
                                          metrics_sample_s=0.02)) as svc, \
            ServiceClient(svc.addr, timeout_s=10) as cli:
        assert cli.pi(1000) == o_pi(1000)
        _wait(lambda: list(dbg.glob("bundle-slo_burn-*")), what="slo_burn bundle")
        _wait(lambda: svc.history.samples >= 2, what="history samples")
        b = cli.debug()
        assert b["bundle"] == BUNDLE_VERSION and b["role"] == "service"
        assert b["trigger"] == "manual"
        assert b["recorder"]["bundles"] >= 1
        assert b["history"]
        assert any(e.get("event") == "service_slo_burn" for e in b["events"])
        assert any(e.get("event") == "service_slo_burn" for e in b["errors"])
    with SieveService(_cfg(d0), _settings(recorder=False)) as svc2, \
            ServiceClient(svc2.addr, timeout_s=10) as cli2:
        assert svc2.recorder is None
        assert cli2.debug() is None
        assert cli2.pi(1000) == o_pi(1000)


def test_breaker_open_freezes_a_bundle(src_dir, tmp_path):
    d0 = _shard0(src_dir, tmp_path)
    dbg = tmp_path / "dbg"
    with SieveService(_cfg(d0), _settings(debug_dir=str(dbg),
                                          debug_cooldown_s=0.0)) as svc, \
            ServiceClient(svc.addr, timeout_s=10) as cli:
        svc.inject_chaos(f"backend_down:any@s{svc._seq + 1}:0.3")
        assert cli.query("pi", x=40_000)["error"] == "degraded"
        _wait(lambda: list(dbg.glob("bundle-breaker_open-*")),
              what="breaker_open bundle")
        assert cli.pi(1000) == o_pi(1000)


# --- the profile op -------------------------------------------------------------------


def test_profile_wire_op_on_the_server(src_dir, memsink):
    with SieveService(_cfg(str(src_dir)), _settings(prof_hz=101.0)) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            cli.query("pi", x=1000)
            doc = cli.profile()
            assert doc["profile"] == PROFILE_VERSION
            assert doc["role"] == "service"
            assert doc["hz"] == 101.0
            assert doc["pid"] == os.getpid()
            st = cli.stats()
            assert st["profile_pulls"] == 1 and st["profile_gaps"] == 0
    kinds = [r["event"] for r in memsink.records if "event" in r]
    assert "profile_pulled" in kinds


def test_profile_disabled_service_returns_none_profile(src_dir):
    with SieveService(_cfg(str(src_dir)), _settings(prof_hz=0.0)) as svc:
        assert svc.profiler is None
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.profile() is None
            assert cli.stats()["profile_pulls"] == 1


def test_settings_validate_profiler_knobs():
    with pytest.raises(ValueError):
        ServiceSettings(prof_hz=-1.0).validate()
    with pytest.raises(ValueError):
        ServiceSettings(prof_stacks=0).validate()


def test_svc_prof_gap_drops_kth_reply_pauses_and_heals(src_dir):
    with SieveService(_cfg(str(src_dir)), _settings(wire_chaos=True)) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            assert cli.profile() is not None  # pull 1
            cli.inject_chaos("svc_prof_gap:any@s2")
            with ServiceClient(svc.addr, timeout_s=1.5) as short:
                with pytest.raises(CallTimeout):
                    short.profile()  # pull 2: the reply is dropped
            assert cli.profile() is not None  # pull 3 heals
            st = cli.stats()
            assert st["profile_gaps"] == 1 and st["profile_pulls"] == 2
        assert svc.profiler.stats()["pauses"] == 1


# --- the exemplars op -----------------------------------------------------------------


def test_exemplars_op_keeps_typed_errors(src_dir, tmp_path):
    dbg = tmp_path / "dbg"
    with SieveService(_cfg(str(src_dir)), _settings(debug_dir=str(dbg))) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as cli:
            for x in range(150):
                cli.pi(100 + x)
            assert cli.query("pi", x="bad")["error"] == "bad_request"
            kept = cli.exemplars(n=50)
            reasons = {e["reason"] for e in kept}
            assert "error" in reasons and "baseline" in reasons
            err = next(e for e in kept if e["reason"] == "error")
            assert err["outcome"] == "bad_request"
            st = cli.stats()
            assert st["exemplars_seen"] >= 151 and st["exemplars_kept"] >= 2
        svc.exemplar.flush()
    lines = (dbg / "exemplars.jsonl").read_text().splitlines()
    assert any(json.loads(ln)["reason"] == "error" for ln in lines)
