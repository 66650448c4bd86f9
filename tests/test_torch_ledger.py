"""The port's checkpoint ledger and prepare pipeline against the
reference's.

  - a ledger written by ``sieve`` resumes under ``sieve_torch`` with the
    same pi, and the other way round, on the local run and on the rounds
    path; a run killed after round k resumes exactly;
  - the copied salvage, quarantine, mismatch and fsync behaviour, on the
    same damaged bytes in both packages;
  - PrepPipeline's order, residency bound and error propagation.
"""

import json
import threading
import time

import pytest

from sieve import checkpoint as ref_checkpoint
from sieve.config import SieveConfig as RefConfig
from sieve.coordinator import run_local as ref_run_local
from sieve.worker import SegmentResult as RefSegmentResult
from sieve_torch import checkpoint
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.interop import config_from_reference
from sieve_torch.parallel.mesh import run_mesh
from sieve_torch.parallel.pipeline import PrepPipeline
from sieve_torch.worker import SegmentResult
from tests.oracles import PI, TWINS

N = 10**5


def _die_after(monkeypatch, ledger_cls, k):
    """Make ledger_cls.record raise after k recorded segments."""
    real = ledger_cls.record
    calls = {"n": 0}

    def dying(self, res):
        calls["n"] += 1
        if calls["n"] > k:
            raise RuntimeError("simulated mid-run death")
        return real(self, res)

    monkeypatch.setattr(ledger_cls, "record", dying)
    return lambda: monkeypatch.setattr(ledger_cls, "record", real)


def _count_records(monkeypatch, ledger_cls):
    real = ledger_cls.record
    seen = []

    def counting(self, res):
        seen.append(res.seg_id)
        return real(self, res)

    monkeypatch.setattr(ledger_cls, "record", counting)
    return seen


def _ledger(path):
    return json.loads((path / checkpoint.LEDGER_NAME).read_text())


def test_reference_ledger_resumes_under_port(tmp_path, monkeypatch):
    """(f) sieve writes 3 of 8 segments and dies; sieve_torch resumes."""
    kw = dict(n=N, n_segments=8, twins=True, quiet=True, checkpoint_dir=str(tmp_path))
    restore = _die_after(monkeypatch, ref_checkpoint.Ledger, 3)
    with pytest.raises(RuntimeError, match="simulated"):
        ref_run_local(RefConfig(backend="cpu-numpy", **kw))
    restore()
    assert len(_ledger(tmp_path)["completed"]) == 3
    ref_cfg = RefConfig(backend="tpu-pallas", resume=True, **kw)
    port_cfg = config_from_reference(ref_cfg.to_dict(), device="cpu")
    assert port_cfg.checkpoint_dir == str(tmp_path) and port_cfg.resume
    seen = _count_records(monkeypatch, checkpoint.Ledger)
    res = run_local(port_cfg)
    assert (res.pi, res.twin_pairs) == (PI[N], TWINS[N])
    assert sorted(seen) == [3, 4, 5, 6, 7]
    assert len(_ledger(tmp_path)["completed"]) == 8


def test_port_ledger_resumes_under_reference(tmp_path, monkeypatch):
    """(f) sieve_torch writes 5 of 8 segments and dies; sieve resumes,
    and reads the port's checksummed file as its own."""
    kw = dict(n=N, n_segments=8, count_kind="cousins", packing="wheel30",
              quiet=True, checkpoint_dir=str(tmp_path))
    restore = _die_after(monkeypatch, checkpoint.Ledger, 5)
    with pytest.raises(RuntimeError, match="simulated"):
        run_local(SieveConfig(backend="cuda", device="cpu", **kw))
    restore()
    ref = ref_checkpoint.Ledger.open(RefConfig(**kw))
    assert sorted(ref.completed()) == [0, 1, 2, 3, 4]
    seen = _count_records(monkeypatch, ref_checkpoint.Ledger)
    res = ref_run_local(RefConfig(backend="cpu-numpy", resume=True, **kw))
    want = ref_run_local(RefConfig(backend="cpu-numpy",
                                   **{**kw, "checkpoint_dir": None}))
    assert (res.pi, res.twin_pairs) == (want.pi, want.twin_pairs)
    assert sorted(seen) == [5, 6, 7]


def test_reference_local_ledger_resumes_port_rounds(tmp_path, monkeypatch):
    """(f) The rounds path keys its ledger on workers*rounds segments: a
    reference local run over 8 segments resumes as 4 workers x 2 rounds;
    round 0 is restored whole and only round 1 is prepared."""
    kw = dict(n=N, twins=True, quiet=True, checkpoint_dir=str(tmp_path))
    restore = _die_after(monkeypatch, ref_checkpoint.Ledger, 4)
    with pytest.raises(RuntimeError, match="simulated"):
        ref_run_local(RefConfig(backend="cpu-numpy", n_segments=8, **kw))
    restore()
    res = run_mesh(SieveConfig(device="cpu", workers=4, rounds=2, resume=True, **kw))
    assert (res.pi, res.twin_pairs) == (PI[N], TWINS[N])
    assert res.host_phases["rounds_prepared"] == 1


def test_config_hash_mismatch_refuses(tmp_path):
    run_local(SieveConfig(n=N, device="cpu", n_segments=4, checkpoint_dir=str(tmp_path)))
    with pytest.raises(checkpoint.LedgerMismatch, match="config_hash"):
        run_local(SieveConfig(n=N, device="cpu", n_segments=4, packing="wheel30",
                              checkpoint_dir=str(tmp_path), resume=True))
    # the rounds path refuses a ledger of another plan (8 segments vs 4)
    with pytest.raises(checkpoint.LedgerMismatch):
        run_mesh(SieveConfig(n=N, device="cpu", workers=4, rounds=2,
                             checkpoint_dir=str(tmp_path), resume=True))


@pytest.mark.parametrize("packing", ["odds", "wheel30"])
@pytest.mark.parametrize("fused", ["1", "0"])
def test_mesh_kill_midrun_resume_exact(tmp_path, monkeypatch, packing, fused):
    """(f) The port of the reference's kill-mid-run test: the run dies in
    round 1; the resumed run prepares fewer rounds than the plan but at
    least the killed ones, and is exact."""
    monkeypatch.setenv("SIEVE_ROUND_WINDOW", "1")
    monkeypatch.setenv("SIEVE_PALLAS_FUSED", fused)
    cfg = SieveConfig(n=N, workers=4, rounds=4, device="cpu", twins=True,
                      quiet=True, checkpoint_dir=str(tmp_path), packing=packing)
    restore = _die_after(monkeypatch, checkpoint.Ledger, 6)
    with pytest.raises(RuntimeError, match="simulated"):
        run_mesh(cfg)
    restore()
    res = run_mesh(SieveConfig(**{**cfg.to_dict(), "resume": True}))
    assert (res.pi, res.twin_pairs) == (PI[N], TWINS[N])
    assert 0 < res.host_phases["rounds_prepared"] < 4
    assert res.host_phases["reduction_mode"] == ("fused" if fused == "1" else "split")
    # a full resume prepares nothing
    res = run_mesh(SieveConfig(**{**cfg.to_dict(), "resume": True}))
    assert res.pi == PI[N] and res.host_phases["rounds_prepared"] == 0


def _both_open(tmp_path, text, port_kw):
    """Open the same bytes with both packages' Ledger; returns the two
    outcomes (ledger or exception type) and the quarantined files."""
    out = []
    for pkg, cfg in ((ref_checkpoint, RefConfig(**port_kw)),
                     (checkpoint, SieveConfig(**port_kw))):
        d = tmp_path / pkg.__name__
        d.mkdir()
        (d / checkpoint.LEDGER_NAME).write_text(text)
        try:
            led = pkg.Ledger.open(type(cfg)(**{**cfg.to_dict(), "checkpoint_dir": str(d)}))
            out.append((led.salvaged, sorted(led.completed()),
                        json.loads((d / checkpoint.LEDGER_NAME).read_text())["completed"]))
        except pkg.LedgerCorrupt:
            out.append("corrupt")
        out.append(sorted(p.name for p in d.iterdir()))
    return out


@pytest.mark.parametrize("damage", ["truncated", "checksum", "foreign_hash"])
def test_corrupt_ledger_handled_as_reference(tmp_path, damage):
    kw = dict(n=N, n_segments=4, twins=True, checkpoint_dir=str(tmp_path / "src"))
    run_local(SieveConfig(device="cpu", **kw))
    text = (tmp_path / "src" / checkpoint.LEDGER_NAME).read_text()
    if damage == "truncated":
        text = text[: int(len(text) * 0.7)]
    elif damage == "checksum":
        text = text.replace('"count": ', '"count": 1', 1)
    else:
        kw["packing"] = "plain"
        text = text[:-40]
    kw.pop("checkpoint_dir")
    ref, ref_files, got, got_files = _both_open(tmp_path, text, kw)
    assert got == ref and got_files == ref_files
    assert checkpoint.LEDGER_NAME + ".quarantined" in got_files
    if damage == "truncated":
        assert got[0] > 0  # salvaged entries, rewritten clean
    else:
        assert got == "corrupt"


def test_ledger_fsync_knob(tmp_path, monkeypatch):
    import os

    calls = []
    real = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (calls.append(fd), real(fd)))
    cfg = SieveConfig(n=N, device="cpu", n_segments=2, checkpoint_dir=str(tmp_path / "a"))
    run_local(cfg)
    assert len(calls) == 2 * 2  # file + directory per record
    calls.clear()
    monkeypatch.setenv("SIEVE_LEDGER_FSYNC", "0")
    run_local(SieveConfig(**{**cfg.to_dict(), "checkpoint_dir": str(tmp_path / "b")}))
    assert calls == []
    path = tmp_path / "b" / checkpoint.LEDGER_NAME
    assert checkpoint.ledger_fingerprint(path) == ref_checkpoint.ledger_fingerprint(path)
    assert checkpoint.ledger_fingerprint(tmp_path / "none") is None


def test_segment_result_round_trip_and_sanity():
    good = dict(seg_id=3, lo=10, hi=100, count=20, twin_count=4,
                first_word=5, last_word=7, nbits=45, elapsed_s=0.5)
    bad = [dict(good, lo=1), dict(good, count=200), dict(good, nbits=0),
           dict(good, first_word=-1), dict(good, elapsed_s=-1.0),
           dict(good, count=2.5)]
    for d in [good] + bad:
        got, want = SegmentResult.from_dict(d), RefSegmentResult.from_dict(d)
        assert got.to_dict() == want.to_dict()
        assert got.is_sane() == want.is_sane()
    assert SegmentResult.from_dict(good).is_sane()


# --- (g) PrepPipeline -----------------------------------------------------------


def test_prep_pipeline_orders_and_bounds_residency():
    rounds = list(range(12))
    done: list[int] = []
    lock = threading.Lock()

    def prep(state, rnd):
        time.sleep(0.002)
        with lock:
            done.append(rnd)
        return rnd * 10

    pipe = PrepPipeline(rounds, list, prep, window=2, threads=2)
    try:
        for rnd in rounds:
            assert pipe.take(rnd) == rnd * 10
    finally:
        pipe.close()
    assert pipe.stats["rounds_prepared"] == 12
    assert 1 <= pipe.stats["peak_resident"] <= 3  # window + 1
    assert sorted(done) == rounds
    assert len(pipe.states) == 2 and pipe.stats["prep_seconds"] > 0


def test_prep_pipeline_propagates_worker_errors():
    def prep(state, rnd):
        if rnd == 3:
            raise ValueError("boom")
        return rnd

    pipe = PrepPipeline(list(range(6)), list, prep, window=1, threads=2)
    try:
        with pytest.raises(ValueError, match="boom"):
            for rnd in range(6):
                pipe.take(rnd)
    finally:
        pipe.close()


def test_prep_pipeline_threads_knob(monkeypatch):
    monkeypatch.setenv("SIEVE_PREP_THREADS", "1")
    pipe = PrepPipeline(list(range(4)), list, lambda s, r: r, window=3)
    try:
        assert [pipe.take(r) for r in range(4)] == [0, 1, 2, 3]
    finally:
        pipe.close()
    assert len(pipe.states) == 1
    empty = PrepPipeline([], list, lambda s, r: r, window=2)
    empty.close()
    assert empty.stats["rounds_prepared"] == 0 and empty.states == []


def test_prep_pipeline_stress_many_threads():
    """More producer threads than cores, with a short switch interval: every
    round is prepared exactly once, handed back in order, and residency
    never passes window + 1."""
    import sys

    rounds = list(range(400))
    calls: dict[int, int] = {}
    lock = threading.Lock()

    def prep(state, rnd):
        with lock:
            calls[rnd] = calls.get(rnd, 0) + 1
        state.append(rnd)
        return -rnd

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = PrepPipeline(rounds, list, prep, window=19, threads=20)
        got = []
        try:
            for rnd in rounds:
                got.append(pipe.take(rnd))
        finally:
            pipe.close()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pipe._threads)
    assert got == [-r for r in rounds]
    assert calls == {r: 1 for r in rounds}
    assert len(pipe.states) == 20
    assert sorted(r for st in pipe.states for r in st) == rounds
    assert pipe.stats["rounds_prepared"] == 400
    assert pipe.stats["peak_resident"] <= 20
