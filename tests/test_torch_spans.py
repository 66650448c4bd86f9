"""The spans inside a segment, on the CPU (the kernels' plain versions).

A local run on the cuda backend and on the torch backend, with capture
on, records each span where its work happens and inside the span that
encloses that work; the prepare phases' spans are what ``phase_seconds``
and ``host_phases`` read; the word kernel's device spans cost nothing
with capture off and land on a track of their own; ``--profile-dir``
mirrors the spans into the operator's profile.
"""

import contextlib
import io
import json
import threading
import types

import pytest
import torch

from benchmark import harness
from sieve_torch import cli, trace
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.parallel.mesh import run_mesh

TOP = ("run.seed", "run.plan", "run.worker", "segment.process", "segment.record",
       "run.merge", "run.summary")
# child -> the span that encloses it, per backend
PARENT = {
    "cuda": {
        "segment.prepare": "segment.process", "segment.device": "segment.process",
        "segment.result": "segment.process",
        "prepare.chain": "segment.prepare", "prepare.residue": "segment.prepare",
        "prepare.group": "segment.prepare", "prepare.flat": "segment.prepare",
        "prepare.corrections": "segment.prepare",
        "fused.stage": "segment.device", "fused.copy": "segment.device",
        "fused.launch": "segment.device", "fused.fetch": "segment.device",
    },
    "torch": {
        "segment.prepare": "segment.process", "segment.device": "segment.process",
        "segment.result": "segment.process",
        "prepare.chain": "segment.prepare", "prepare.residue": "segment.prepare",
        "prepare.group": "segment.prepare",
        "prepare.corrections": "segment.prepare",
        "words.fetch": "segment.device",
    },
}
WORDS = ("words.tier1", "words.tier2", "words.tail")
SEGMENTS = 4


@contextlib.contextmanager
def _captured():
    tr = trace.get_tracer()
    tr.enable()
    try:
        yield tr
    finally:
        tr.disable()


def _run(backend: str):
    """A captured local run: (result, its span totals, its X events)."""
    snap = trace.snapshot()
    with _captured() as tr:
        res = run_local(SieveConfig(n=10**6, backend=backend, device="cpu",
                                    twins=True, n_segments=SEGMENTS, quiet=True))
        events = [e for e in tr.events() if e.get("ph") == "X"]
    assert (res.pi, res.twin_pairs) == (78_498, 8_169)
    return res, trace.since(snap), events


def _inside(child: dict, parent: dict) -> bool:
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-3)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_local_run_records_every_span_nested(backend):
    _, agg, events = _run(backend)
    main = threading.main_thread().ident
    host = [e for e in events if e["tid"] == main]
    by_name: dict[str, list] = {}
    for e in host:
        by_name.setdefault(e["name"], []).append(e)
    parents = PARENT[backend]
    assert set(TOP) | set(parents) <= set(by_name)
    for name in TOP:
        assert not any(_inside(e, p) for e in by_name[name] for p in host
                       if p is not e and p["name"] in TOP), name
    for child, parent in parents.items():
        for e in by_name[child]:
            assert any(_inside(e, p) for p in by_name[parent]), (child, e)
    # a span for one segment says which
    for name in ("segment.process", "segment.prepare", "prepare.residue",
                 "segment.device", "segment.result", "segment.record"):
        assert sorted(e["args"]["seg"] for e in by_name[name]) == list(range(SEGMENTS))
    assert agg["prepare.chain"][1] == 1 and agg["segment.process"][1] == SEGMENTS
    # the children account for a segment's time
    kids = ("segment.prepare", "segment.device", "segment.result")
    for proc in by_name["segment.process"]:
        covered = sum(e["dur"] for k in kids for e in by_name[k] if _inside(e, proc))
        assert covered >= 0.95 * proc["dur"], proc["args"]["seg"]
    if backend == "cuda":
        assert agg["fused.launch"][1] == agg["fused.fetch"][1] == SEGMENTS
        assert "fused.pin" not in agg  # pinning is for a card's copy only
    else:
        # the word kernel's stages, on the CPU's device track, each inside
        # its segment's device call
        for name in WORDS:
            assert agg[name][1] == SEGMENTS
            for e in (e for e in events if e["name"] == name):
                assert e["tid"] == trace.device_track("cpu")[0]
                assert any(_inside(e, d) for d in by_name["segment.device"])


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_phase_seconds_are_the_prepare_spans(backend):
    res, agg, _ = _run(backend)
    phases = ("residue", "group", "flat", "corrections") if backend == "cuda" \
        else ("residue", "group", "corrections")
    hp = res.host_phases
    want = {"prep_s", *(f"prep_{p}_s" for p in phases)}
    if backend == "cuda":
        want |= {"reduction_mode", "postlude_fused_s"}
        assert hp["postlude_fused_s"] == pytest.approx(agg["segment.device"][0],
                                                       abs=2e-6)
    assert set(hp) == want
    for p in phases:
        assert hp[f"prep_{p}_s"] == pytest.approx(agg[f"prepare.{p}"][0], abs=2e-6)
    assert hp["prep_s"] == pytest.approx(
        sum(agg[f"prepare.{p}"][0] for p in phases), abs=1e-5)


class _Counting:
    """A stand-in for a clock or an event factory that counts its calls."""

    def __init__(self, value=None):
        self.calls = 0
        self.value = value

    def __call__(self, *args):
        self.calls += 1
        return self.value


class _FakeEvent:
    def __init__(self, at):
        self.at = at
        self.recorded = None

    def record(self, stream):
        self.recorded = self.at.pop(0)

    def query(self):
        return True

    def elapsed_time(self, other):  # milliseconds, as torch.cuda.Event's
        return other.recorded - self.recorded


@pytest.mark.parametrize("device", ["cuda:0", "cpu"])
def test_device_span_with_capture_off_records_nothing(device, monkeypatch):
    clock, event = _Counting(0.0), _Counting()
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(perf_counter=clock))
    monkeypatch.setattr(trace, "_cuda_event", event)
    tr = trace.Tracer()
    with tr.device_span("words.tier1", device) as sp:
        pass
    tr.flush_device_spans()
    assert (clock.calls, event.calls) == (0, 0)
    assert sp is trace._NO_SPAN and tr.snapshot() == {} and tr.events() == []


def test_device_span_on_a_card_is_timed_by_events(monkeypatch):
    """With capture on, a card's span is a pair of events, resolved at the
    flush into the totals and onto the card's track."""
    at = [10.0, 14.5, 20.0, 21.0]  # the stub card's clock, ms
    monkeypatch.setattr(trace, "_cuda_event", lambda: _FakeEvent(at))
    monkeypatch.setattr(trace, "_current_stream", lambda device: None)
    tr = trace.Tracer()
    tr.enable()
    with tr.device_span("words.tier2", "cuda:1", seg=3):
        pass
    with tr.device_span("words.tail", "cuda:1"):
        pass
    assert tr.snapshot() == {}  # nothing until the fetch's flush
    tr.flush_device_spans()
    agg = tr.snapshot()
    assert agg["words.tier2"] == (pytest.approx(4.5e-3), 1)
    assert agg["words.tail"] == (pytest.approx(1e-3), 1)
    ev = [e for e in tr.events() if e["ph"] in ("X", "M")]
    tid, label = trace.device_track("cuda:1")
    assert label == "cuda:1 (events)"
    assert {e["tid"] for e in ev} == {tid}
    assert [e["args"]["name"] for e in ev if e["ph"] == "M"] == [label]
    x = {e["name"]: e for e in ev if e["ph"] == "X"}
    # placed on the host clock by the gaps between the events
    assert x["words.tail"]["ts"] - x["words.tier2"]["ts"] == pytest.approx(10e3)
    assert x["words.tier2"]["args"] == {"seg": 3}


def test_an_event_timed_interval_lands_on_the_card_track():
    """``round.gather`` under NCCL: timed by events, added afterwards."""
    tr = trace.Tracer()
    tr.enable()
    tr.add_device_span("round.gather", "cuda:2", 1.0, 0.5, round=3)
    (meta, x) = tr.events()
    assert meta["tid"] == x["tid"] == trace.device_track("cuda:2")[0]
    assert meta["args"]["name"] == "cuda:2 (events)"
    assert (x["ts"], x["dur"], x["args"]) == (1e6, 5e5, {"round": 3})
    assert tr.snapshot() == {"round.gather": (0.5, 1)}


def test_device_spans_leave_the_main_thread_pieces_alone():
    _, _, events = _run("torch")
    main = threading.main_thread().ident
    t0 = min(e["ts"] for e in events)

    def spans(evs):
        return [((e["ts"] - t0) / 1e6, (e["ts"] + e["dur"] - t0) / 1e6, e["name"])
                for e in evs]

    device = [e for e in events if e["name"] in WORDS]
    assert len(device) == 3 * SEGMENTS
    host = [e for e in events if e not in device]
    pieces = harness.innermost(spans(e for e in events if e["tid"] == main))
    assert pieces == harness.innermost(spans(e for e in host if e["tid"] == main))
    assert not any(name in WORDS for _, _, name in pieces)
    # on the issuing thread they would have split its pieces
    assert harness.innermost(spans(host + device)) != pieces


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_round_stack_holds_the_staging_spans(backend):
    snap = trace.snapshot()
    with _captured() as tr:
        run_mesh(SieveConfig(n=10**6, backend=backend, device="cpu", twins=True,
                             workers=2, rounds=2, quiet=True))
        events = [e for e in tr.events() if e.get("ph") == "X"]
    agg = trace.since(snap)
    if backend == "cuda":
        stacks = [e for e in events if e["name"] == "round.stack"]
        for name in ("fused.stage", "fused.copy"):
            assert agg[name][1] == 4
            for e in (e for e in events if e["name"] == name):
                assert any(_inside(e, s) for s in stacks)
    else:
        # the word kernel's stages, flushed when each round is drained
        assert all(agg[name][1] == 4 for name in WORDS)


def test_profile_dir_holds_the_spans(tmp_path):
    d = tmp_path / "prof"
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--n", "1e6", "--backend", "torch", "--device", "cpu",
                         "--twins", "--quiet", "--profile-dir", str(d)]) == 0
    assert trace._MIRROR is None  # the mirror ends with the session
    (path,) = d.glob("*.pt.trace.json*")
    with open(path) as f:
        doc = json.load(f)
    ranges = {e["name"] for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"}
    assert {"segment.prepare", "segment.device", "words.tier1", "words.tier2",
            "words.tail", "words.fetch"} <= ranges


def test_mirror_wraps_each_span_in_a_profiler_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        trace.mirror_to_profiler(True)
        try:
            with trace.span("segment.prepare", seg=0):
                torch.ones(4).sum()
        finally:
            trace.mirror_to_profiler(False)
        with trace.span("segment.device", seg=0):  # after: not mirrored
            pass
    names = [e.key for e in p.key_averages()]
    assert "segment.prepare" in names and "segment.device" not in names
