"""The port's recorders and shared service helpers against the reference's.

Counterparts of the halves of tests/test_debug.py:120-300 and
tests/test_profile.py:128-330 that need no server: the histogram's
reservoir, MetricsHistory's lifecycle and two-tier ring,
``sample_interval_s``, the FlightRecorder (redaction, snapshot, trigger,
cooldown, the crash hook), and the StackProfiler (roles, labels,
lifecycle, deterministic sampling, the bounded table, the merge and
share math). Then the tracer's exemplar ring and its module functions,
the ExemplarSampler and ``load_exemplars``, and rpc's columnar batch and
primes helpers, whose columns must be byte-equal to the reference's.
Wherever both packages expose a value, the same inputs give it equal.
"""

import json
import os
import random
import sys
import threading
import time

import numpy as np
import pytest

import sieve.debug as ref_debug
import sieve.metrics as ref_metrics
import sieve.profile as ref_profile
import sieve.rpc as ref_rpc
import sieve.service.exemplar as ref_exemplar
import sieve.trace as ref_trace
import sieve_torch.debug as debug
import sieve_torch.metrics as metrics
import sieve_torch.profile as profile
import sieve_torch.rpc as rpc
import sieve_torch.service.exemplar as exemplar
import sieve_torch.trace as trace
from sieve_torch.config import SieveConfig
from sieve_torch.service import StoreSettings

def _wait(cond, timeout_s=5.0, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


# --- histogram and MetricsHistory ---------------------------------------------


def test_histogram_reservoir_bound_and_accuracy():
    h = metrics.Histogram("acc.test")
    rng = random.Random(42)
    for _ in range(50_000):
        h.observe(rng.uniform(0.0, 100.0))
    assert len(h._reservoir) == metrics.HISTOGRAM_RESERVOIR
    snap = h.snapshot()
    for key, true in (("p50", 50.0), ("p95", 95.0), ("p99", 99.0)):
        assert abs(snap[key] - true) <= 2.0, f"{key}={snap[key]}"
    r = ref_metrics.Histogram("acc.test")
    rng = random.Random(42)
    for _ in range(50_000):
        r.observe(rng.uniform(0.0, 100.0))
    assert snap == r.snapshot()


def test_history_start_stop_idempotent_and_drain_on_stop():
    reg = metrics.MetricsRegistry()
    reg.counter("t.c").inc()
    h = metrics.MetricsHistory(reg=reg, sample_s=0.01)
    h.start()
    first_thread = h._thread
    h.start()
    assert h._thread is first_thread
    _wait(lambda: h.samples >= 3, what="3 samples")
    reg.counter("t.born_late").inc(5)
    seen = h.samples
    _wait(lambda: h.samples >= seen + 2, what="churn samples")
    reg.counter("t.final_tick").inc()
    h.stop()
    taken = h.samples
    assert taken >= 5
    assert h.history("t.final_tick", 60.0)[-1][1] == 1
    late = [v for _, v in h.history("t.born_late", 60.0)]
    assert late and all(v == 5 for v in late)
    assert len(late) < len(h.rows())
    h.stop()
    assert h.samples == taken and h._thread is None


def test_history_disabled_takes_zero_samples():
    h = metrics.MetricsHistory(reg=metrics.MetricsRegistry(), sample_s=0.0)
    h.start()
    assert h._thread is None
    time.sleep(0.03)
    h.stop()
    assert h.samples == 0 and h.rows() == []


@pytest.mark.parametrize("recent,coarse,decimate,n", [(4, 8, 2, 20), (3, 2, 5, 40),
                                                      (300, 360, 10, 50)])
def test_history_two_tier_ring_equals_the_reference(recent, coarse, decimate, n):
    vals = []
    for mod in (metrics, ref_metrics):
        reg = mod.MetricsRegistry()
        g = reg.gauge("t.g")
        h = mod.MetricsHistory(reg=reg, sample_s=0.0, recent=recent, coarse=coarse,
                               decimate=decimate)
        for i in range(n):
            g.set(float(i))
            h.sample_now()
        assert h.samples == n
        vals.append([snap["t.g"]["value"] for _, snap in h.rows()])
        assert [v for _, v in h.history("t.g", 60.0)] == vals[-1]
    assert vals[0] == vals[1]
    assert vals[0][-min(recent, n):] == [float(i) for i in range(n - min(recent, n), n)]


@pytest.mark.parametrize("value", [None, "0", "0.25", "fast", "-1", "inf"])
def test_sample_interval_equals_the_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("SIEVE_METRICS_SAMPLE_S", raising=False)
    else:
        monkeypatch.setenv("SIEVE_METRICS_SAMPLE_S", value)
    outcomes = []
    for mod in (metrics, ref_metrics):
        try:
            outcomes.append(mod.sample_interval_s())
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


# --- FlightRecorder -----------------------------------------------------------


def test_redact_equals_the_reference():
    obj = {"api_key": "hunter2", "nested": {"auth_token": "x", "ok": 2},
           "fine": [1, "two", None, (3, 4)], "password": 5, "n": 1.5}
    got = debug.redact(obj)
    assert got == ref_debug.redact(obj)
    assert got["api_key"] == "<redacted>" and got["nested"]["auth_token"] == "<redacted>"
    assert got["nested"]["ok"] == 2 and got["fine"] == [1, "two", None, [3, 4]]
    odd = debug.redact({"obj": object()})
    assert isinstance(odd["obj"], str)
    json.dumps(odd)
    flat = debug.redact(StoreSettings())
    assert flat == ref_debug.redact(StoreSettings()) and flat["t2_bytes"] == 0


def test_recorder_snapshot_trigger_cooldown_and_bundle_dir(tmp_path):
    snaps = []
    for mod, name in ((debug, "port"), (ref_debug, "ref")):
        rec = mod.FlightRecorder("service", debug_dir=str(tmp_path / name),
                                 cooldown_s=60.0, config={"n": 7, "token": "s3"})
        rec.install()
        try:
            rec.emit({"event": "service_shed", "op": "pi"})
            rec.emit({"event": "run", "n": 7})
            snap = rec.snapshot()
            assert snap["bundle"] == mod.BUNDLE_VERSION == "sieve-debug/1"
            assert snap["config"]["token"] == "<redacted>"
            assert [e["event"] for e in snap["errors"]] == ["service_shed"]
            b1 = rec.trigger("slo_burn", op="pi", p95_ms=9.0)
            with open(os.path.join(b1["path"], "bundle.json")) as f:
                on_disk = json.load(f)
            assert on_disk["trigger"] == "slo_burn"
            assert on_disk["detail"] == {"op": "pi", "p95_ms": 9.0}
            assert rec.trigger("slo_burn", op="pi") is None
            b2 = rec.trigger("breaker_open", reason="cold errors")
            assert b2["path"] != b1["path"]
            snaps.append(rec.snapshot())
        finally:
            rec.uninstall()
    got, want = snaps
    assert set(got) == set(want)
    for key in ("bundle", "role", "trigger", "detail", "config", "events", "errors",
                "profile"):
        assert got[key] == want[key], key
    assert {k: v for k, v in got["recorder"].items() if k != "debug_dir"} == \
        {k: v for k, v in want["recorder"].items() if k != "debug_dir"} == \
        {"bundles": 2, "suppressed": 1, "cooldown_s": 60.0}


def test_recorder_crash_hook_fires_and_uninstall_restores(monkeypatch):
    quiet_hook = lambda args: None  # noqa: E731 — silence the traceback
    monkeypatch.setattr(threading, "excepthook", quiet_hook)
    prev_sys = sys.excepthook
    rec = debug.FlightRecorder("service", cooldown_s=0.0)
    rec.install()
    try:
        t = threading.Thread(target=lambda: 1 / 0, name="doomed")
        t.start()
        t.join(10)
        _wait(lambda: rec.last_bundle is not None, what="crash bundle")
        b = rec.last_bundle
        assert b["trigger"] == "crash" and b["path"] is None
        assert "ZeroDivisionError" in b["detail"]["error"]
        assert b["detail"]["thread"] == "doomed"
    finally:
        rec.uninstall()
    assert threading.excepthook is quiet_hook and sys.excepthook is prev_sys


def test_recorder_bundles_history_and_profile(tmp_path):
    reg = metrics.registry()
    reg.counter("rec.test").inc()
    hist = metrics.MetricsHistory(sample_s=0.0)
    hist.sample_now()
    prof = profile.StackProfiler("service", hz=0)
    sink = metrics.MemorySink()
    metrics.add_sink(sink)
    try:
        logger = metrics.MetricsLogger(SieveConfig(n=10, quiet=True), stream=open(os.devnull, "w"))
        rec = debug.FlightRecorder("service", history=hist, profiler=prof,
                                   logger=logger, cooldown_s=0.0)
        b = rec.trigger("manual")
    finally:
        metrics.remove_sink(sink)
    assert b["history"] and b["history"][0]["metrics"]["rec.test"]["value"] >= 1
    assert b["profile"]["profile"] == profile.PROFILE_VERSION
    kinds = [r["event"] for r in sink.records]
    assert kinds == ["profile_captured", "debug_bundle"]
    for r in sink.records:
        metrics.validate_record(r)


# --- StackProfiler ------------------------------------------------------------

NAMES = ["svc-wire", "router-accept", "router-conn", "svc-worker-hot-3",
         "exemplar-writer", "svc-batcher", "prof-sampler-service", "sieve-observer",
         "metrics-history", "store-compact", "MainThread", "Thread-7",
         "svc-worker-hot-0", "svc-worker-hot-12", "wheel30", "a-", "x-1-2"]


def test_thread_role_and_label_equal_the_reference():
    for name in NAMES:
        assert profile.thread_role(name) == ref_profile.thread_role(name), name
        assert profile.thread_label(name) == ref_profile.thread_label(name), name
    assert profile.thread_role("svc-worker-hot-3") == "worker"
    assert profile.thread_label("svc-worker-hot-12") == "svc-worker-hot"
    assert (profile.DEFAULT_HZ, profile.DEFAULT_STACKS, profile.PROFILE_VERSION) == (
        ref_profile.DEFAULT_HZ, ref_profile.DEFAULT_STACKS, ref_profile.PROFILE_VERSION)


def _spin(evt, label=None):
    if label is not None:
        with trace.span(label):
            while not evt.is_set():
                pass
    else:
        while not evt.is_set():
            pass


def _spinner(name, label=None):
    evt = threading.Event()
    t = threading.Thread(target=_spin, args=(evt, label), name=name, daemon=True)
    t.start()
    return evt, t


def test_start_stop_idempotent_and_table_survives_stop():
    p = profile.StackProfiler("t", hz=200.0)
    assert p.start() is p and p.start() is p and p.running
    evt, t = _spinner("svc-worker-hot-0")
    try:
        _wait(lambda: p.stats()["samples"] > 0, what="a sample")
    finally:
        evt.set()
        t.join(10)
    p.stop()
    p.stop()
    assert not p.running
    snap = p.snapshot()
    assert snap["profile"] == profile.PROFILE_VERSION and snap["samples"] > 0


def test_hz_zero_no_op_negative_rejected_and_pause():
    p = profile.StackProfiler("t", hz=0)
    assert p.start() is p and not p.running and p.snapshot()["samples"] == 0
    for bad in (-1, True, "19"):
        with pytest.raises(ValueError):
            profile.StackProfiler("t", hz=bad)
    p.pause(2)
    p.pause(1)  # max-merge, never additive
    assert p.stats()["pauses"] == 2 and p._paused_beats == 2


def test_sample_once_tags_role_and_active_span():
    p = profile.StackProfiler("t", hz=0)
    evt, t = _spinner("svc-worker-hot-0", label="rpc.test")
    try:
        hits = []
        deadline = time.time() + 5
        while not hits and time.time() < deadline:
            p.sample_once()
            hits = [r for r in p.snapshot()["stacks"]
                    if r["stack"].startswith("svc-worker-hot;rpc.test;")]
    finally:
        evt.set()
        t.join(10)
    assert hits and hits[0]["role"] == "worker"
    assert "test_torch_recorders._spin" in hits[0]["stack"]


def test_sample_once_skips_idle_leaves_by_default():
    p = profile.StackProfiler("t", hz=0)
    pi = profile.StackProfiler("t", hz=0, include_idle=True)
    evt = threading.Event()
    t = threading.Thread(target=evt.wait, name="svc-worker-hot-0", daemon=True)
    t.start()
    try:
        idle = []
        deadline = time.time() + 5
        while not idle and time.time() < deadline:
            p.sample_once()
            pi.sample_once()
            idle = [r for r in pi.snapshot()["stacks"]
                    if r["stack"].startswith("svc-worker-hot;idle;")]
    finally:
        evt.set()
        t.join(10)
    assert idle
    assert not [r for r in p.snapshot()["stacks"]
                if r["stack"].startswith("svc-worker-hot;")]


def test_bounded_table_drops_coldest_and_never_samples_itself():
    p = profile.StackProfiler("t", hz=0, max_stacks=2)
    with p._lock:
        p._table.update({"a;hot": [9, None], "b;warm": [3, None], "c;cold": [1, None]})
        while len(p._table) >= p.max_stacks:
            p._evict_coldest_locked()
        p._table["d;new"] = [1, None]
    snap = p.snapshot()
    assert {r["stack"] for r in snap["stacks"]} == {"a;hot", "d;new"}
    assert snap["evicted"] == 2
    q = profile.StackProfiler("t", hz=0)
    for _ in range(5):
        q.sample_once()
    assert not [r for r in q.snapshot()["stacks"] if "sample_once" in r["stack"]]


def _doc(stacks):
    return {"profile": profile.PROFILE_VERSION,
            "stacks": [{"stack": s, "count": c, "role": r} for s, c, r in stacks]}


PROFILES = [
    [("shard0", _doc([("svc-wire;a.f", 6, "loop"), ("svc-worker;b.g", 3, "worker")])),
     ("shard0.r1", _doc([("svc-wire;a.f", 2, "loop")])),
     ("router", _doc([("Thread-1;c.h", 1, None)]))],
    [("p", _doc([("w;a.f;b.g", 6, "loop"), ("w;b.g", 4, "loop"),
                 ("w;b.g;a.f", 2, "loop")]))],
    [("p", _doc([("w;a.f", 2, None), ("w;b.g", 8, None)])), ("q", None)],
]


@pytest.mark.parametrize("docs", PROFILES)
def test_merge_and_report_math_equal_the_reference(docs):
    merged = profile.merge_stacks(docs)
    assert merged == ref_profile.merge_stacks(docs)
    assert profile.collapse_lines(merged) == ref_profile.collapse_lines(merged)
    assert profile.self_times(merged) == ref_profile.self_times(merged)
    assert profile.self_times(merged, n=1) == ref_profile.self_times(merged, n=1)
    assert profile.role_tagged_fraction(merged) == \
        ref_profile.role_tagged_fraction(merged)
    for other in PROFILES:
        new = profile.merge_stacks(other)
        assert profile.diff_shares(merged, new) == ref_profile.diff_shares(merged, new)
        assert profile.diff_shares(merged, new, n=2) == \
            ref_profile.diff_shares(merged, new, n=2)


def test_merge_values():
    merged = profile.merge_stacks(PROFILES[0])
    assert merged["shard0;svc-wire;a.f"] == {"count": 6, "role": "loop"}
    assert profile.collapse_lines(merged)[0] == "shard0;svc-wire;a.f 6"
    assert profile.role_tagged_fraction(merged) == pytest.approx(11 / 12)
    rows = profile.diff_shares(profile.merge_stacks(PROFILES[2]),
                               profile.merge_stacks(PROFILES[1]))
    assert rows[0]["frame"] == "b.g"


# --- the tracer's exemplar ring and module functions ----------------------------


def _ring_script(tr_mod):
    tr = tr_mod.Tracer()
    tr.exemplar_enable(6)
    for req in range(4):
        for k in range(3 if req != 2 else 1):
            tr.add_span(f"s{k}", 1.0 + req, 0.5, ctx=f"run/{req}.0/s{k}.1", k=k)
    tr.add_span("no_ctx", 0.0, 0.1, k=1)  # not request-scoped: not ringed
    out = {"all": tr.exemplar_collect(), "one": tr.exemplar_collect("run/3.0"),
           "prefix": tr.exemplar_collect("run"), "miss": tr.exemplar_collect("run/0.0"),
           "dropped": tr.exemplar_dropped}
    tr.exemplar_enable(1)  # one giant request: its oldest spans age out
    out["one_left"] = tr.exemplar_collect()
    out["dropped_after"] = tr.exemplar_dropped
    tr.exemplar_disable()
    out["off"] = tr.exemplar_collect()
    return out


def _strip(rows):
    return [{k: v for k, v in r.items() if k not in ("pid", "tid")} for r in rows]


def test_exemplar_ring_equals_the_reference():
    got, want = _ring_script(trace), _ring_script(ref_trace)
    for key in ("all", "one", "prefix", "miss", "one_left", "off"):
        assert _strip(got[key]) == _strip(want[key]), key
    assert (got["dropped"], got["dropped_after"]) == (want["dropped"],
                                                     want["dropped_after"])
    assert [r["args"]["ctx"] for r in got["one"]] == [f"run/3.0/s{k}.1" for k in range(3)]
    assert got["miss"] == [] and got["off"] == []


def test_tail_pending_reset_total_s_and_active_label():
    tr = trace.Tracer()
    assert tr.tail(5) == [] and tr.pending() == 0
    tr.enable()
    for i in range(4):
        tr.instant("e", i=i)
    assert [e["args"]["i"] for e in tr.tail(2)] == [2, 3] and tr.tail(0) == []
    assert tr.pending() == 4
    snap = tr.snapshot()
    tr.add_span("x", 0.0, 0.25)
    tr.add_span("x", 0.0, 0.5)
    assert tr.total_s("x") == 0.75 and tr.total_s("x", snap) == 0.75
    assert tr.total_s("never") == 0.0
    tr.reset()
    assert tr.snapshot() == {} and tr.pending() == 0 and tr.dropped == 0
    assert trace.active_label() is None
    with trace.span("outer"):
        with trace.span("inner"):
            assert trace.active_label() == "inner"
        assert trace.active_label() == "outer"
    assert trace.active_label() is None
    for name in ("tail", "pending_events", "total_s", "exemplar_enable",
                 "exemplar_collect", "enabled", "set_event_limit", "ingest"):
        assert callable(getattr(trace, name)) and callable(getattr(ref_trace, name))
    before = trace.pending_events()
    assert isinstance(before, int) and trace.enabled() in (True, False)


# --- ExemplarSampler and load_exemplars ------------------------------------------


def _decide_script(mod):
    s = mod.ExemplarSampler("service", slack=2.0, baseline=5, window=16, warmup=4)
    rng = random.Random(3)
    out = []
    for i in range(60):
        outcome = "ok" if (i + 1) % 13 else "overloaded"
        ms = rng.uniform(1.0, 2.0) if (i + 1) % 17 else 50.0
        out.append(s.decide(outcome, ms, flagged=(i == 7)))
    return out, s.stats()


def test_decide_equals_the_reference():
    got, want = _decide_script(exemplar), _decide_script(ref_exemplar)
    assert got == want
    reasons = set(got[0])
    assert {"error", "flagged", "slow", "baseline", None} <= reasons
    assert got[0][0] == "baseline"  # the very first request is always kept


def test_keep_ring_files_rotation_and_load(tmp_path):
    files = []
    for mod, name in ((exemplar, "port"), (ref_exemplar, "ref")):
        d = tmp_path / name
        s = mod.ExemplarSampler("router", ring=3, file_bytes=300, debug_dir=str(d))
        for i in range(6):
            rec = s.keep({"ts": float(i), "ctx": f"run/{i}.0", "op": "pi",
                          "outcome": "ok", "ms": 1.5, "reason": "baseline",
                          "spans": []})
            assert rec["role"] == "router"
        s.flush()
        assert [r["ctx"] for r in s.tail()] == ["run/3.0", "run/4.0", "run/5.0"]
        assert [r["ctx"] for r in s.tail(1)] == ["run/5.0"]
        assert s.tail(ctx_prefix="run/4") == [s.tail()[1]]
        assert s.stats() == {"seen": 0, "kept": 6, "ring": 3}
        s.close()
        s.close()
        path = d / mod.EXEMPLAR_FILE
        files.append((path.read_bytes(), (d / (mod.EXEMPLAR_FILE + ".1")).read_bytes()))
        assert path.stat().st_size <= 300
    assert files[0] == files[1]
    assert exemplar.EXEMPLAR_FILE == ref_exemplar.EXEMPLAR_FILE
    assert exemplar.EXEMPLAR_SPAN_RING == ref_exemplar.EXEMPLAR_SPAN_RING


def test_writer_emits_kept_events_and_load_skips_a_torn_tail(tmp_path):
    sink = metrics.MemorySink()
    metrics.add_sink(sink)
    try:
        logger = metrics.MetricsLogger(SieveConfig(n=10, quiet=True), stream=open(os.devnull, "w"))
        s = exemplar.ExemplarSampler("service", debug_dir=str(tmp_path), logger=logger)
        s.keep({"ctx": "r/1.0", "op": "pi", "outcome": "overloaded", "ms": 0.1,
                "reason": "error", "spans": [{"name": "rpc.query"}]})
        s.flush()
        s.close()
    finally:
        metrics.remove_sink(sink)
    kept = [r for r in sink.records if r["event"] == "service_exemplar_kept"]
    assert len(kept) == 1 and kept[0]["spans"] == 1
    metrics.validate_record(kept[0])
    path = tmp_path / exemplar.EXEMPLAR_FILE
    with open(path, "a") as f:
        f.write('[1, 2]\n\n{"ctx": "torn", "op"')
    got = exemplar.load_exemplars(str(path))
    assert got == ref_exemplar.load_exemplars(str(path))
    assert [r["ctx"] for r in got] == ["r/1.0"]


# --- rpc's columnar batch and primes helpers -------------------------------------

BATCHES = [
    [{"op": "pi", "x": 10}, {"op": "is_prime", "x": 7}, {"op": "count", "lo": 2, "hi": 100}],
    [{"op": "count", "lo": 5, "hi": 9, "kind": "primes"}, {"op": "pi", "x": -(1 << 63)}],
    [{"op": "pi", "x": (1 << 63) - 1}] * 5,
    [],
    [{"op": "pi", "x": 1 << 63}],
    [{"op": "pi", "x": 3, "extra": 1}],
    [{"op": "count", "lo": 2, "hi": 9, "kind": "twins"}],
    [{"op": "nth_prime", "k": 3}],
    [{"op": "pi", "x": True}],
    ["pi"],
]


@pytest.mark.parametrize("items", BATCHES)
def test_batch_columns_byte_equal_the_reference(items):
    got, want = rpc.batch_items_to_cols(items), ref_rpc.batch_items_to_cols(items)
    if want is None:
        assert got is None
        return
    (cols, ops), (rcols, rops) = got, want
    assert ops == rops and list(cols) == list(rcols)
    for k in cols:
        assert cols[k].dtype == rcols[k].dtype and cols[k].tobytes() == rcols[k].tobytes()
    assert rpc.encode_msg_v2({"op": "batch", "id": 1}, cols) == \
        ref_rpc.encode_msg_v2({"op": "batch", "id": 1}, rcols)
    back = rpc.batch_cols_to_items(cols["b_op"], cols["b_a"], cols["b_b"])
    assert back == ref_rpc.batch_cols_to_items(cols["b_op"], cols["b_a"], cols["b_b"])
    assert [m["op"] for m in back] == ops


OUTCOMES = [
    [{"ok": True, "op": "pi", "value": 4}, {"ok": True, "op": "is_prime", "value": True},
     {"ok": False, "op": "count", "error": "bad_request", "message": "lo > hi"},
     {"ok": True, "op": "count", "value": 0}],
    [{"ok": True, "op": "pi", "value": 25}] * 3,
    [],
]


@pytest.mark.parametrize("outcomes", OUTCOMES)
def test_batch_outcomes_equal_the_reference(outcomes):
    got = rpc.BatchOutcomes.from_items(outcomes)
    want = ref_rpc.BatchOutcomes.from_items(outcomes)
    (extra, cols), (rextra, rcols) = got.wire(), want.wire()
    assert extra == rextra
    assert {k: v.tobytes() for k, v in cols.items()} == \
        {k: v.tobytes() for k, v in rcols.items()}
    assert got.to_items() == want.to_items()
    frame = rpc.encode_msg_v2({"id": 9, **extra}, cols)
    assert frame == ref_rpc.encode_msg_v2({"id": 9, **rextra}, rcols)
    ops = [o.get("op") for o in outcomes]
    reply = rpc.decode_body(frame[8:])
    rreply = ref_rpc.decode_body(frame[8:])
    assert rpc.batch_reply_value(reply, ops) == ref_rpc.batch_reply_value(rreply, ops)
    coded = rpc.BatchOutcomes(got.ok, got.val, got.errors,
                              np.array([rpc.OP_NAMES.index(o) for o in ops], np.uint8))
    assert coded.to_items() == got.to_items()
    assert (rpc.OP_PI, rpc.OP_IS_PRIME, rpc.OP_COUNT, rpc.OP_NAMES) == (
        ref_rpc.OP_PI, ref_rpc.OP_IS_PRIME, ref_rpc.OP_COUNT, ref_rpc.OP_NAMES)


@pytest.mark.parametrize("packing", ["plain", "odds", "wheel30"])
@pytest.mark.parametrize("lo,hi", [(2, 1000), (0, 30), (990_000, 1_000_000),
                                   (10**12, 10**12 + 10**6), (97, 98), (50, 50)])
def test_primes_columns_byte_equal_the_reference(packing, lo, hi):
    from sieve.seed import seed_primes

    if hi <= 10**7:
        p = seed_primes(max(hi, 2))
        vals = p[(p >= lo) & (p < hi)].astype(np.int64)
    else:
        vals = np.array([10**12 + 39, 10**12 + 61], dtype=np.int64)  # sparse window
    (extra, cols), (rextra, rcols) = (rpc.primes_to_cols(vals, packing, lo, hi),
                                      ref_rpc.primes_to_cols(vals, packing, lo, hi))
    assert extra == rextra
    assert {k: v.tobytes() for k, v in cols.items()} == \
        {k: v.tobytes() for k, v in rcols.items()}
    frame = rpc.encode_msg_v2({"id": 1, **extra}, cols)
    for as_array in (False, True):
        got = rpc.primes_reply_value(rpc.decode_body(frame[8:]), as_array=as_array)
        want = ref_rpc.primes_reply_value(ref_rpc.decode_body(frame[8:]),
                                          as_array=as_array)
        assert list(got) == list(want) == vals.tolist()
