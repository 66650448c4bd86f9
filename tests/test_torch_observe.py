"""The port's capacity observatory against the reference's
(sieve/service/observe.py): the port of tests/test_observe.py's ring,
signal, anomaly, scrape-gap, advice, settings and schema tests.

The snapshot ring's bytes are equal for the same appends and a ring
either package wrote reads back equal with the other's ``read_ring``;
torn tails, bad CRCs and compaction behave alike. ``derive_signals``
returns equal dicts on equal samples. Each anomaly scenario (warm-up,
the edge trigger, the fleet-wide bundle pull, a scrape gap, an
unreachable endpoint, scaling advice) runs both packages' observers over
the same faked endpoints on one hand-cranked clock: every scrape's
snapshot, the ring rows and the counters must be equal, and the port's
must meet the reference test's own assertions. Then a live fabric: the
port's observer scrapes the port's router and replicas with
``svc_scrape_gap`` directives, and ``python -m sieve_torch observe
--scrapes N`` prints the reference's lines. ObserverSettings' fields,
defaults, ``validate`` errors and ``from_env`` variables equal the
reference's. The exemplar sampler's tests are in
tests/test_torch_recorders.py; the reference's ``observe_smoke`` tool
test waits for the port's tools.
"""

import contextlib
import dataclasses
import io
import json
import os
import random
import re
import struct
import zlib
from pathlib import Path

import pytest

import sieve.cli as ref_cli
import sieve.service.observe as ref_observe
from sieve.chaos import ChaosSchedule as RefSchedule
from sieve.chaos import parse_chaos as ref_parse_chaos
from sieve.coordinator import run_local as ref_run_local
import sieve_torch.service.observe as port_observe
from sieve_torch import cli as port_cli
from sieve_torch.chaos import (
    DEFAULT_PARAM,
    KINDS,
    OBSERVER_KINDS,
    ChaosSchedule,
    parse_chaos,
)
from sieve_torch.metrics import EVENT_SCHEMA, validate_record
from sieve_torch.service.observe import (
    ANOMALY_SIGNALS,
    RING_FILE,
    ObserverSettings,
    SnapshotRing,
    derive_signals,
    read_ring,
)
from tests.test_torch_router import REF, Fabric, split_ledger

_REC_HEADER = struct.Struct("<III")
_REC_MAGIC = 0x53524E47
PKGS = [pytest.param(ref_observe, id="ref"), pytest.param(port_observe, id="port")]


# --- the on-disk snapshot ring -----------------------------------------------


def _records(n=7, pad=0):
    rng = random.Random(11)
    return [{"scrape": i, "ts": 1000.0 + i, "pad": "x" * pad,
             "targets": [{"addr": "h:1", "signals": {"hot_qps": rng.random()}}],
             "anomalies": [], "advice": []} for i in range(n)]


def test_ring_constants_equal_reference():
    assert RING_FILE == ref_observe.RING_FILE
    assert ANOMALY_SIGNALS == ref_observe.ANOMALY_SIGNALS
    assert port_observe._REC_HEADER.format == ref_observe._REC_HEADER.format
    assert port_observe._REC_MAGIC == ref_observe._REC_MAGIC == _REC_MAGIC


@pytest.mark.parametrize("cap,n,pad", [(4 << 20, 7, 0), (2048, 100, 40),
                                       (1 << 12, 60, 10)])
def test_ring_bytes_equal_and_each_reads_the_other(tmp_path, cap, n, pad):
    paths = {}
    for name, mod in (("ref", ref_observe), ("port", port_observe)):
        paths[name] = str(tmp_path / name / RING_FILE)
        os.makedirs(os.path.dirname(paths[name]))
        ring = mod.SnapshotRing(paths[name], cap_bytes=cap)
        for rec in _records(n, pad):
            ring.append(rec)
        assert ring.records(2) == [r for r in read_ring(paths[name])][-2:]
    assert Path(paths["port"]).read_bytes() == Path(paths["ref"]).read_bytes()
    mine = read_ring(paths["port"])
    assert ref_observe.read_ring(paths["port"]) == mine
    assert read_ring(paths["ref"]) == ref_observe.read_ring(paths["ref"]) == mine
    assert [r["scrape"] for r in mine] == list(range(n - len(mine), n))
    if cap < 4 << 20:
        assert os.path.getsize(paths["port"]) <= cap  # compaction ran


def test_ring_append_read_roundtrip(tmp_path):
    path = str(tmp_path / RING_FILE)
    ring = SnapshotRing(path)
    for i in range(7):
        ring.append({"scrape": i})
    assert [r["scrape"] for r in read_ring(path)] == list(range(7))
    assert ring.records(2) == [{"scrape": 5}, {"scrape": 6}]


@pytest.mark.parametrize("writer", PKGS)
def test_ring_reader_stops_at_torn_tail_and_open_trims_it(tmp_path, writer):
    path = str(tmp_path / RING_FILE)
    ring = writer.SnapshotRing(path)
    ring.append({"scrape": 1})
    ring.append({"scrape": 2})
    with open(path, "ab") as f:
        f.write(_REC_HEADER.pack(_REC_MAGIC, 500, 0) + b"short")
    # a concurrent reader never crashes on the half-written tail
    assert [r["scrape"] for r in read_ring(path)] == [1, 2]
    reopened = SnapshotRing(path)  # crash-restart trims the torn frame
    assert reopened.torn == 1
    assert [r["scrape"] for r in ref_observe.read_ring(path)] == [1, 2]
    reopened.append({"scrape": 3})
    assert [r["scrape"] for r in read_ring(path)] == [1, 2, 3]


def test_ring_reader_stops_at_bad_crc(tmp_path):
    path = str(tmp_path / RING_FILE)
    ring = SnapshotRing(path)
    ring.append({"scrape": 1})
    payload = json.dumps({"scrape": 2}).encode()
    with open(path, "ab") as f:
        f.write(_REC_HEADER.pack(_REC_MAGIC, len(payload),
                                 zlib.crc32(payload) ^ 0xFF) + payload)
    assert [r["scrape"] for r in read_ring(path)] == [1]
    assert ref_observe.read_ring(path) == read_ring(path)


def test_ring_compaction_keeps_newest_under_half_cap(tmp_path):
    path = str(tmp_path / RING_FILE)
    ring = SnapshotRing(path, cap_bytes=2048)
    for i in range(100):
        ring.append({"scrape": i, "pad": "x" * 40})
    assert ring.compactions >= 1
    assert os.path.getsize(path) <= 2048
    recs = read_ring(path)
    assert recs  # newest survive, oldest are gone, order preserved
    assert [r["scrape"] for r in recs] == list(range(100 - len(recs), 100))


# --- signal derivation -------------------------------------------------------


def _service_sample(rng, prev=None):
    base = prev or {}

    def grow(k):
        return int(base.get(k, 0)) + rng.randrange(0, 50)
    return {k: grow(k) for k in (
        "hot_admitted", "cold_admitted", "shed", "lane_shed_hot",
        "lane_shed_cold", "deadline_exceeded", "internal_errors",
        "degraded_replies")} | {
        "queue_depth": rng.randrange(0, 9),
        "store": {"hits": rng.randrange(0, 30), "misses": rng.randrange(0, 10)},
        "slo": {"hot": {"burn": rng.random()}, "cold": {"burn": None}},
        "mesh_fanout": rng.randrange(0, 4)}


def _signal_cases():
    rng = random.Random(5)
    cases = [
        ("service", {"covered_hi": 1000}, {"hot_admitted": 500, "queue_depth": 3},
         None, None),
        ("service", {"covered_hi": 3000},
         {"hot_admitted": 150, "cold_admitted": 20, "shed": 4, "lane_shed_hot": 1,
          "lane_shed_cold": 3, "deadline_exceeded": 3, "internal_errors": 1,
          "degraded_replies": 0, "queue_depth": 7,
          "store": {"hits": 30, "misses": 10},
          "slo": {"hot": {"burn": 0.25}, "cold": {"burn": 1.5}}},
         {"hot_admitted": 100, "cold_admitted": 10, "shed": 0, "lane_shed_hot": 0,
          "lane_shed_cold": 2, "deadline_exceeded": 1, "internal_errors": 0,
          "degraded_replies": 0, "_covered_hi": 1000}, 2.0),
        ("router", {},
         {"requests": 30, "shed_relayed": 4, "deadline_exceeded": 1,
          "internal_errors": 0, "shard_errors": 1, "unavailable_replies": 2},
         {"requests": 10, "shed_relayed": 0, "deadline_exceeded": 0,
          "internal_errors": 0, "shard_errors": 0, "unavailable_replies": 0}, 2.0),
        ("service", None, None, None, None),
        ("router", {"covered_hi": 5}, {}, {}, 0.0),
    ]
    for _ in range(12):
        prev = _service_sample(rng)
        prev["_covered_hi"] = rng.randrange(0, 10**6)
        cur = _service_sample(rng, prev)
        cases.append(("service", {"covered_hi": prev["_covered_hi"]
                                  + rng.randrange(0, 10**5)},
                      cur, prev, rng.choice([0.5, 1.0, 2.5])))
    return cases


@pytest.mark.parametrize("case", _signal_cases())
def test_derive_signals_equal_reference(case):
    got = derive_signals(*case)
    assert got == ref_observe.derive_signals(*case)
    assert set(got) >= set(ANOMALY_SIGNALS)


def test_derive_signals_values():
    first, service, router = _signal_cases()[:3]
    sig = derive_signals(*first)
    assert (sig["hot_qps"], sig["covered_rate"], sig["lane_depth"]) == (0.0, 0.0, 3.0)
    sig = derive_signals(*service)
    assert (sig["hot_qps"], sig["cold_qps"], sig["lane_depth"]) == (25.0, 5.0, 7.0)
    assert sig["shed_rate"] == pytest.approx(3.0)
    assert sig["err_rate"] == pytest.approx(1.5)
    assert (sig["slo_burn"], sig["store_hit"]) == (1.5, 0.75)
    assert sig["covered_rate"] == pytest.approx(1000.0)
    sig = derive_signals(*router)
    assert (sig["hot_qps"], sig["shed_rate"], sig["err_rate"]) == (10.0, 2.0, 2.0)


# --- the anomaly engine: both packages on one faked fleet --------------------


class _FakeClient:
    """Programmable health/stats endpoint standing in for a live RPC."""

    def __init__(self):
        self.health_doc = {"covered_hi": 0}
        self.stats_doc = {}
        self.debug_calls = 0

    def health(self):
        return dict(self.health_doc)

    def stats(self):
        return dict(self.stats_doc)

    def debug(self):
        self.debug_calls += 1
        return {"recorder": "state"}


class _FakePool:
    def __init__(self, clients):
        self.clients = clients

    def get(self, addr):
        cli = self.clients[addr]
        if isinstance(cli, Exception):
            raise cli
        return cli

    def invalidate(self, addr):
        pass

    def close(self):
        pass


class _Twin:
    """One observer per package over the same faked endpoints, on one
    hand-cranked clock; ``tick`` scrapes both and returns the port's
    snapshot after asserting it equals the reference's."""

    def __init__(self, tmp_path, monkeypatch, clients, *, chaos=None, **over):
        self.clock = {"t": 1000.0}
        monkeypatch.setattr("time.time", lambda: self.clock["t"])
        self.clients = clients
        self.dirs = {}
        self.obs = {}
        for name, mod, sched in (("ref", ref_observe, RefSchedule),
                                 ("port", port_observe, ChaosSchedule)):
            self.dirs[name] = str(tmp_path / name)
            knobs = dict(warmup=3, min_delta=2.0, z_threshold=6.0, alpha=0.3,
                         cooldown_s=1e9, observe_dir=self.dirs[name], quiet=True)
            knobs.update(over)
            parse = ref_parse_chaos if name == "ref" else parse_chaos
            obs = mod.FleetObserver("r:0", mod.ObserverSettings(**knobs),
                                    chaos=sched(parse(chaos or "")))
            obs.pool = _FakePool(clients)
            targets = [{"role": "router" if a == "r:0" else "shard", "addr": a,
                        "shard": None if a == "r:0" else i - 1}
                       for i, a in enumerate(clients)]
            monkeypatch.setattr(obs, "_discover", lambda t=targets: list(t))
            self.obs[name] = obs

    def _named(self, name, doc):
        return json.loads(json.dumps(doc).replace(self.dirs[name], "<dir>"))

    def tick(self, dt=1.0):
        self.clock["t"] += dt
        ref = self._named("ref", self.obs["ref"].scrape_once())
        port = self._named("port", self.obs["port"].scrape_once())
        assert port == ref
        assert self.stats() == self._named("ref", self.obs["ref"].stats())
        return port

    def stats(self):
        return self._named("port", self.obs["port"].stats())

    def ring(self):
        rows = read_ring(os.path.join(self.dirs["port"], RING_FILE))
        assert [self._named("port", r) for r in rows] == [
            self._named("ref", r) for r in
            ref_observe.read_ring(os.path.join(self.dirs["ref"], RING_FILE))]
        return rows


def test_anomaly_requires_warmup_then_edge_triggers_once(tmp_path, monkeypatch):
    # an immediate spike on a COLD endpoint must not alarm (not armed)
    cold_svc = _FakeClient()
    cold_svc.stats_doc = {"queue_depth": 80}
    cold = _Twin(tmp_path / "cold", monkeypatch, {"r:0": _FakeClient(),
                                                   "s:0": cold_svc})
    assert cold.tick()["anomalies"] == []
    assert cold.stats()["anomalies"] == 0
    # a calm warmup then the same spike: exactly one fleet_anomaly
    svc = _FakeClient()
    svc.stats_doc = {"queue_depth": 0}
    tw = _Twin(tmp_path / "armed", monkeypatch, {"r:0": _FakeClient(), "s:0": svc})
    for _ in range(6):  # settle: warmup consecutive calm samples
        assert tw.tick()["anomalies"] == []
    svc.stats_doc = {"queue_depth": 50}  # lane_depth excursion, dev ~0
    snap = tw.tick()
    assert tw.stats()["anomalies"] == 1
    [evid] = [a for a in snap["anomalies"] if a["signal"] == "lane_depth"]
    assert evid["addr"] == "s:0" and evid["value"] == 50.0 and evid["z"] > 6.0
    # edge trigger: the breach persisting does not re-fire in cooldown
    tw.tick()
    assert tw.stats()["anomalies"] == 1
    assert tw.ring()[-2]["anomalies"][0]["signal"] == "lane_depth"


def test_anomaly_fires_fleet_wide_bundle_pull(tmp_path, monkeypatch):
    router, svc = _FakeClient(), _FakeClient()
    tw = _Twin(tmp_path, monkeypatch, {"r:0": router, "s:0": svc})
    for _ in range(6):
        tw.tick()
    svc.stats_doc = {"queue_depth": 50}
    tw.tick()
    assert tw.stats()["anomalies"] == 1
    docs = []
    for name in ("ref", "port"):
        [bundle] = [f for f in os.listdir(tw.dirs[name]) if f.startswith("anomaly_")]
        docs.append(json.loads(Path(tw.dirs[name], bundle).read_text()))
    ref_doc, doc = docs
    assert doc["trigger"] == "fleet_anomaly"
    assert {p["addr"] for p in doc["processes"]} == {"r:0", "s:0"}
    assert all(p["bundle"] == {"recorder": "state"} for p in doc["processes"])
    assert doc == ref_doc  # the clock is one, so the bundles are equal
    assert router.debug_calls == 2 and svc.debug_calls == 2  # one per package


def test_scrape_gap_counts_disarms_and_never_false_alarms(tmp_path, monkeypatch):
    svc = _FakeClient()
    tw = _Twin(tmp_path, monkeypatch, {"r:0": _FakeClient(), "s:0": svc},
               chaos="svc_scrape_gap:any@s4")
    svc.stats_doc = {"hot_admitted": 0, "queue_depth": 0}
    for _ in range(3):
        tw.tick()
    snap = tw.tick()  # scrape 4: the chaos draw eats the router poll
    assert tw.stats()["gaps"] == 1
    gap_rows = [t for t in snap["targets"] if t["gap"]]
    assert [t["addr"] for t in gap_rows] == ["r:0"]
    assert gap_rows[0]["gap"] == "svc_scrape_gap"
    assert "signals" not in gap_rows[0]  # a gap is never a sample
    # the sample right after the gap re-seeds the baseline: even a huge
    # counter jump on the gapped endpoint cannot alarm
    tw.clients["r:0"].stats_doc = {"requests": 10**7}
    for _ in range(3):  # within warmup after the reset
        assert tw.tick()["anomalies"] == []
    assert tw.stats()["anomalies"] == 0


def test_unreachable_endpoint_is_a_named_gap_not_a_sample(tmp_path, monkeypatch):
    tw = _Twin(tmp_path, monkeypatch,
               {"r:0": _FakeClient(), "s:0": ConnectionRefusedError("down")})
    snap = tw.tick()
    [row] = [t for t in snap["targets"] if t["addr"] == "s:0"]
    assert row["gap"] == "ConnectionRefusedError"
    assert tw.stats()["gaps"] == 1
    assert snap["anomalies"] == []


def test_scaling_advice_add_replica_on_sustained_shed(tmp_path, monkeypatch):
    svc0, svc1 = _FakeClient(), _FakeClient()
    tw = _Twin(tmp_path, monkeypatch,
               {"r:0": _FakeClient(), "s:0": svc0, "s:1": svc1},
               z_threshold=1e9)  # isolate the advice path
    shed = {"hot_admitted": 0, "shed": 0}
    for i in range(8):  # sustained shedding on shard 0 only
        shed = {"hot_admitted": shed["hot_admitted"] + 10,
                "shed": shed["shed"] + 5}
        svc0.stats_doc = shed
        svc1.stats_doc = {"hot_admitted": (i + 1) * 10}
        snap = tw.tick()
    advice = [a for a in snap["advice"] if a["advice"] == "add_replica"]
    assert advice == [] or advice[0]["shard"] == 0
    fired = [a for row in tw.ring() for a in row["advice"]
             if a["advice"] == "add_replica"]
    assert len(fired) == 1  # edge-triggered: once per cooldown window
    assert fired[0]["shard"] == 0 and fired[0]["shed_rate"] > 0.5


def test_observer_stats_shape(tmp_path, monkeypatch):
    tw = _Twin(tmp_path, monkeypatch, {"r:0": _FakeClient()})
    tw.tick()
    st = tw.stats()
    assert st["scrapes"] == 1 and st["endpoints"] == 1
    assert st["ring"]["appended"] == 1


# --- chaos grammar, settings, schema -----------------------------------------


def test_svc_scrape_gap_is_a_first_class_chaos_kind():
    assert "svc_scrape_gap" in KINDS
    assert OBSERVER_KINDS == ("svc_scrape_gap",)
    assert DEFAULT_PARAM["svc_scrape_gap"] is None
    [d] = parse_chaos("svc_scrape_gap:any@s7")
    assert (d.kind, d.seg_id) == ("svc_scrape_gap", 7)
    sched = ChaosSchedule([d])
    assert sched.take_kinds(0, 6, OBSERVER_KINDS) == []
    [hit] = sched.take_kinds(2, 7, OBSERVER_KINDS)  # any worker matches
    assert hit["kind"] == "svc_scrape_gap"
    assert sched.take_kinds(2, 7, OBSERVER_KINDS) == []  # one-shot


def _env_names(module) -> set[str]:
    src = Path(module.__file__).read_text()
    start = src.index("def from_env")
    body = src[start:src.index("return dataclasses.replace", start)]
    return set(re.findall(r'"(SIEVE_[A-Z0-9_]+)"', body))


BAD_OBSERVER_SETTINGS = [
    {"scrape_s": 0}, {"scrape_s": -1.0}, {"timeout_s": 0}, {"cooldown_s": -1.0},
    {"ring_bytes": 0}, {"ring_bytes": 1.5}, {"warmup": -1}, {"warmup": 2.5},
    {"alpha": 0.0}, {"alpha": 1.5}, {"z_threshold": -1.0}, {"min_delta": -0.1},
    {"observe_dir": 42},
]


@pytest.mark.parametrize("bad", BAD_OBSERVER_SETTINGS,
                         ids=[next(iter(b)) + str(i)
                              for i, b in enumerate(BAD_OBSERVER_SETTINGS)])
def test_observer_settings_validate_errors_equal_reference(bad):
    with pytest.raises(ValueError) as port_err:
        dataclasses.replace(ObserverSettings(), **bad).validate()
    with pytest.raises(ValueError) as ref_err:
        dataclasses.replace(ref_observe.ObserverSettings(), **bad).validate()
    assert str(port_err.value) == str(ref_err.value)


def test_observer_settings_fields_and_env_equal_reference(monkeypatch):
    good = ObserverSettings()
    assert good.validate() is good
    assert [(f.name, f.default) for f in dataclasses.fields(ObserverSettings)] == \
        [(f.name, f.default) for f in dataclasses.fields(ref_observe.ObserverSettings)]
    names = _env_names(port_observe)
    assert names == _env_names(ref_observe) and names
    monkeypatch.setenv("SIEVE_OBSERVE_SCRAPE_S", "0.25")
    monkeypatch.setenv("SIEVE_OBSERVE_Z", "9.5")
    monkeypatch.setenv("SIEVE_OBSERVE_WARMUP", "4")
    monkeypatch.setenv("SIEVE_OBSERVE_RING_BYTES", "65536")
    s = ObserverSettings.from_env(observe_dir="/tmp/x")
    assert (s.scrape_s, s.z_threshold, s.warmup, s.ring_bytes) == \
        (0.25, 9.5, 4, 65536)
    assert s.observe_dir == "/tmp/x"  # explicit override beats env
    assert dataclasses.asdict(s) == dataclasses.asdict(
        ref_observe.ObserverSettings.from_env(observe_dir="/tmp/x"))


def test_new_observatory_events_are_in_the_schema():
    for kind in ("service_exemplar_kept", "observer_scrape_gap",
                 "fleet_anomaly", "scaling_advice", "observer_error"):
        assert kind in EVENT_SCHEMA


def test_observatory_event_records_validate():
    validate_record({"event": "fleet_anomaly", "ts": 1.0, "addr": "h:1",
                     "signal": "err_rate", "value": 5.0, "mean": 0.0, "dev": 0.0,
                     "z": 1e6, "scrape": 9, "bundle": None})
    validate_record({"event": "observer_scrape_gap", "ts": 1.0, "addr": "h:1",
                     "scrape": 5, "gap": "svc_scrape_gap"})
    validate_record({"event": "scaling_advice", "ts": 1.0, "advice": "split",
                     "shard": 0, "qps": 10.0, "shed_rate": 0.0, "share": 0.7,
                     "scrape": 4})
    with pytest.raises(ValueError):
        validate_record({"event": "fleet_anomaly", "ts": 1.0})


# --- a live fabric: the observer and ``observe`` on the port's router --------


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("observe_src")
    ref_run_local(REF.cfg(str(root / "src")))
    return split_ledger(root / "src", root)


def test_live_fabric_scrapes_with_gap_rows(split, tmp_path):
    obs_dir = tmp_path / "obs"
    with Fabric(split, tmp_path, shard1_replicas=2) as f:
        targets = 1 + len(f.svcs)  # the router, then every replica
        spec = ",".join(f"svc_scrape_gap:{i}@s3" for i in range(targets))
        obs = port_observe.FleetObserver(
            f.router.addr, ObserverSettings(observe_dir=str(obs_dir), quiet=True,
                                            scrape_s=0.05),
            chaos=ChaosSchedule(parse_chaos(spec)))
        try:
            for k in range(5):
                assert f.cli.pi(1000 * (k + 1))
                obs.scrape_once()
        finally:
            obs.stop()
    rows = read_ring(str(obs_dir / RING_FILE))
    assert rows == ref_observe.read_ring(str(obs_dir / RING_FILE))
    assert [r["scrape"] for r in rows] == [1, 2, 3, 4, 5]
    addrs = [f.router.addr] + [s.addr for s in f.svcs]
    for r in rows:
        assert [t["addr"] for t in r["targets"]] == addrs
        assert r["anomalies"] == []  # nothing alarms, the gap least of all
        for t in r["targets"]:
            if r["scrape"] == 3:
                assert t["gap"] == "svc_scrape_gap" and "signals" not in t
            else:
                assert t["gap"] is None and set(t["signals"]) >= set(ANOMALY_SIGNALS)
    assert obs.stats()["gaps"] == targets


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_observe_cli_prints_the_reference_lines(split, tmp_path):
    with Fabric(split, tmp_path) as f:
        got = {}
        for name, main in (("ref", ref_cli.main), ("port", port_cli.main)):
            d = str(tmp_path / f"obs_{name}")
            got[name] = _lines(main, ["observe", "--router", f.router.addr,
                                      "--scrapes", "2", "--scrape-s", "0.05",
                                      "--observe-dir", d, "--quiet"])
            assert len(read_ring(os.path.join(d, RING_FILE))) == 2
    first, last = got["port"][0], got["port"][-1]
    assert (first["event"], last["event"]) == ("observing", "observed")
    assert last["scrapes"] == 2 and last["endpoints"] == 3 and last["gaps"] == 0
    assert [sorted(x) for x in got["port"]] == [sorted(x) for x in got["ref"]]
