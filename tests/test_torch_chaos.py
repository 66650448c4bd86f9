"""The port's chaos grammar against the reference's (sieve/chaos.py).

Every schedule parses to equal directives in both packages, bad ones fail
with the same message, the schedule's ``take`` is one-shot in both, and
the config merges the legacy ``chaos_kill`` and rejects bad grammar when
it is built, as the reference's does (tests/test_chaos.py:77-124).
"""

import dataclasses

import pytest

from sieve import chaos as ref
from sieve.config import SieveConfig as RefConfig
from sieve_torch import chaos
from sieve_torch.config import SieveConfig


def _plain(directives):
    return [dataclasses.astuple(d) for d in directives]


def test_tables_match_reference():
    assert chaos.KINDS == ref.KINDS
    assert chaos.DEFAULT_PARAM == ref.DEFAULT_PARAM
    assert chaos.ANY_WORKER == ref.ANY_WORKER
    assert chaos.LANE_PARAM_KINDS == ref.LANE_PARAM_KINDS


@pytest.mark.parametrize("spec", [
    "kill:1@s4,stall:2@s7:3.0,drop_hb:any@s9,disconnect:0@s2",
    "stall:0@s1",
    "kill:*@s0, disconnect:any@s3 ,",
    "svc_stall:any@s2:0.5,svc_shed:any@s3,backend_down:any@s4",
    "svc_flood:any@s1:hot,svc_flood:any@s2",
    "svc_batch_partial:any@s1:2,svc_shard_down:1@s5:2.5",
    "svc_refresh_corrupt:any@s1,replica_down:any@s2:0,svc_drain:any@s3",
    "svc_trace_drop:any@s1,svc_crash:any@s2,svc_slow_frame:any@s3:4",
    "store_torn_write:any@s2,svc_mesh_fail:any@s1,svc_scrape_gap:0@s1,"
    "svc_prof_gap:any@s9",
    "",
])
def test_grammar_parses_alike(spec):
    got, want = chaos.parse_chaos(spec), ref.parse_chaos(spec)
    assert _plain(got) == _plain(want)
    assert [d.to_wire() for d in got] == [d.to_wire() for d in want]


def test_grammar_values():
    ds = chaos.parse_chaos("kill:1@s4,stall:2@s7:3.0,drop_hb:any@s9,disconnect:0@s2")
    assert [(d.kind, d.worker, d.seg_id, d.param) for d in ds] == [
        ("kill", 1, 4, None),
        ("stall", 2, 7, 3.0),
        ("drop_hb", chaos.ANY_WORKER, 9, None),
        ("disconnect", 0, 2, 0.05),
    ]
    assert chaos.parse_chaos("stall:0@s1")[0].param == 1.0


@pytest.mark.parametrize("bad,match", [
    ("explode:0@s1", "unknown kind"),
    ("kill:0", "worker@s<seg>"),
    ("kill:x@s1", "worker must be an integer"),
    ("kill:-2@s1", "worker id must be >= 0"),
    ("kill:0@3", "segment must be written s<id>"),
    ("kill:0@s1:2.0", "kill takes no param"),
    ("stall:0@s1:abc", "param must be a number"),
    ("stall:0@s1:-1", "param must be >= 0"),
    ("svc_flood:any@s1:warm", "param must be a lane"),
    ("kill:0@s1:2:3", "expected kind:worker"),
])
def test_rejects_alike(bad, match):
    with pytest.raises(ValueError, match=match) as got:
        chaos.parse_chaos(bad)
    with pytest.raises(ValueError) as want:
        ref.parse_chaos(bad)
    assert str(got.value) == str(want.value)


def test_schedule_take_is_one_shot():
    spec = "kill:any@s2,stall:1@s2:0.5,kill:0@s5,kill:0@s5"
    for mod in (chaos, ref):
        sched = mod.ChaosSchedule(mod.parse_chaos(spec))
        assert sched.take(0, 1) == []
        got = sched.take(1, 2)  # matches both (any + worker 1)
        assert sorted(d["kind"] for d in got) == ["kill", "stall"]
        assert sched.take(1, 2) == []  # consumed: a reassignment runs fault-free
        assert sched.take(1, 5) == []
        assert sched.take(0, 5) == [{"kind": "kill", "param": None, "worker": 0}] * 2
        assert len(sched) == 0


@pytest.mark.parametrize("chaos_spec,kill", [
    ("stall:any@s3", "0@2"),
    (None, "any@7"),
    ("drop_hb:1@s1,disconnect:any@s4:0.2", None),
])
def test_config_merges_legacy_chaos_kill(chaos_spec, kill):
    kw = dict(n=10**5, chaos=chaos_spec, chaos_kill=kill)
    got = SieveConfig(backend="cpu-cluster", **kw).chaos_directives()
    want = RefConfig(backend="cpu-cluster", **kw).chaos_directives()
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("kw,match", [
    ({"chaos": "frob:0@s1"}, "unknown kind"),
    ({"chaos_kill": "3"}, "chaos_kill must be 'k@s'"),
    ({"chaos_kill": "x@2"}, "worker must be an integer"),
])
def test_config_rejects_bad_chaos_eagerly(kw, match):
    with pytest.raises(ValueError, match=match):
        SieveConfig(n=10**5, backend="cpu-cluster", **kw)
    with pytest.raises(ValueError, match=match):
        RefConfig(n=10**5, backend="cpu-cluster", **kw)


def test_service_routing_tuples_match_reference():
    """Which plane draws which kind: the five tuples are the reference's."""
    for name in ("SERVICE_KINDS", "SERVICE_REQUEST_KINDS",
                 "ROUTER_REQUEST_KINDS", "OBSERVER_KINDS", "PROFILE_KINDS"):
        assert getattr(chaos, name) == getattr(ref, name), name
    planes = (chaos.SERVICE_KINDS + chaos.ROUTER_REQUEST_KINDS
              + chaos.OBSERVER_KINDS + chaos.PROFILE_KINDS)
    assert set(chaos.SERVICE_REQUEST_KINDS) <= set(chaos.SERVICE_KINDS)
    assert set(planes) | {"kill", "stall", "drop_hb", "disconnect"} == set(chaos.KINDS)


def test_chaos_crash_and_extend():
    assert issubclass(chaos.ChaosCrash, RuntimeError)
    assert chaos.ChaosCrash.__mro__[1:] == ref.ChaosCrash.__mro__[1:]
    got = chaos.ChaosSchedule(chaos.parse_chaos("svc_shed:any@s1"))
    want = ref.ChaosSchedule(ref.parse_chaos("svc_shed:any@s1"))
    more = "svc_stall:any@s2:0.5,svc_prof_gap:any@s2"
    got.extend(chaos.parse_chaos(more))
    want.extend(ref.parse_chaos(more))
    assert len(got) == len(want) == 3
    # each plane draws only its own kinds, one-shot
    for sched in (got, want):
        assert sched.take_kinds(0, 2, chaos.PROFILE_KINDS) == [
            {"kind": "svc_prof_gap", "param": None, "worker": chaos.ANY_WORKER}]
    assert got.take_kinds(0, 2, chaos.SERVICE_REQUEST_KINDS) == \
        want.take_kinds(0, 2, ref.SERVICE_REQUEST_KINDS)
    assert got.take(7, 1) == want.take(7, 1)
    assert len(got) == len(want) == 0

