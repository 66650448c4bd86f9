"""The port's static concurrency analyzer against the reference's.

Both analyzers (``sieve_torch.analysis.{core,checks}`` and
``sieve.analysis.{core,checks}``) scan the same trees under the same
model data and must agree fact for fact:

  - on the four committed fixtures (tests/fixtures_concurrency: a clean
    package, a lock-order cycle, a blocking call on an event loop, an
    unguarded attribute) their findings are equal, key and text, and are
    the ones tests/test_concurrency.py pins for the reference;
  - on the reference tree ``sieve/`` with the reference's model data their
    lock ids, lock edges, thread roles and findings are equal;
  - on ``sieve_torch/`` with the port's model both report 0 findings, the
    port's lock graph is acyclic and every lock in it is listed;
  - every lock the port declares is built by a named constructor whose
    name is its identity, and is in the canonical order (the kernel
    libraries' ``build._lock`` and ``cpu_native._lock`` were plain
    ``threading.Lock()``s that SIEVE_LOCK_DEBUG never recorded); under
    SIEVE_LOCK_DEBUG=1 a served cold query on cpu-native records
    ``cpu_native._lock`` inside ``ColdBackend._lock``, consistent with
    the order.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from sieve.analysis import checks as ref_checks
from sieve.analysis import core as ref_core
from sieve.analysis import model as ref_model
from sieve_torch.analysis import checks, core, model

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "sieve_torch"
FIXTURES = REPO / "tests" / "fixtures_concurrency"

# the Model arguments tests/test_concurrency.py gives each fixture, and the
# finding keys it pins for the reference
FIXTURE_MODELS = {
    "fx_clean": (dict(canonical_lock_order=("W._a", "W._b"),
                      app_role_classes=frozenset({"W"})), None),
    "fx_cycle": (dict(canonical_lock_order=("C._a", "C._b"),
                      app_role_classes=frozenset({"C"})),
                 "lock-order:C._b->C._a@fx_cycle.app:C.backward"),
    "fx_loopblock": (dict(loop_roles=frozenset({"ev-loop"}),
                          blocking_calls=frozenset({"time.sleep"})),
                     "loop-blocking:ev-loop:fx_loopblock.app:Loop._tick:time.sleep"),
    "fx_unguarded": (dict(canonical_lock_order=("Worker._lock",),
                          app_role_classes=frozenset({"Worker"})),
                     "guard:Worker.count@fx_unguarded.app:Worker.bump"),
}


def _facts(findings):
    return [(f.kind, f.key, f.msg, f.where, str(f)) for f in findings]


def _model_kw(m) -> dict:
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)}


@pytest.mark.parametrize("name", sorted(FIXTURE_MODELS))
def test_fixture_findings_equal_the_reference(name):
    kw, pinned = FIXTURE_MODELS[name]
    root = str(FIXTURES / name)
    want = ref_checks.analyze(ref_core.scan(root, pkg=name), ref_model.Model(**kw))
    got = checks.analyze(core.scan(root, pkg=name), model.Model(**kw))
    assert _facts(got) == _facts(want)
    if pinned is None:
        assert got == []
    else:
        assert pinned in {f.key for f in got}


def test_fixture_roles_equal_the_reference():
    root = str(FIXTURES / "fx_loopblock")
    kw = dict(loop_roles=frozenset({"ev-loop"}))
    want = ref_checks.assign_roles(ref_core.scan(root, pkg="fx_loopblock"),
                                   ref_model.Model(**kw))
    got = checks.assign_roles(core.scan(root, pkg="fx_loopblock"), model.Model(**kw))
    assert got == want
    assert got["fx_loopblock.app:Loop._tick"] == {"ev-loop"}


@pytest.fixture(scope="module")
def reference_tree():
    """Both analyzers over sieve/ under the reference's model data."""
    root = str(REPO / "sieve")
    ref_prog = ref_core.scan(root, pkg="sieve", return_types=ref_model.RETURN_TYPES)
    prog = core.scan(root, pkg="sieve", return_types=ref_model.RETURN_TYPES)
    ref_m = ref_model.default_model()
    return ref_prog, prog, ref_m, model.Model(**_model_kw(ref_m))


def test_reference_tree_lock_ids_equal(reference_tree):
    ref_prog, prog, _, _ = reference_tree
    assert prog.lock_ids() == ref_prog.lock_ids()
    assert len(prog.lock_ids()) >= 40


def test_reference_tree_lock_edges_equal(reference_tree):
    ref_prog, prog, _, _ = reference_tree
    assert checks.lock_edges(prog) == ref_checks.lock_edges(ref_prog)
    assert checks.transitive_acquires(prog) == ref_checks.transitive_acquires(ref_prog)


def test_reference_tree_roles_equal(reference_tree):
    ref_prog, prog, ref_m, m = reference_tree
    got = checks.assign_roles(prog, m)
    assert got == ref_checks.assign_roles(ref_prog, ref_m)
    assert {"svc-wire", "router-accept", "app"} <= {r for rs in got.values() for r in rs}


def test_reference_tree_findings_equal(reference_tree):
    ref_prog, prog, ref_m, m = reference_tree
    assert _facts(checks.analyze(prog, m)) == _facts(ref_checks.analyze(ref_prog, ref_m))


def _port_program(scan=core.scan):
    return scan(str(PKG), pkg="sieve_torch", return_types=model.RETURN_TYPES)


def test_port_tree_has_no_findings_in_either_analyzer():
    m = model.default_model()
    assert [str(f) for f in checks.analyze(_port_program(), m)] == []
    ref_prog = _port_program(ref_core.scan)
    assert [str(f) for f in ref_checks.analyze(ref_prog, ref_model.Model(**_model_kw(m)))] == []


def test_port_lock_graph_is_acyclic_and_listed():
    edges = checks.lock_edges(_port_program())
    idx = {lk: i for i, lk in enumerate(model.CANONICAL_LOCK_ORDER)}
    assert edges  # the scan found the service plane's nestings
    for a, b in edges:
        assert a in idx, f"unlisted lock {a}"
        assert b in idx, f"unlisted lock {b}"
        assert idx[a] < idx[b], f"edge {a} -> {b} against canonical order"


def test_every_declared_lock_of_the_port_is_named_and_listed():
    prog = _port_program()
    decls = [d for c in prog.classes.values() for d in c.locks.values()]
    decls += [d for mod in prog.modules.values() for d in mod.locks.values()]
    assert len(decls) >= 45
    for d in decls:
        # the sanitizer's own pair-set mutex cannot record itself
        if d.lock_id != "_Recorder._mu":
            assert d.given_name == d.lock_id, f"{d.lock_id} is not a named lock"
        assert d.lock_id in model.CANONICAL_LOCK_ORDER, d.lock_id
    assert {"build._lock", "cpu_native._lock"} <= {d.lock_id for d in decls}


def test_port_model_is_the_references_under_port_names():
    ref_m, m = ref_model.default_model(), model.default_model()
    assert m.loop_roles == ref_m.loop_roles
    assert m.app_role_classes == ref_m.app_role_classes
    assert m.blocking_attrs == ref_m.blocking_attrs
    assert m.blocking_calls >= ref_m.blocking_calls
    renamed = tuple(p.replace("sieve.", "sieve_torch.", 1) for p in ref_m.blocking_prefixes)
    assert set(renamed) <= set(m.blocking_prefixes)
    # the port's own device dispatch blocks like the reference's ColdBackend's
    for extra in ("sieve_torch.kernels.build:", "sieve_torch.kernels.cuda_mark:"):
        assert extra in m.blocking_prefixes
    assert model.RETURN_TYPES == {k.replace("sieve.", "sieve_torch.", 1):
                                  v.replace("sieve.", "sieve_torch.", 1)
                                  for k, v in ref_model.RETURN_TYPES.items()}


_COLD_PROBE = """
import json, tempfile
from sieve_torch.analysis import lockdebug
from sieve_torch.config import SieveConfig
from sieve_torch.service import ServiceClient, ServiceSettings, SieveService
with tempfile.TemporaryDirectory() as tmp:
    cfg = SieveConfig(n=10**5, backend="cpu-native", device="cpu", n_segments=2,
                      quiet=True, checkpoint_dir=tmp)
    with SieveService(cfg, ServiceSettings(refresh_s=0.0)) as svc:
        with ServiceClient(svc.addr, timeout_s=30) as c:
            pi = c.pi(300_000)  # past the (empty) ledger: the cold plane
print(json.dumps({"pi": pi, "pairs": sorted(map(list, lockdebug.observed_pairs())),
                  "problems": lockdebug.check_static_consistency()}))
"""


def test_cpu_native_lock_is_recorded_under_the_cold_backend():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _COLD_PROBE], cwd=REPO,
                          env={**env, "SIEVE_LOCK_DEBUG": "1"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["pi"] == 25_997
    assert ["ColdBackend._lock", "cpu_native._lock"] in got["pairs"]
    assert got["problems"] == []
