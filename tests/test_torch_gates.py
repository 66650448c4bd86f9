"""The port's static gates (``sieve_torch/tools/check_*.py``) against the
reference's (``tools/check_*.py``).

  - ``check_all --device cpu`` passes on the port, one ``ok`` line per
    check; ``--device cuda`` without a card fails, and the wire check's
    live leg and every smoke raise instead of running on the CPU;
  - the concurrency gate is clean against an empty baseline;
  - the env-var checker's two rules (no raw ``SIEVE_*`` reads outside
    ``sieve_torch/env.py``; every name in README.md) hold on the port and
    catch planted sources, as the reference's do
    (tests/test_concurrency.py:118-150);
  - the event-schema check is clean and catches a planted kind
    (tests/test_debug.py:418-441);
  - the wire check's static leg finds no drift, the port's server and
    router handle the reference's ops and message types, and its live
    leg's replies (v1 and v2, 13 probes and their batch) equal the
    reference server's on the same probes;
  - each smoke asserts the observed lock orders before its banner (the
    counterpart of test_concurrency.py:220).
"""

import ast
import json
import os
import tempfile
from pathlib import Path

import pytest
import torch

from sieve_torch.tools import (
    chaos_smoke,
    check_all,
    check_concurrency,
    check_env_vars,
    check_event_schema,
    check_wire_ops,
    service_smoke,
    store_smoke,
)

REPO = Path(__file__).resolve().parent.parent
SMOKES = {"service_smoke": "SERVICE_SMOKE_OK", "chaos_smoke": "CHAOS_SMOKE_OK",
          "store_smoke": "STORE_SMOKE_OK"}


def test_check_all_passes_on_cpu(capsys):
    assert check_all.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    for name in ("wire_ops", "event_schema", "concurrency", "env_vars"):
        assert f"check_all: {name}: ok" in out
    assert out[-1] == "check_all: ok (4 checks)"


def test_cuda_without_a_card_fails_and_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert check_all.main(["--device", "cuda"]) == 1
    assert "check_all: wire_ops: FAILED (2)" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_wire_ops.main([])  # the default is the card
    for smoke in (service_smoke, chaos_smoke, store_smoke):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            smoke.main([])


def test_concurrency_gate_is_clean_against_an_empty_baseline():
    new, stale = check_concurrency.check()
    assert new == [] and stale == []
    assert check_concurrency.load_baseline() == set()
    assert check_concurrency.main([]) == 0


def test_concurrency_dump_lists_the_kernel_library_locks(capsys):
    assert check_concurrency.main(["--dump"]) == 0
    out = capsys.readouterr().out
    assert "  build._lock\n" in out and "  cpu_native._lock\n" in out
    assert "== 0 findings ==" in out


# --- env-var discipline ------------------------------------------------------


def test_env_vars_check_is_clean():
    problems, names = check_env_vars.scan()
    assert problems == []
    assert check_env_vars.undocumented(names) == []
    assert "SIEVE_LOCK_DEBUG" in names
    assert "SIEVE_CLUSTER_WORKER_BACKEND" in names


def test_env_vars_check_catches_raw_reads():
    src = (
        "import os\n"
        "a = os.environ.get('SIEVE_FAKE_A')\n"
        "b = os.environ['SIEVE_FAKE_B']\n"
        "c = os.getenv('SIEVE_FAKE_C', '1')\n"
        # writes are legal: defaults for children, child-env dicts
        "os.environ.setdefault('SIEVE_FAKE_D', '1')\n"
        "os.environ['SIEVE_FAKE_E'] = '1'\n"
        "wenv = {**os.environ, 'SIEVE_FAKE_F': '1'}\n"
    )
    sc = check_env_vars._Scanner("fake.py")
    sc.visit(ast.parse(src))
    assert sorted(n for _, n in sc.raw_reads) == [
        "SIEVE_FAKE_A", "SIEVE_FAKE_B", "SIEVE_FAKE_C"
    ]


def test_env_vars_rules_on_a_planted_tree(tmp_path, monkeypatch, capsys):
    """env.py may read raw, any other module may not; chip_smoke.py is
    scanned too; every literal name must be in the README."""
    pkg = tmp_path / "sieve_torch"
    pkg.mkdir()
    (pkg / "env.py").write_text("import os\nv = os.environ.get('SIEVE_OK_A')\n")
    (pkg / "rogue.py").write_text("import os\nv = os.getenv('SIEVE_BAD_B')\n")
    (tmp_path / "chip_smoke.py").write_text(
        "import os\nv = os.environ['SIEVE_BAD_C']\n")
    (tmp_path / "README.md").write_text("SIEVE_OK_A SIEVE_BAD_B\n")
    monkeypatch.setattr(check_env_vars, "REPO", str(tmp_path))
    monkeypatch.setattr(check_env_vars, "README", str(tmp_path / "README.md"))
    problems, names = check_env_vars.scan()
    assert names == {"SIEVE_OK_A", "SIEVE_BAD_B", "SIEVE_BAD_C"}
    assert problems == [
        "chip_smoke.py:2: raw read of SIEVE_BAD_C — go through sieve_torch.env "
        "(env_int/env_float/env_str/env_flag/env_items)",
        f"{os.path.join('sieve_torch', 'rogue.py')}:2: raw read of SIEVE_BAD_B — go "
        "through sieve_torch.env (env_int/env_float/env_str/env_flag/env_items)",
    ]
    assert check_env_vars.undocumented(names) == ["SIEVE_BAD_C"]
    assert check_env_vars.main([]) == 1
    err = capsys.readouterr().err
    assert "README.md: SIEVE_BAD_C is not documented" in err
    assert "FAILED (3 problem(s))" in err


# --- event schema ------------------------------------------------------------


def test_event_schema_check_is_clean_on_the_port():
    assert check_event_schema.missing_kinds(str(REPO)) == []
    assert check_event_schema.main([str(REPO)]) == 0


def test_event_schema_check_catches_undocumented_kind(tmp_path):
    pkg = tmp_path / "sieve_torch"
    pkg.mkdir()
    (pkg / "rogue.py").write_text(
        'class X:\n'
        '    def f(self):\n'
        '        self.metrics.event(\n'
        '            "bogus_kind_xyz", a=1)\n'
        '        validate_record({"event": "other_bogus_kind"})\n'
    )
    bad = check_event_schema.missing_kinds(str(tmp_path))
    assert {k for _, _, k in bad} == {"bogus_kind_xyz", "other_bogus_kind"}
    path, line, _ = bad[0]
    assert path == os.path.join("sieve_torch", "rogue.py") and line == 3
    assert check_event_schema.main([str(tmp_path)]) == 1


# --- wire ops ----------------------------------------------------------------


def test_wire_check_static_leg_finds_no_drift():
    from tools import check_wire_ops as ref

    assert check_wire_ops.check() == []
    for side in ("server", "router"):
        got = check_wire_ops.harvest(str(REPO / "sieve_torch" / "service" / f"{side}.py"))
        want = ref.harvest(str(REPO / "sieve" / "service" / f"{side}.py"))
        assert got == want, side
    assert "profile" in got[1] and "batch" in got[0]
    assert check_wire_ops._ENCODING_PROBES == ref._ENCODING_PROBES


def _reference_replies() -> dict:
    """The reference's check_encodings leg (tools/check_wire_ops.py), its
    replies kept: a cpu-numpy n=2,000 ledger served by the reference."""
    from sieve.config import SieveConfig
    from sieve.coordinator import run_local
    from sieve.service import ServiceClient, ServiceSettings, SieveService
    from tools.check_wire_ops import _ENCODING_PROBES, _strip

    out = {"v1": [], "v2": []}
    with tempfile.TemporaryDirectory(prefix="wire_enc_ref_") as tmp:
        cfg = SieveConfig(n=2_000, backend="cpu-numpy", packing="wheel30",
                          n_segments=2, quiet=True, checkpoint_dir=tmp)
        run_local(cfg)
        settings = ServiceSettings(workers=2, queue_limit=16,
                                   default_deadline_s=10.0, refresh_s=0.0)
        with SieveService(cfg, settings) as svc:
            with ServiceClient(svc.addr, timeout_s=30, negotiate=False) as v1, \
                    ServiceClient(svc.addr, timeout_s=30, negotiate=True) as v2:
                out["wire_v"] = v2.wire_v
                for probe in _ENCODING_PROBES:
                    out["v1"].append(_strip(v1.query(**probe)))
                    out["v2"].append(_strip(v2.query(**probe)))
                items = [dict(p) for p in _ENCODING_PROBES]
                out["batch_v1"] = v1.query_batch(items)
                out["batch_v2"] = v2.query_batch(items)
    return out


def _canon(x) -> str:
    return json.dumps(x, sort_keys=True)


def test_wire_check_live_leg_equals_the_reference():
    got = check_wire_ops.encoding_replies("cpu")
    want = _reference_replies()
    assert got["wire_v"] == want["wire_v"] == 2
    assert got["launches"] == 0 and got["device"] == "cpu"
    for key in ("v1", "v2", "batch_v1", "batch_v2"):
        assert _canon(got[key]) == _canon(want[key]), key
    assert len(got["v1"]) == 13
    assert check_wire_ops.check_encodings(got) == []
    # a reply that differs between the encodings is named
    bad = dict(got, v2=[dict(got["v2"][0], value=-1)] + got["v2"][1:])
    problems = check_wire_ops.check_encodings(bad)
    assert len(problems) == 1 and problems[0].startswith(
        "encoding divergence on {'op': 'pi', 'x': 2}")


# --- the smokes are the dynamic half of the concurrency gate ------------------


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_smoke_scripts_assert_lock_orders(name):
    """Each smoke calls ``_assert_lock_orders()`` (the shared
    ``assert_lock_orders``, under the reference's name) before its success
    banner, and that runs the sanitizer's consistency check."""
    src = (REPO / "sieve_torch" / "tools" / f"{name}.py").read_text()
    assert "assert_lock_orders as _assert_lock_orders," in src
    body = src[src.index("def _run"):]
    assert body.index("_assert_lock_orders()") < body.index(f'print("{SMOKES[name]}"')
    shared = (REPO / "sieve_torch" / "tools" / "__init__.py").read_text()
    helper = shared[shared.index("def assert_lock_orders"):]
    assert "check_static_consistency()" in helper
    assert 'env_flag("SIEVE_LOCK_DEBUG")' in helper
