"""The port's tuned-file loader (sieve_torch/kernels/cuda_mark.py) and its
autotuner (``python -m sieve_torch.tools.autotune_kernel``) against the
reference's (sieve/kernels/pallas_mark.py ``_load_tuned``/``_knob``,
``tools/autotune_kernel.py``).

The port of test_fused_reduce.py's ``test_tuned_json_loader``: ``_meta``
filtered, an absent file means the defaults, each knob resolves as env
var > file > default, and the file's SIEVE_PALLAS_FUSED flips the
reduction mode unless the env var says otherwise. Beyond it: the TPU's
SIEVE_PALLAS_ROWS key is ignored (the CUDA tile is fixed), the default
file is the port's ``tuned_cuda.json``, never the TPU's ``tuned.json``,
every (env, file) case resolves as the reference's ``_knob`` does, and a
fresh interpreter loads a tuned file and sieves exactly with it. The
autotuner's ``--measure`` child runs on the CPU and gives the reference's
(count, pairs, first, last) for the same segment (Pallas in interpret
mode); a whole sweep on the CPU writes the winning knobs, which a fresh
run then loads.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import sieve.kernels.pallas_mark as pm
import sieve_torch.kernels.cuda_mark as cm
from sieve.kernels.jax_mark import TWIN_ADJ as REF_TWIN_ADJ
from sieve.seed import seed_primes as ref_seed_primes

REPO = Path(__file__).resolve().parent.parent


def test_tuned_json_loader(monkeypatch, tmp_path):
    path = tmp_path / "tuned_cuda.json"
    path.write_text(json.dumps(
        {"SIEVE_PALLAS_DMIN": 8192, "_meta": {"platform": "test"}}
    ))
    monkeypatch.setenv("SIEVE_TUNED_JSON", str(path))
    assert cm._load_tuned() == {"SIEVE_PALLAS_DMIN": 8192}  # _meta filtered
    monkeypatch.setenv("SIEVE_TUNED_JSON", str(tmp_path / "absent.json"))
    assert cm._load_tuned() == {}

    # resolution order: env var > tuned file > default
    monkeypatch.setattr(cm, "_TUNED", {"SIEVE_PALLAS_DMIN": 8192})
    monkeypatch.delenv("SIEVE_PALLAS_DMIN", raising=False)
    assert cm._knob("SIEVE_PALLAS_DMIN", 4096) == 8192
    monkeypatch.setenv("SIEVE_PALLAS_DMIN", "16384")
    assert cm._knob("SIEVE_PALLAS_DMIN", 4096) == 16384
    monkeypatch.setattr(cm, "_TUNED", {})
    monkeypatch.delenv("SIEVE_PALLAS_DMIN", raising=False)
    assert cm._knob("SIEVE_PALLAS_DMIN", 4096) == 4096

    # the fused toggle honors the tuned file too, with env winning
    monkeypatch.setattr(cm, "_TUNED", {"SIEVE_PALLAS_FUSED": "0"})
    monkeypatch.delenv("SIEVE_PALLAS_FUSED", raising=False)
    assert cm.fused_enabled() is False
    monkeypatch.setenv("SIEVE_PALLAS_FUSED", "1")
    assert cm.fused_enabled() is True


def test_tpu_rows_key_is_ignored(monkeypatch, tmp_path):
    """A file written for the TPU's tile size leaves the port untouched."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"SIEVE_PALLAS_ROWS": 256, "SIEVE_PALLAS_DMIN": 8192,
                                "_meta": {"platform": "tpu"}}))
    monkeypatch.setenv("SIEVE_TUNED_JSON", str(path))
    assert cm._load_tuned() == {"SIEVE_PALLAS_DMIN": 8192}
    assert cm.R_ROWS == 128 and cm.TILE_WORDS == 128 * 128


def test_default_file_is_the_ports_own(monkeypatch, tmp_path):
    """Unset SIEVE_TUNED_JSON reads tuned_cuda.json at the repository's
    root; the TPU's tuned.json beside it is never read."""
    assert cm.TUNED_FILE == REPO / "tuned_cuda.json"
    monkeypatch.delenv("SIEVE_TUNED_JSON", raising=False)
    (tmp_path / "tuned.json").write_text(json.dumps({"SIEVE_PALLAS_DMIN": 8192}))
    monkeypatch.setattr(cm, "TUNED_FILE", tmp_path / "tuned_cuda.json")
    assert cm._load_tuned() == {}
    cm.TUNED_FILE.write_text(json.dumps({"SIEVE_PALLAS_FLAT_MIN": 1 << 24}))
    assert cm._load_tuned() == {"SIEVE_PALLAS_FLAT_MIN": 1 << 24}


@pytest.mark.parametrize("name, default", [("SIEVE_PALLAS_DMIN", 4096),
                                           ("SIEVE_PALLAS_FLAT_MIN", 0)])
@pytest.mark.parametrize("env_val, file_val", [(None, None), (None, 8192),
                                               ("16384", None), ("16384", 8192),
                                               ("0", 1 << 22)])
def test_knob_resolves_as_reference(monkeypatch, name, default, env_val, file_val):
    tuned = {} if file_val is None else {name: file_val}
    monkeypatch.setattr(pm, "_TUNED", tuned)
    monkeypatch.setattr(cm, "_TUNED", dict(tuned))
    if env_val is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, env_val)
    assert cm._knob(name, default) == pm._knob(name, default)


@pytest.mark.parametrize("env_val, file_val", [(None, None), (None, "0"), ("1", "0"),
                                               ("0", None), ("0", "1")])
def test_fused_toggle_resolves_as_reference(monkeypatch, env_val, file_val):
    tuned = {} if file_val is None else {"SIEVE_PALLAS_FUSED": file_val}
    monkeypatch.setattr(pm, "_TUNED", tuned)
    monkeypatch.setattr(cm, "_TUNED", dict(tuned))
    if env_val is None:
        monkeypatch.delenv("SIEVE_PALLAS_FUSED", raising=False)
    else:
        monkeypatch.setenv("SIEVE_PALLAS_FUSED", env_val)
    assert cm.fused_enabled() is pm.pallas_fused_enabled()


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and not k.startswith("SIEVE_PALLAS_")}
    return {**env, "OMP_NUM_THREADS": "1", **extra}


_LOADED = """
import json
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.kernels import cuda_mark as c
res = run_local(SieveConfig(n=3 * 10**6, device="cpu", twins=True, quiet=True,
                            n_segments=3))
print(json.dumps({"D_MIN": c.D_MIN, "flat": c._flat_cutoff(c.TILE_WORDS),
                  "fused": c.fused_enabled(), "pi": res.pi, "twins": res.twin_pairs}))
"""


def test_fresh_interpreter_loads_the_file_and_stays_exact(tmp_path):
    path = tmp_path / "tuned_cuda.json"
    path.write_text(json.dumps({"SIEVE_PALLAS_DMIN": 16384,
                                "SIEVE_PALLAS_FLAT_MIN": 1 << 22,
                                "SIEVE_PALLAS_FUSED": "0", "SIEVE_PALLAS_ROWS": 64}))
    proc = subprocess.run([sys.executable, "-c", _LOADED], cwd=REPO,
                          env=_env(SIEVE_TUNED_JSON=str(path)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"D_MIN": 16384, "flat": 1 << 22, "fused": False,
                   "pi": 216_816, "twins": 20_932}


def test_measure_child_matches_reference_on_cpu():
    """One trial as the sweep runs it, on the CPU, at a span with group D
    live; its result equals the reference's fused kernel in interpret
    mode on the same segment."""
    span, lo = 200_000, 10**8
    proc = subprocess.run(
        [sys.executable, "-m", "sieve_torch.tools.autotune_kernel", "--measure",
         str(span), str(lo), "--device", "cpu"],
        cwd=REPO, env=_env(SIEVE_TUNED_JSON=os.devnull, SIEVE_PALLAS_DMIN="8192"),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["seconds"] > 0
    ps = pm.prepare_pallas("odds", lo, lo + span,
                           ref_seed_primes(int((lo + span - 1) ** 0.5)))
    assert pm.spec_counts(ps)["D"] > 0
    want = pm.mark_pallas_fused(ps, REF_TWIN_ADJ, True)
    assert got["result"] == [int(v) for v in want]


def test_cpu_sweep_writes_knobs_a_fresh_run_loads(tmp_path):
    path = tmp_path / "tuned_cuda.json"
    proc = subprocess.run(
        [sys.executable, "-m", "sieve_torch.tools.autotune_kernel", "1e5",
         "--device", "cpu"],
        cwd=REPO, env=_env(SIEVE_TUNED_JSON=str(path)),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "REJECTED" not in proc.stdout
    doc = json.loads(path.read_text())
    meta = doc.pop("_meta")
    assert set(doc) == {"SIEVE_PALLAS_DMIN", "SIEVE_PALLAS_FLAT_MIN"}
    assert doc["SIEVE_PALLAS_DMIN"] in (4096, 8192, 16384)
    assert doc["SIEVE_PALLAS_FLAT_MIN"] in (0, 1 << 22, 1 << 24, 1 << 26)
    assert meta["platform"] == "cpu" and meta["span"] == 10**5
    assert len(meta["trials"]) == 6  # the baseline, then 2 + 3 coordinates
    assert meta["best_ms"] == round(min(t["ms"] for t in meta["trials"]), 4)
    assert f"wrote {path}" in proc.stdout
    loaded = subprocess.run([sys.executable, "-c", _LOADED], cwd=REPO,
                            env=_env(SIEVE_TUNED_JSON=str(path)),
                            capture_output=True, text=True, timeout=120)
    assert loaded.returncode == 0, loaded.stderr
    got = json.loads(loaded.stdout.strip().splitlines()[-1])
    assert got["D_MIN"] == doc["SIEVE_PALLAS_DMIN"]
    assert (got["pi"], got["twins"]) == (216_816, 20_932)
