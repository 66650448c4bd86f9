"""BENCHMARK.json against the benchmark's contract, and every piece found
by name: a new configuration, mix and per-layer metric are new files and
entries, with no edit to a file that is there."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import spec

ROOT = Path(spec.__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = spec.load(ROOT)


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"] and len(SPEC["command"]) <= 32
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells fits the driver's 43,200 s
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for c in SPEC["configs"]:
        assert 1 <= len(c["source"]) <= 200 and c["file"].startswith("benchmark/")


def test_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(w):
    cell = spec.cell(SPEC, w["name"], ROOT)
    assert cell.chips == 1
    for key in ("n", "backend", "packing", "count_kind", "source", "assumed", "reduced"):
        assert key in cell.config
    assert cell.traffic["entry"] in ("run_mesh", "run_local")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_every_reader_declares_its_entry(m):
    r = spec.reader(m["name"])
    assert (r.UNIT, r.LAYER, r.MOVES) == (m["unit"], m["layer"], m["moves"])


def test_adding_a_cell_is_adding_files(tmp_path):
    """A copy of the benchmark with a new configuration, mix and metric as
    new files and new entries runs its new cell with no other change."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "benchmark/configs/primes_1e7.json").write_text(json.dumps(
        {"n": 10**7, "backend": "cuda", "packing": "odds", "count_kind": "primes",
         "source": "test", "assumed": [], "reduced": []}))
    (tmp_path / "benchmark/traffic/r4.json").write_text(json.dumps(
        {"entry": "run_mesh", "rounds": 4, "loop": "closed", "clients": 1}))
    (tmp_path / "benchmark/metrics/rounds_per_job.py").write_text(
        'UNIT = "1"\nLAYER = "rounds path"\nMOVES = "values_per_s.r4"\n\n'
        'def read(r):\n    return r.spans["round.stack"][1] / r.jobs\n')
    doc["configs"].append({"name": "primes_1e7", "source": "test", "why": "test",
                           "file": "benchmark/configs/primes_1e7.json", "reduced": []})
    doc["workloads"].append({"name": "primes_1e7.r4", "config": "primes_1e7",
                             "traffic": "r4", "chips": 1, "why": "test"})
    doc["end_to_end"].append({"name": "values_per_s.r4", "unit": "values/s",
                              "better": "higher", "bound": 0.05, "source": "host_clock",
                              "workloads": ["primes_1e7.r4"]})
    doc["per_layer"].append({"name": "rounds_per_job", "unit": "1", "better": "lower",
                             "source": "program_span", "layer": "rounds path",
                             "moves": "values_per_s.r4", "workloads": ["primes_1e7.r4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    code = (
        "import sys, time; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "from pathlib import Path\n"
        "from benchmark import harness, spec\n"
        "root = Path(sys.argv[1])\n"
        "c = spec.cell(spec.load(root), 'primes_1e7.r4', root)\n"
        "u = harness.run_cell(c, 3, 0.2, False, time.perf_counter(), device='cpu')\n"
        "r = harness.run_cell(c, 3, 0.2, True, time.perf_counter(), device='cpu')\n"
        "print(u['correct'], sorted(u['metrics']), r['correct'],\n"
        "      r['metrics']['rounds_per_job']['value'])\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(ROOT)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == (
        "True ['setup_s', 'values_per_s.r4'] True 4.0")
