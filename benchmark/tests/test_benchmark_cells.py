"""Each cell's whole run on the CPU at a tiny N (the kernels' plain
versions), the run broken underneath, and the run on the card."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness, spec

ROOT = Path(harness.__file__).resolve().parents[1]
CELLS = ["twins_1e11.local", "torch_twins_1e9.local"]
TINY_N = 10**6
U32 = 0xFFFFFFFF


def _cell(name):
    return spec.cell(spec.load(ROOT), name, ROOT)


def _run(name, traced=False, seconds=0.3, seed=2**40 + 11):
    return harness.run_cell(_cell(name), seed, seconds, traced,
                            time.perf_counter(), device="cpu", n=TINY_N)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_on_cpu(name, traced, capsys):
    result = _run(name, traced)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checked"
    assert all(v["value"] == 0 for v in result["checked"].values())
    cell = _cell(name)
    if traced:
        # the device-trace readers need the card; the others read here
        want = {m["name"] for m in cell.per_layer if m["source"] != "device_trace"}
    else:
        want = {m["name"] for m in cell.end_to_end}
    assert set(result["metrics"]) == want
    out = capsys.readouterr()
    assert "setup_parts " in out.out
    assert out.err.rstrip().splitlines()[-1].startswith("check pairs_err 0 limit 0")


def test_a_module_loaded_after_the_window_is_caught(tmp_path, monkeypatch, capsys):
    """A per-layer reader, loaded once the window has closed, that loads a
    module named ``sieve`` (a stub here): the run gives no result."""
    import shutil

    stub = tmp_path / "stub" / "sieve"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("STUB = True\n")
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "metrics" / "job_fixed_ms.py").write_text(
        "import sieve  # noqa: F401\n\nUNIT = 'ms'\nLAYER = 'job set-up and merge'\n"
        "MOVES = 'values_per_s'\n\n\ndef read(r):\n    return 1.0\n")
    monkeypatch.setattr(spec, "HERE", bench)
    monkeypatch.syspath_prepend(str(stub.parent))
    try:
        with pytest.raises(SystemExit) as e:
            _run(CELLS[0], traced=True)
        assert "sieve" in str(e.value)
    finally:
        sys.modules.pop("sieve", None)
    out = capsys.readouterr().out
    assert "setup_parts" not in out and "{" not in out


# --- the timed path broken underneath: each fault must read not correct ---

def _fault_kernel(kind, target):
    """A wrapper for the backend's device call that plants one fault:
    ``unchanged``: the segment comes back as it went in, nothing marked;
    ``half``: every second segment is left out and answered with the one
    before it (the rest's mean, for equal segments), or, where a job is
    one segment, its second half left out and the first half doubled; ``altered``: one
    count is off by one where it is produced; ``word``: one bit of one
    edge word flips. ``target`` is the call altered: one in the window's
    first job, past the warm job's calls."""
    calls = {"n": 0, "last": None}

    def plant(vals, nbits):
        i = calls["n"]
        calls["n"] += 1
        if kind == "unchanged":
            vals = [nbits, nbits - 1, U32, U32]
        elif kind == "half" and i % 2 and calls["last"] is not None:
            vals = list(calls["last"])
        elif kind == "altered" and i == target:
            vals = [vals[0] + 1] + list(vals[1:])
        elif kind == "word" and i == target:
            vals = list(vals[:3]) + [vals[3] ^ (1 << 31)]
        calls["last"] = vals
        return vals
    return plant


@pytest.fixture(params=["unchanged", "half", "altered", "word"])
def fault(request):
    return request.param


@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_reads_not_correct(name, fault, monkeypatch):
    import sieve_torch.backends.cuda as cuda_backend
    import sieve_torch.backends.torch_words as torch_words

    segments = int(_cell(name).traffic["segments"])
    plant = _fault_kernel(fault, segments + segments // 2)
    if name.startswith("torch_") and fault == "half":
        # one segment a job: its second half left out, the first doubled
        real = torch_words.mark_words

        def halved(*a, **k):
            a = list(a)
            a[3] //= 2
            count, pairs, first, last = real(*a, **k).tolist()
            return torch.tensor([2 * count, 2 * pairs, first, last])
        monkeypatch.setattr(torch_words, "mark_words", halved)
    elif name.startswith("torch_"):
        real = torch_words.mark_words
        monkeypatch.setattr(torch_words, "mark_words", lambda *a, **k: torch.tensor(
            plant(real(*a, **k).tolist(), a[3]), dtype=torch.int64))
    else:
        real = cuda_backend.mark_cuda
        monkeypatch.setattr(cuda_backend, "mark_cuda", lambda seg, k, device: tuple(
            plant(list(real(seg, k, device=device)), seg.nbits)))
    result = _run(name, seconds=0.5)
    assert not result["correct"]
    assert any(v["value"] is None or v["value"] > 0
               for v in result["checked"].values())


# --- the command itself ---

def _command(workload, cwd, seconds=2, trace=0, seed=7):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed",
         str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=900)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command runs there")
    proc = _command(CELLS[0], ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA card" in proc.stderr


def test_command_fails_without_the_program(tmp_path):
    """In a folder holding only BENCHMARK.json and the benchmark's own
    files, the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(CELLS[0], tmp_path)
    assert proc.returncode != 0
    assert not proc.stdout.strip().startswith("{")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_command_on_the_card(name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = _command(name, ROOT, seconds=3, trace=trace)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-2].startswith("setup_parts ")
    result = json.loads(lines[-1])
    assert result["correct"], result["checked"]
    assert result["device"]["platform"] == "gpu"
    cell = _cell(name)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in want}
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
