"""The port's benchmark (sieve_torch/bench.py), its device lines and its
``main``, on the CPU at small sizes (the service lines are in
tests/test_torch_bench_service.py).

  - each line's keys and unit equal those of the reference's line of the
    same name (``_pallas`` read as ``_cuda``) in BENCH_r14.json's tail; the
    depth line, which no record holds, has the keys of bench.py's depth
    line; the cold-drain line adds only ``device``, as the port's smoke
    does;
  - line 4's parity tuple equals the reference's ``mark_pallas_fused`` in
    interpret mode on the same segment, and its byte counts follow the
    formula of the module docstring;
  - line 2's device result on a small deep segment (the full seed set)
    equals the reference's ``CpuNumpyWorker``; on ``--device cpu`` the line
    is skipped unless SIEVE_BENCH_DEPTH=1, on ``--device cuda`` without a
    card it raises;
  - ``main`` runs the reference's 15 calls in its order, exits 1 and
    prints no line when the mesh smoke fails or the card is missing;
  - no number of the reference's TPU runs is in the port's bench.
"""

import ast
import json
import math
from pathlib import Path

import pytest
import torch

from sieve.backends.cpu_numpy import CpuNumpyWorker as RefCpuNumpyWorker
from sieve.config import SieveConfig as RefConfig
from sieve.kernels.jax_mark import TWIN_ADJ as REF_TWIN_ADJ
from sieve.kernels.pallas_mark import mark_pallas_fused, prepare_pallas
from sieve.seed import seed_primes as ref_seed_primes
from sieve_torch import bench
from sieve_torch.kernels.cuda_mark import TILE_WORDS, prepare_cuda
from sieve_torch.seed import seed_primes

REPO = Path(__file__).resolve().parent.parent
# bench.py's depth line (bench.py:175-184): no BENCH record holds it
DEPTH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def _reference_lines() -> dict:
    doc = json.loads((REPO / "BENCH_r14.json").read_text())
    out = {}
    for line in doc["tail"].splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if "metric" in rec:
                out[rec["metric"]] = rec
    return out


REF_LINES = _reference_lines()


def assert_reference_shape(rec: dict, extra: frozenset = frozenset()) -> None:
    """``rec`` has the keys and unit of the reference's line of its name."""
    name = rec["metric"].replace("_cuda", "_pallas")
    want = REF_LINES[name]
    assert set(rec) == set(want) | extra, name
    assert rec["unit"] == want["unit"]
    assert isinstance(rec["value"], (int, float)) and rec["value"] > 0


def test_shallow_line(capsys):
    rec = bench.shallow_metric(device="cpu", n=4_000_000)
    assert rec["metric"] == "sieve_throughput_pi_1e9_odds_cuda"
    assert_reference_shape(rec)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec


def test_depth_result_equals_reference_numpy_worker():
    lo, hi = 10**12 - 2 * 10**5, 10**12 + 1
    worker, seeds, got, cpu_s = bench.depth_parity("cpu", lo, hi)
    assert seeds.size == 78_498 and cpu_s > 0
    assert worker.host_segments == 0  # the fused kernel's path, not the host
    want = RefCpuNumpyWorker(RefConfig(n=10**12, backend="cpu-numpy", packing="odds",
                                       twins=True, quiet=True)).process_segment(
        lo, hi, ref_seed_primes(math.isqrt(hi - 1)))
    for f in bench.SEGMENT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_depth_line_skipped_on_cpu_unless_forced(monkeypatch, capsys):
    monkeypatch.delenv("SIEVE_BENCH_DEPTH", raising=False)
    assert bench.depth_metric(device="cpu") is None
    got = capsys.readouterr()
    assert got.out == "" and "depth metric skipped" in got.err
    monkeypatch.setenv("SIEVE_BENCH_DEPTH", "1")
    rec = bench.depth_metric(device="cpu", lo=10**12 - 10**5, reps=1)
    assert set(rec) == DEPTH_KEYS
    assert rec["metric"] == "sieve_throughput_depth_1e12_odds_cuda"
    assert rec["unit"] == "values/s/chip" and rec["vs_baseline"] > 0


def test_device_lines_without_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SIEVE_BENCH_DEPTH", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.shallow_metric(device="cuda", n=10**5)
    # the depth line never skips on the card's device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.depth_metric(device="cuda", lo=10**12 - 10**5)


def test_host_prepare_line():
    rec = bench.host_prepare_metric(device="cpu", span=10**6, k=3, mesh_n=2_000_000,
                                    mesh_rounds=2)
    assert rec["metric"] == "host_prepare_throughput_odds_cuda"
    assert_reference_shape(rec)
    assert 0 <= rec["device_idle_frac"] <= 1


def test_fused_reduction_line_matches_pallas_in_interpret_mode():
    lo, hi = 2_000_003, 4_000_001
    rec = bench.fused_reduction_metric(device="cpu", lo=lo, hi=hi)
    assert_reference_shape(rec)
    ps = prepare_pallas("odds", lo, hi, ref_seed_primes(math.isqrt(hi - 1)))
    want = mark_pallas_fused(ps, REF_TWIN_ADJ, True)
    assert rec["parity"] == [int(v) for v in want]
    # the formula: the tables and lists are read by both paths; the split
    # path adds the bitset twice, the fused path the per-tile cursors, a
    # 32-byte partial per block written and read again, the 16-byte result
    seg = prepare_cuda("odds", lo, hi, seed_primes(math.isqrt(hi - 1)))
    blocks = seg.Wpad // TILE_WORDS
    tables = rec["split_bytes"] - 2 * 4 * seg.Wpad
    assert rec["fused_bytes"] == tables + 2 * 4 * (blocks + 1) + 2 * 32 * blocks + 16
    assert rec["value"] == round(rec["fused_bytes"] / rec["split_bytes"], 4)
    assert rec["vs_baseline"] == round(0.55 * rec["split_bytes"] / rec["fused_bytes"], 3)


def test_cold_drain_line():
    rec = bench.service_cold_drain_throughput_metric(device="cpu")
    assert_reference_shape(rec, frozenset({"device"}))
    assert (rec["device"], rec["spmd_launches"]) == ("cpu", 1)


def test_failed_mesh_smoke_fails_main(monkeypatch, capsys):
    monkeypatch.setattr(bench, "COLD_SMOKE",
                        ["-c", "import sys; print('FAIL: injected'); sys.exit(1)"])
    monkeypatch.setattr(bench, "METRICS", (bench.service_cold_drain_throughput_metric,))
    assert bench.main(["--device", "cpu"]) == 1
    got = capsys.readouterr()
    assert got.out == ""
    assert "mesh cold smoke failed (rc=1)" in got.err and "FAIL: injected" in got.err


def test_main_without_card_fails_and_prints_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1  # --device cuda is the default
    got = capsys.readouterr()
    assert got.out == ""
    assert "bench: FAIL: shallow_metric" in got.err


def _reference_main_calls() -> list[str]:
    tree = ast.parse((REPO / "bench.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    return [s.value.func.id for s in main.body
            if isinstance(s, ast.Expr) and isinstance(s.value, ast.Call)]


def test_main_runs_the_reference_calls_in_order():
    calls = _reference_main_calls()
    assert len(calls) == 15
    assert [fn.__name__ for fn in bench.METRICS] == calls
    assert bench.DEVICE_METRICS < set(bench.METRICS)
    # 18 lines: the hot-qps item prints four
    assert len(REF_LINES) == 17  # the depth line is in no record


def test_no_tpu_number_in_the_port():
    src = (REPO / "sieve_torch" / "bench.py").read_text()
    assert "4.06e8" not in src and "v5e" not in src
