"""The port's benchmark gate (sieve_torch/tools/bench_compare.py) against
the reference's (tools/bench_compare.py), on the CPU.

  - on every consecutive pair of the repository's own records
    (BENCH_r01..r14.json with MULTICHIP_r01..r14.json), copied alone into
    a directory, both ``main(["--dir", ...])`` give the same exit code and
    the same stdout and stderr; with no ``--dir`` both read the repository
    root;
  - the reference's gate cases (the p95, qps, wire-bytes, scaling-floor
    and cold-drain rules, metric disappearance, the newest round's rc,
    round order by suffix, a single round, the threshold flag) go through
    both ``compare`` (or ``main``) and give equal results, each with the
    verdict the reference's own tests require.
"""

import json
import shutil
from pathlib import Path

import pytest

from sieve_torch.tools import bench_compare as port
from tools import bench_compare as ref

REPO = Path(__file__).resolve().parent.parent
ROUNDS = sorted(int(p.stem.split("_r")[1]) for p in REPO.glob("BENCH_r*.json"))


def _both_mains(capsys, argv):
    out = []
    for mod in (ref, port):
        rc = mod.main(argv)
        got = capsys.readouterr()
        out.append((rc, got.out, got.err))
    return out


def test_records_are_there():
    assert ROUNDS == list(range(1, 15))
    assert all((REPO / f"MULTICHIP_r{r:02d}.json").exists() for r in ROUNDS)


@pytest.mark.parametrize("r", ROUNDS[:-1], ids=lambda r: f"r{r:02d}-r{r + 1:02d}")
def test_same_verdict_on_every_pair_of_records(r, tmp_path, capsys):
    for k in (r, r + 1):
        for prefix in ("BENCH", "MULTICHIP"):
            shutil.copy(REPO / f"{prefix}_r{k:02d}.json", tmp_path)
    (want, got) = _both_mains(capsys, ["--dir", str(tmp_path)])
    assert got == want
    assert f"bench_compare: round r{r:02d} -> r{r + 1:02d}" in got[1]


def test_default_dir_is_the_repository_root(capsys):
    assert Path(port.REPO) == REPO
    (want, got) = _both_mains(capsys, [])
    assert got == want
    assert f"round r{ROUNDS[-2]:02d} -> r{ROUNDS[-1]:02d}" in got[1]


def _rec(name, value, unit, **extra):
    return {name: {"metric": name, "value": value, "unit": unit, **extra}}


def _scaling(value, cpus, procs_max=4):
    return _rec("m", value, "scaling_ratio", cpus=cpus, procs_max=procs_max)


def _cold(value):
    return _rec("service_cold_drain_throughput", value, "cold_throughput",
                vs_baseline=1.4)


# (old, new, threshold, a word the first regression must hold or None for
# no regression): the cases of the reference's tests of its gate
GATE_CASES = {
    # tests/test_batch.py: >10% p95 increase fails, a decrease never does;
    # throughput keeps its downward gate
    "p95_up_20pct": (_rec("m", 10.0, "ms_p95"), _rec("m", 12.0, "ms_p95"), "p95"),
    "p95_up_5pct": (_rec("m", 10.0, "ms_p95"), _rec("m", 10.5, "ms_p95"), None),
    "p95_down": (_rec("m", 10.0, "ms_p95"), _rec("m", 7.0, "ms_p95"), None),
    "values_up": (_rec("m", 100.0, "values/s/chip"), _rec("m", 120.0, "values/s/chip"),
                  None),
    "values_down": (_rec("m", 100.0, "values/s/chip"), _rec("m", 80.0, "values/s/chip"),
                    "m"),
    # tests/test_wire.py: qps drops, the wire-bytes ceiling and growth
    "qps_down_20pct": (_rec("service_hot_qps", 50_000.0, "qps"),
                       _rec("service_hot_qps", 40_000.0, "qps"), "service_hot_qps"),
    "qps_down_4pct": (_rec("service_hot_qps", 50_000.0, "qps"),
                      _rec("service_hot_qps", 48_000.0, "qps"), None),
    "qps_up": (_rec("service_hot_qps", 50_000.0, "qps"),
               _rec("service_hot_qps", 65_000.0, "qps"), None),
    "bytes_first_round_over_ceiling": (
        {}, _rec("service_wire_bytes_per_member", 70.0, "bytes_per_member"), "48"),
    "bytes_first_round_under_ceiling": (
        {}, _rec("service_wire_bytes_per_member", 27.0, "bytes_per_member"), None),
    "bytes_growth": (_rec("service_wire_bytes_per_member", 27.0, "bytes_per_member"),
                     _rec("service_wire_bytes_per_member", 33.0, "bytes_per_member"),
                     "bytes/member"),
    "bytes_shrink": (_rec("service_wire_bytes_per_member", 27.0, "bytes_per_member"),
                     _rec("service_wire_bytes_per_member", 26.0, "bytes_per_member"),
                     None),
    # tests/test_store.py: the scaling floor, gated by cpus
    "scaling_below_floor": ({}, _scaling(0.4, cpus=8), "scaling floor"),
    "scaling_healthy": ({}, _scaling(0.85, cpus=8), None),
    "scaling_one_core": ({}, _scaling(0.2, cpus=1), None),
    # tests/test_mesh_cold.py: the cold-drain drop
    "cold_drain_halved": (_cold(2_000_000.0), _cold(1_000_000.0),
                          "service_cold_drain_throughput"),
    "cold_drain_up": (_cold(2_000_000.0), _cold(2_100_000.0), None),
    # tests/test_trace_plane.py: a metric that disappears
    "metric_gone": (_rec("sieve_throughput", 100.0, "values/s/chip"), {}, "disappeared"),
    # the absolute overhead ceilings: 1.05, and 1.10 for the lock sanitizer
    "overhead_over": ({}, _rec("service_trace_overhead_ratio", 1.06, "overhead_ratio"),
                      "1.05"),
    "lock_debug_under_its_ceiling": (
        {}, _rec("service_lock_debug_overhead_ratio", 1.08, "overhead_ratio"), None),
    "lock_debug_over_its_ceiling": (
        {}, _rec("service_lock_debug_overhead_ratio", 1.11, "overhead_ratio"), "1.1"),
}


@pytest.mark.parametrize("case", GATE_CASES)
def test_same_gate_verdict(case):
    old, new, word = GATE_CASES[case]
    want = ref.compare(old, new, 0.10)
    got = port.compare(old, new, 0.10)
    assert got == want
    lines, regressions = got
    if word is None:
        assert regressions == []
    else:
        assert regressions and word in regressions[0]
    if case == "cold_drain_halved":
        assert any("cold-drain drop" in line for line in lines)
    if case == "scaling_one_core":
        assert any("ungated" in line for line in lines)
    if case == "metric_gone":
        assert any("GONE" in line for line in lines)


def _bench_doc(value: float, rc: int = 0) -> str:
    line = json.dumps({"metric": "sieve_throughput", "value": value,
                       "unit": "values/s/chip", "vs_baseline": 1.0})
    return json.dumps({"n": 1, "cmd": "bench", "rc": rc,
                       "tail": f"warmup noise\n{line}\n", "parsed": json.loads(line)})


def test_same_round_order_by_suffix_not_mtime(tmp_path):
    # r10 written before r09: the numeric suffix wins over mtime
    (tmp_path / "BENCH_r10.json").write_text(_bench_doc(200.0))
    (tmp_path / "BENCH_r09.json").write_text(_bench_doc(100.0))
    got = port.find_rounds(str(tmp_path), "BENCH")
    assert got == ref.find_rounds(str(tmp_path), "BENCH")
    assert [r for r, _ in got] == [9, 10]


def test_same_extract_metrics_on_every_record():
    for path in sorted(REPO.glob("BENCH_r*.json")):
        doc = json.loads(path.read_text())
        assert port.extract_metrics(doc) == ref.extract_metrics(doc), path.name


# (files as (round, value, rc), argv after --dir, the exit code the
# reference's tests require, a word of the output): tests/test_trace_plane.py
MAIN_CASES = {
    "within_gate": ([(1, 100.0, 0), (2, 95.0, 0)], [], 0, "bench_compare: OK"),
    "regression": ([(2, 95.0, 0), (3, 80.0, 0)], [], 1, "REGRESSION"),
    "looser_threshold": ([(2, 95.0, 0), (3, 80.0, 0)], ["--threshold", "0.2"], 0,
                         "bench_compare: OK"),
    "newest_round_failed": ([(1, 100.0, 0), (2, 100.0, 2)], [], 1, "rc=2"),
    "single_round": ([(1, 100.0, 0)], [], 0, "need 2 to compare"),
}


@pytest.mark.parametrize("case", MAIN_CASES)
def test_same_main_verdict(case, tmp_path, capsys):
    files, extra, rc, word = MAIN_CASES[case]
    for r, value, code in files:
        (tmp_path / f"BENCH_r{r:02d}.json").write_text(_bench_doc(value, code))
    (want, got) = _both_mains(capsys, ["--dir", str(tmp_path), *extra])
    assert got == want
    assert got[0] == rc
    assert word in got[1] + got[2]


def test_same_verdict_on_a_failed_multichip_round(tmp_path, capsys):
    for r in (1, 2):
        (tmp_path / f"BENCH_r{r:02d}.json").write_text(_bench_doc(100.0))
    (tmp_path / "MULTICHIP_r01.json").write_text(json.dumps({"ok": True, "rc": 0}))
    (tmp_path / "MULTICHIP_r02.json").write_text(
        json.dumps({"ok": False, "rc": 3, "n_devices": 4}))
    (want, got) = _both_mains(capsys, ["--dir", str(tmp_path)])
    assert got == want
    assert got[0] == 1 and "multichip r02: FAILED" in got[1]
