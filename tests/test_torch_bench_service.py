"""The port's benchmark (sieve_torch/bench.py), its host-plane lines, on
the CPU: the service, wire, scaling, flood and router lines and the five
overhead ratios, at the reference's ledger sizes (n <= 2e6) with fewer
repetitions.

  - each line's keys and unit equal those of the reference's line of the
    same name in BENCH_r14.json's tail (every reply of every line is held
    exact inside the bench itself);
  - the lock-debug line's "on" pass records lock orders, and a pass that
    builds plain locks (the flag not taking) fails it instead of timing
    nothing;
  - the scaling line's ``serve --procs`` processes are waited on with a
    timeout of 60 s and their process groups are gone afterwards.
"""

import os
import subprocess

import pytest

from sieve_torch import bench
from sieve_torch.analysis import lockdebug
from tests.test_torch_bench import assert_reference_shape


@pytest.fixture(autouse=True)
def _bounded_waits(monkeypatch):
    monkeypatch.setattr(bench, "CHILD_TIMEOUT_S", 60)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_service_latency_line():
    rec = bench.service_latency_metric()
    assert rec["metric"] == "service_query_latency_p95_ms"
    assert_reference_shape(rec)
    assert set(rec["ops"]) == {"pi", "count"}
    assert rec["ops"]["pi"]["n"] == 158 and rec["ops"]["count"]["n"] == 50


def test_hot_qps_lines():
    recs = bench.service_hot_qps_metric(reps_p=2, reps_b=4)
    assert [r["metric"] for r in recs] == [
        "service_hot_qps", "service_pipeline_qps", "service_hot_qps_binary",
        "service_wire_bytes_per_member"]
    for rec in recs:
        assert_reference_shape(rec)
    # the binary frames stay under the reference's 48-byte ceiling
    assert recs[3]["value"] < 48 < recs[3]["json_bytes_per_member"]


def test_scaling_line(monkeypatch):
    started = []
    popen = subprocess.Popen

    def spy(*a, **k):
        p = popen(*a, **k)
        started.append(p)
        return p

    monkeypatch.setattr(subprocess, "Popen", spy)
    rec = bench.service_hot_qps_scaling_metric()
    assert_reference_shape(rec)
    assert (rec["procs_max"], rec["cpus"]) == (4, os.cpu_count())
    assert len(started) == 3
    for p in started:
        assert p.returncode is not None
        with pytest.raises(ProcessLookupError):
            os.killpg(p.pid, 0)


def test_flood_line():
    rec = bench.service_hot_under_flood_metric()
    assert_reference_shape(rec)
    assert rec["hot_n"] == 150


def test_router_line():
    rec = bench.router_query_latency_metric()
    assert_reference_shape(rec)
    assert set(rec["ops"]) == {"pi", "count", "is_prime", "nth_prime"}


@pytest.mark.parametrize("plane", ["trace", "recorder", "profiler", "lock_debug",
                                   "observer"])
def test_overhead_line(plane):
    rec = getattr(bench, f"service_{plane}_overhead_metric")(reps=2)
    assert rec["metric"] == f"service_{plane}_overhead_ratio"
    assert_reference_shape(rec)
    assert (rec["n"], rec["reps"]) == (208, 2)


def test_lock_debug_on_pass_records_orders(monkeypatch):
    lockdebug.recorder().reset()
    bench.service_lock_debug_overhead_metric(reps=1)
    assert lockdebug.recorder().observed_pairs()
    assert "SIEVE_LOCK_DEBUG" not in os.environ
    # a pass whose locks come out plain measures nothing: it fails
    monkeypatch.setattr(lockdebug, "_enabled", lambda: False)
    with pytest.raises(AssertionError, match="recorded no lock order"):
        bench.service_lock_debug_overhead_metric(reps=1)
