"""The port's measurement tools (sieve_torch/tools/) on the CPU.

Each tool's ``main(argv)`` runs in this process with ``--device cpu`` (the
kernels' plain versions) at a tiny size and must exit 0; the segment's
(count, pairs, first, last) that it prints must equal the reference's
``mark_pallas`` in interpret mode on the same segment, and the rounds
tool's counts the oracles. ``profile_prepare`` prints the reference's
phase names, padded width and seed count at the same argv.
``mesh_cold_smoke`` runs as a process (the port of test_mesh_cold.py's
smoke gate). Every tool that touches a device raises when it is given
``--device cuda`` and there is no card: no tool falls back to the CPU.
Their times are host-clock times of this CPU and are checked for nothing
but their presence; the card's come from chip_smoke.py.
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tools.profile_prepare as ref_prepare
from sieve.kernels import pallas_mark
from sieve.seed import seed_primes
from sieve_torch.kernels import pairs
from sieve_torch.tools import (
    microbench,
    profile_breakdown,
    profile_kernel,
    profile_prepare,
    profile_rounds,
    profile_rtt,
)
from tests.oracles import PI, TWINS

REPO = Path(__file__).resolve().parent.parent
TUPLE = re.compile(r"segment \(count, pairs, first, last\) = \((\d+), (\d+), (\d+), (\d+)\)")
_REF = {}


def _ref_tuple(lo: int, hi: int, kind: int) -> tuple:
    """The reference's Pallas kernel (interpret mode) on odds [lo, hi)."""
    key = (lo, hi, kind)
    if key not in _REF:
        ps = pallas_mark.prepare_pallas("odds", lo, hi,
                                        seed_primes(math.isqrt(hi - 1)))
        _REF[key] = tuple(int(v) for v in pallas_mark.mark_pallas(ps, kind, True))
    return _REF[key]


def _main(mod, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return buf.getvalue()


def _tuple(out: str) -> tuple:
    m = TUPLE.search(out)
    assert m, out
    return tuple(int(v) for v in m.groups())


# (tool, argv, the segment and pair kind it marks)
KERNEL_RUNS = [
    (profile_kernel, ["1e6"], (2, 10**6 + 2, pairs.TWIN_ADJ)),
    # the depth regime's argv shape: lo far from 2, group D live
    (profile_kernel, ["1e6", "999000000"], (999_000_000, 1_000_000_000, pairs.TWIN_ADJ)),
    (profile_rtt, ["1e6"], (2, 10**6 + 1, pairs.TWIN_ADJ)),
    (profile_breakdown, ["1e6"], (2, 10**6 + 1, pairs.TWIN_NONE)),
    (microbench, ["1e6"], (2, 10**6 + 1, pairs.TWIN_ADJ)),
    (microbench, ["1e6", "--cuda"], (2, 10**6 + 1, pairs.TWIN_ADJ)),
]


@pytest.mark.parametrize("mod,argv,seg", KERNEL_RUNS,
                         ids=lambda v: v.__name__.rsplit(".", 1)[-1]
                         if hasattr(v, "__name__") else None)
def test_tool_segment_equals_reference_kernel(mod, argv, seg):
    out = _main(mod, argv + ["--device", "cpu"])
    assert _tuple(out) == _ref_tuple(*seg)
    assert "cpu" in out  # every time names where it was taken


def test_profile_kernel_depth_tables():
    out = _main(profile_kernel, ["1e6", "999000000", "--device", "cpu"])
    head = out.splitlines()[0]
    ps = pallas_mark.prepare_pallas("odds", 999_000_000, 1_000_000_000,
                                    seed_primes(math.isqrt(999_999_999)))
    nd = ps.D[0].shape[0] if ps.D[3].any() else 0
    assert f"Wpad={ps.Wpad} " in head and f" ND={nd} " in head and nd > 0
    assert f"tiers={pallas_mark.spec_counts(ps)}" in head
    for what in ("fused kernel", "split kernel", "postlude"):
        assert re.search(rf"--> {what} time: +\d+\.\d+ ms .*host clock, CPU", out)


def test_profile_rtt_args_and_slope():
    out = _main(profile_rtt, ["1e6", "--device", "cpu"])
    assert "(slope)" in out and "(intercept)" in out
    assert [int(k) for k in re.findall(r"^k=(\d+):", out, re.M)] == [1, 2, 4, 8]
    out = _main(profile_rtt, ["1e6", "--args", "--device", "cpu"])
    assert "host args:" in out and "device args:" in out
    assert "copy of the tables to cpu" in out


def test_profile_breakdown_lines():
    out = _main(profile_breakdown, ["1e6", "--device", "cpu"])
    for line in ("prepare_cuda (host):", "chain prepare (host, incr):",
                 "avg phases ms: residue=", "split kernel only:",
                 "split kernel + postlude:", "fused mark+reduce:",
                 "mark_fused end-to-end:", "coordinator overhead:"):
        assert line in out
    assert f"pi={PI[10**6]}" in out


def test_profile_rounds_counts_phases_and_report(tmp_path):
    path = tmp_path / "rounds.json"
    out = _main(profile_rounds, ["1e6", "4", "--twins", "--trace-out", str(path),
                                 "--device", "cpu"])
    assert f"pi={PI[10**6]} twin={TWINS[10**6]}" in out
    m = re.search(r"^host_phases (\{.*\})$", out, re.M)
    assert m
    ph = json.loads(m.group(1))
    assert set(ph) >= {"stack_s", "dispatch_s", "drain_s", "device_idle_frac"}
    assert 0 <= ph["device_idle_frac"] <= 1
    assert "per-phase breakdown" in out and "round.dispatch" in out
    # the kept file renders the same report through the port's trace_report
    from sieve_torch.tools.trace_report import load_events, report

    assert report(load_events(str(path))) in out


def _phase_rows(out: str) -> list[list[str]]:
    """Row names of each phase table (lines '    <name> ... ms/seg')."""
    tables, cur = [], None
    for line in out.splitlines():
        if "steady-state prepare" in line:
            cur = []
            tables.append(cur)
        elif cur is not None and line.endswith("%") and "ms/seg" in line:
            cur.append(line.split()[0])
    return tables


def test_profile_prepare_matches_reference(monkeypatch):
    got = _main(profile_prepare, ["1e6", "2"])
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["profile_prepare.py", "1e6", "2"])
    with contextlib.redirect_stdout(buf):
        assert ref_prepare.main() == 0
    want = buf.getvalue()
    # packing, span, segments, seed count, padded width
    assert got.splitlines()[0] == want.splitlines()[0]
    assert "seeds=78498 wpad=16384" in got
    assert _phase_rows(got) == _phase_rows(want) == [
        ["residue", "group", "flat", "corrections", "other"],
        ["residue", "group", "corrections", "other"]]
    assert "mesh stacking" in got and "chain speedup" in got


@pytest.mark.parametrize("name", ["profile_kernel", "profile_rtt",
                                  "profile_breakdown", "profile_rounds",
                                  "microbench", "mesh_cold_smoke"])
def test_device_tools_raise_without_card(name, monkeypatch):
    import importlib

    mod = importlib.import_module(f"sieve_torch.tools.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"profile_rounds": ["1e6", "2"], "mesh_cold_smoke": []}.get(name, ["1e6"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)  # --device defaults to cuda


def test_mesh_cold_smoke_subprocess():
    # one intra-op thread: torch's default of one per core, in a process
    # beside a loaded test run, spins for most of a minute
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "sieve_torch.tools.mesh_cold_smoke",
         "--device", "cpu", "--chunks", "8", "--span", "14"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MESH_COLD_SMOKE_OK" in proc.stdout
    assert '"unit": "cold_throughput"' in proc.stdout
    assert '"spmd_launches": 1' in proc.stdout
