"""The port's graft entry (sieve_torch/graft_entry.py) against the
repository's ``__graft_entry__.py``.

``entry(device="cpu")`` hands back the same example tables as the
reference's ``entry()`` and its forward step gives the same (count,
pairs, first, last) as the reference's, jitted on the CPU, on the n=1e6
odds segment (tolerance 0: integer words). ``dryrun_multichip(2,
device="cpu")`` passes its own checks (the oracles, a live group D, the
idle share, the fused mode, fused against split on every segment) with
the reference's per-group spec counts; ``python -m sieve_torch.graft_entry
--device cpu`` runs both, writes the SIEVE_TRACE capture, and loads
neither ``jax`` nor ``sieve``; without a card ``device="cuda"`` raises.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_graft
from sieve.kernels.pallas_mark import prepare_pallas
from sieve.kernels.pallas_mark import spec_counts as ref_spec_counts
from sieve.seed import seed_primes as ref_seed_primes
from sieve.segments import plan_segments as ref_plan_segments
from sieve_torch import graft_entry

REPO = Path(__file__).resolve().parent.parent


def _flat(args):
    out = []
    for a in args:
        if isinstance(a, tuple):
            out.extend(_flat(a))
        else:
            out.append(np.asarray(a))
    return out


def test_entry_equals_reference_entry():
    ref_fn, ref_args = ref_graft.entry()
    fn, args = graft_entry.entry(device="cpu")
    got_args, want_args = _flat(args), _flat(ref_args)
    assert len(got_args) == len(want_args)
    for g, w in zip(got_args, want_args):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    want = [int(v) & 0xFFFFFFFF for v in jax.jit(ref_fn)(*ref_args)]
    out = fn(*args)
    assert out.device.type == "cpu" and out.dtype == torch.int64
    assert out.tolist() == want
    assert want[:2] == [78_497, 8_169]  # odd primes below 1e6; twin pairs


def test_dryrun_multichip_two_shards_on_cpu(capsys):
    summary = graft_entry.dryrun_multichip(2, device="cpu")
    assert summary["reduction_mode"] == "fused"
    assert summary["fused_split_shard_parity"] == 4
    assert summary["device_idle_frac"] < 0.10
    n = 30_000_000
    seg = ref_plan_segments(n, 4)[0]
    want = ref_spec_counts(prepare_pallas("odds", seg.lo, seg.hi,
                                          ref_seed_primes(int(np.sqrt(n)))))
    assert {k: summary["spec_counts"][k] for k in want} == want
    assert want["D"] > 0
    out = capsys.readouterr().out
    assert "dryrun_multichip: torch device_idle_frac=" in out
    assert "dryrun_multichip: cuda device_idle_frac=" in out


def test_module_runs_both_and_loads_no_jax_no_sieve(tmp_path):
    trace_file = tmp_path / "dryrun.trace.json"
    probe = ("import json, runpy, sys\n"
             "sys.argv = ['graft_entry', '--device', 'cpu']\n"
             "try:\n"
             "    runpy.run_module('sieve_torch.graft_entry', run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    rc = e.code\n"
             "print(json.dumps({'rc': rc, 'after': sorted(sys.modules)}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                          env={**env, "SIEVE_TRACE": str(trace_file),
                               "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    got = json.loads(lines[-1])
    assert got["rc"] == 0
    assert lines[0].startswith("entry() ok: [78497, 8169, ")
    assert "dryrun_multichip ok" in lines
    assert f"trace written to {trace_file}" in lines
    events = json.loads(trace_file.read_text())["traceEvents"]
    assert any(e.get("name") == "round.dispatch" for e in events)
    loaded = [m for m in got["after"]
              if m.split(".")[0] in ("jax", "jaxlib", "sieve", "tools")]
    assert not loaded, f"the graft entry loaded {loaded}"


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.main([])


def test_warm_is_a_noop_on_the_cpu(monkeypatch):
    """The rounds path loads the kernels while round 0 prepares, on a card
    only: on the CPU ``warm`` loads no library and ``run_mesh`` opens no
    ``round.warm`` span."""
    from sieve_torch import trace
    from sieve_torch.config import SieveConfig
    from sieve_torch.kernels import build, cuda_mark
    from sieve_torch.parallel.mesh import run_mesh

    def no_load():
        raise AssertionError("the kernel library was loaded for the CPU")

    monkeypatch.setattr(build, "load", no_load)
    cuda_mark.warm([torch.device("cpu"), "cpu"])
    snap = trace.snapshot()
    res = run_mesh(SieveConfig(n=10**6, backend="cuda", packing="odds", workers=2,
                               rounds=2, twins=True, quiet=True, device="cpu"))
    assert (res.pi, res.twin_pairs) == (78_498, 8_169)
    spans = trace.since(snap)
    assert "round.dispatch" in spans and "round.warm" not in spans
