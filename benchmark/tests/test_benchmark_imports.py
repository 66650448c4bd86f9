"""What the harness and the reference load: never JAX or the JAX package,
and the reference nothing of the program."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ["benchmark.reference", "benchmark.reference.common",
             "benchmark.reference.packing_odds", "benchmark.reference.control",
             "benchmark.check", "benchmark.roofline", "benchmark.control"]


def _loaded(code: str) -> set[str]:
    proc = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return set(proc.stdout.strip().splitlines()[-1].split())


def test_reference_loads_no_program():
    tops = _loaded("\n".join(f"import {m}" for m in REFERENCE))
    assert not tops & {"jax", "jaxlib", "flax", "sieve", "sieve_torch", "torch"}


def test_harness_run_loads_no_jax():
    code = ("import time, torch\nfrom pathlib import Path\n"
            "from benchmark import harness, spec\n"
            f"root = Path({str(ROOT)!r})\n"
            "for w in ('twins_1e11.local', 'torch_twins_1e9.local'):\n"
            "    c = spec.cell(spec.load(root), w, root)\n"
            "    harness.run_cell(c, 1, 0.2, True, time.perf_counter(), device='cpu', n=10**5)")
    tops = _loaded(code)
    assert "sieve_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "sieve"}
