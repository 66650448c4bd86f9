"""The sanitizer build of the port's ``cpu-native`` backend, the counterpart
of the reference's ``make asan`` target and test_wide_stride.py's
``test_asan_native_parity``.

With SIEVE_NATIVE_ASAN set, ``sieve_torch/backends/cpu_native.py`` builds
and loads ``-O1 -g -fsanitize=address,undefined`` under its own hashed
name in ``sieve_torch/_build/``. One native-against-numpy parity check
runs in a subprocess with the ASan runtime preloaded (python itself is
not instrumented, so leak detection stays off): the port's
``CpuNativeWorker`` equals the port's ``CpuNumpyWorker`` on [101, 400001),
and the library it loaded is the sanitizer's.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from sieve_torch.backends import cpu_native

REPO = Path(__file__).resolve().parent.parent


def test_asan_library_has_its_own_hashed_name():
    plain, asan = cpu_native.library_path(), cpu_native.library_path(asan=True)
    assert plain.parent == asan.parent == cpu_native.BUILD_DIR
    assert plain.name.startswith("libmark-") and asan.name.startswith("libmark_asan-")
    assert plain != asan
    assert asan == cpu_native.library_path(asan=True)  # stable for one tree


def test_asan_native_parity():
    libasan = subprocess.run(
        ["g++", "-print-file-name=libasan.so"],
        capture_output=True, text=True,
    ).stdout.strip()
    if not libasan or not os.path.exists(libasan):
        pytest.skip("libasan.so not found")
    code = (
        "import dataclasses\n"
        "from sieve_torch.backends import cpu_native\n"
        "from sieve_torch.config import SieveConfig\n"
        "from sieve_torch.backends.cpu_native import CpuNativeWorker\n"
        "from sieve_torch.backends.cpu_numpy import CpuNumpyWorker\n"
        "from sieve_torch.seed import seed_primes\n"
        "cfg = SieveConfig(n=10**6, backend='cpu-native', packing='odds',\n"
        "                  twins=True, quiet=True)\n"
        "seeds = seed_primes(cfg.seed_limit)\n"
        "strip = lambda r: {k: v for k, v in dataclasses.asdict(r).items()\n"
        "                   if k != 'elapsed_s'}\n"
        "a = CpuNativeWorker(cfg).process_segment(101, 400001, seeds)\n"
        "b = CpuNumpyWorker(cfg).process_segment(101, 400001, seeds)\n"
        "assert strip(a) == strip(b), (a, b)\n"
        "assert cpu_native._LIB._name == str(cpu_native.library_path(asan=True))\n"
        "print('ASAN_PARITY_OK')\n"
    )
    env = {
        **{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
        "SIEVE_NATIVE_ASAN": "1",
        "LD_PRELOAD": libasan,
        # python itself is not asan-instrumented; its allocations look like
        # leaks and would fail the exit hook
        "ASAN_OPTIONS": "detect_leaks=0",
    }
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=300, cwd=str(REPO), env=env,
    )
    if proc.returncode != 0 and "cannot" in proc.stderr.lower():
        pytest.skip(f"asan runtime unusable here: {proc.stderr[-200:]}")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ASAN_PARITY_OK" in proc.stdout
