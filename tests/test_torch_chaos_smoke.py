"""The port's chaos smoke (``python -m sieve_torch.tools.chaos_smoke``) on the
CPU, as tests/test_chaos.py runs the reference's: the cpu-cluster run under
a composed kill, disconnect, heartbeat drop and stall, then the torn-ledger
resume, both exact against cpu-numpy.

It runs as a process of its own with ``--device cpu`` under
SIEVE_LOCK_DEBUG=1 (read once, at import), must exit 0 with its banner,
and must report observed lock orders consistent with the canonical order.
Its process group is killed in teardown, so no server or worker outlives
the test. It runs with OMP_NUM_THREADS=1: under a loaded test run, torch's
default of one thread per core makes a process that imports it many times
slower.
"""

import os
import re
import signal
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_chaos_smoke_tool(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "sieve_torch.tools.chaos_smoke", "--device", "cpu",
         "--keep", str(tmp_path / "work")],
        env={**env, "SIEVE_LOCK_DEBUG": "1", "OMP_NUM_THREADS": "1"},
        cwd=str(REPO), text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.communicate()
    assert proc.returncode == 0, (out, err)
    lines = out.splitlines()
    assert lines[-1] == "CHAOS_SMOKE_OK"
    k = re.search(r"^lock debug OK: (\d+) observed acquisition orders", out, re.M)
    assert k and int(k.group(1)) > 0, out
    assert "device: cpu; fused launches " in out
