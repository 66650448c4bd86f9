"""The port's four fleet smokes on the CPU, each as the reference's own
test runs it:

- ``failover_smoke`` (as tests/test_service.py runs the reference's): the
  replicated query plane: two ``serve`` processes over a ledger a live
  writer extends, a ``replica_down`` window and a SIGKILL under load,
  injected refresh corruption, and a graceful drain, every reply
  oracle-exact or typed;
- ``shard_smoke`` (as tests/test_router.py runs the reference's): the
  range-sharded fabric: four ``serve`` processes (2 shards x 2 replicas)
  behind a ``route`` process, an oracle sweep across the shard edge, a
  replica SIGKILL, a whole shard down, a restart on the old address and an
  injected ``svc_shard_down`` window, every reply oracle-exact or typed;
- ``observe_smoke`` (as tests/test_observe.py runs the reference's): two
  shard ``serve`` processes behind a ``route`` process under an exact
  workload, an in-process FleetObserver whose ring holds one counted scrape
  gap and the injected regression, exactly one ``fleet_anomaly``, the
  exemplar files, the ``observe`` CLI and ``fleet_top --once
  --observe-dir``, with the reference's thresholds;
- ``profile_smoke`` (as tests/test_profile.py runs the reference's): two
  shard ``serve`` processes behind a ``route`` process sampled at 97 Hz,
  merged flame captures through ``fleet_profile`` (>= 90% role-tagged), an
  injected ``svc_stall`` hot frame that the diff names top, and a
  ``svc_prof_gap`` partial merge that the next pull heals, with the
  reference's thresholds.

Each runs as a process of its own with ``--device cpu`` (the reference's
cpu-numpy set-up) under SIEVE_LOCK_DEBUG=1, must exit 0 with its banner,
must print its device and fused launches, and must have loaded neither
``jax`` nor ``sieve`` nor the repository's ``tools`` (the check
tests/test_torch_isolation.py makes of the other smokes; each smoke runs
once in a test run). Its process group is killed
in teardown, so no server or router outlives the test. It runs with
OMP_NUM_THREADS=1: under a loaded test run, torch's default of one thread
per core makes a process that imports it many times slower. The four are
cases of one test in one file, so a test run distributed by file runs them
one after another: each starts three to five processes, and four of them
at once beside the rest of a loaded run starve the timed phases of the
smokes and of their neighbours.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "sieve", "tools")

# runs one smoke module as ``python -m`` would, then prints its exit code
# and the forbidden modules it loaded as one JSON line after its output
_PROBE = """
import json, runpy, sys
mod = sys.argv[1]
sys.argv = [mod] + sys.argv[2:]
rc = 0
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code
forbidden = %r
loaded = sorted(m for m in sys.modules
                if any(m == f or m.startswith(f + ".") for f in forbidden))
sys.stdout.flush()
print(json.dumps({"rc": rc, "loaded": loaded}))
""" % (FORBIDDEN,)

# smoke -> lines its output must hold besides the banner and the launches
EXTRA = {
    "failover": [],
    "shard": [],
    "observe": [],
    "profile": ["role-tagged"],
}


@pytest.mark.parametrize("smoke", sorted(EXTRA))
def test_fleet_smoke_tool(smoke, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-c", _PROBE, f"sieve_torch.tools.{smoke}_smoke",
         "--device", "cpu", "--keep", str(tmp_path / "work")],
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
    *lines, last = out.splitlines()
    got = json.loads(last)
    assert got["rc"] in (0, None), (out, err)
    assert lines[-1] == f"{smoke.upper()}_SMOKE_OK"
    assert not got["loaded"], f"{smoke}_smoke loaded {got['loaded']}"
    assert "device: cpu; fused launches " in out
    for text in EXTRA[smoke]:
        assert text in out
