"""Chaos smoke: a composed fault schedule plus a corrupted-ledger resume,
asserting exact counts end to end. The port of the reference's
``tools/chaos_smoke.py``.

Phase 1 runs the cpu-cluster backend under four composed faults — a
worker kill, a mid-segment disconnect, heartbeat suppression, and a
silent reply stall — with checkpointing on, and requires bit-exact
pi/twin counts against a single-process cpu-numpy run of the same n.
The stall is sized under the adaptive silence deadline's heartbeat-miss
floor, so a stalled-but-alive worker must NOT be declared failed.

Phase 2 truncates the ledger mid-file (simulating a torn write on a
filesystem without the fsync guarantees) and re-runs with --resume: the
damaged file must be quarantined, every complete entry salvaged, and the
resumed run must again produce exact counts.

With ``--device cuda`` (the default; the card must exist) the cluster's
workers run the ``cuda`` backend (``SIEVE_CLUSTER_WORKER_BACKEND=cuda``),
so every segment goes through the fused kernel in a worker process; with
``--device cpu`` they run the reference's default (cpu-native, else
cpu-numpy). Before the banner the smoke prints the device and the fused
launches the workers report in their shipped telemetry
(``cluster.worker<i>.kernel.mark_fused.launches``), and, under
``SIEVE_LOCK_DEBUG=1``, the observed lock orders checked against the
canonical order.

Exit status: 0 on full parity, 1 on any mismatch (with a FAIL line).

Usage: python -m sieve_torch.tools.chaos_smoke [--n N] [--keep DIR] [--device D]
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys
import tempfile

from sieve_torch.tools import (
    SmokeFailure,
    assert_lock_orders as _assert_lock_orders,
    fail,
    launches_line,
    smoke_device,
)

CHAOS = "kill:any@s2,disconnect:any@s3,drop_hb:any@s4,stall:any@s5:1.5"
# a worker's launch counter, as the coordinator's gauge of its telemetry
_LAUNCH_GAUGE = re.compile(r"^cluster\.worker\d+\.kernel\.mark_fused\.launches$")


def _worker_launches(run):
    """``run()``'s result and the fused launches its workers reported:
    the launch gauges are set to 0 just before and summed just after."""
    from sieve_torch.metrics import registry

    reg = registry()
    for name in reg.snapshot():
        if _LAUNCH_GAUGE.match(name):
            reg.gauge(name).set(0)
    res = run()
    return res, sum(int(v["value"]) for k, v in reg.snapshot().items()
                    if _LAUNCH_GAUGE.match(k))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=10**5)
    p.add_argument("--keep", default=None,
                   help="use (and keep) this checkpoint dir instead of a "
                        "temp dir")
    p.add_argument("--device", default="cuda",
                   help="cuda (workers on the fused kernel; the card must "
                        "exist) or cpu")
    args = p.parse_args(argv)
    try:
        return _run(args)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1


def _run(args) -> int:
    dev, _ = smoke_device(args.device)
    # tight static floor = fast dead-worker detection; the adaptive
    # heartbeat-miss floor (4 x HEARTBEAT_S) still rides out the 1.5 s
    # stall. Short backoff keeps the disconnect reconnect snappy.
    os.environ.setdefault("SIEVE_CLUSTER_DEADLINE_S", "2")
    os.environ.setdefault("SIEVE_WORKER_BACKOFF_S", "0.05")
    if dev.type == "cuda":
        os.environ["SIEVE_CLUSTER_WORKER_BACKEND"] = "cuda"

    from sieve_torch.checkpoint import LEDGER_NAME
    from sieve_torch.cluster import run_cluster
    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local

    workdir = args.keep or tempfile.mkdtemp(prefix="chaos_smoke.")
    try:
        oracle = run_local(SieveConfig(
            n=args.n, backend="cpu-numpy", twins=True, quiet=True,
        ))
        cfg = SieveConfig(
            n=args.n, backend="cpu-cluster", workers=2, n_segments=8,
            twins=True, quiet=True, coordinator_addr="127.0.0.1:0",
            checkpoint_dir=workdir, chaos=CHAOS, device=str(dev),
        )

        print(f"phase 1: composed chaos run ({CHAOS})", flush=True)
        res, launches1 = _worker_launches(lambda: run_cluster(cfg))
        if res.pi != oracle.pi:
            fail(f"chaos run pi={res.pi}, oracle pi={oracle.pi}")
        if res.twin_pairs != oracle.twin_pairs:
            fail(f"chaos run twins={res.twin_pairs}, "
                 f"oracle twins={oracle.twin_pairs}")
        if len({s.seg_id for s in res.segments}) != len(res.segments):
            fail("duplicate seg_id in merged results (ledger double-count)")
        print(f"phase 1 OK: pi={res.pi} twins={res.twin_pairs} "
              f"segments={len(res.segments)}", flush=True)

        ledger_path = os.path.join(workdir, LEDGER_NAME)
        text = open(ledger_path).read()
        with open(ledger_path, "w") as f:
            f.write(text[: int(len(text) * 0.6)])  # torn mid-file
        print("phase 2: ledger truncated to 60%, resuming", flush=True)

        res2, launches2 = _worker_launches(lambda: run_cluster(SieveConfig(
            **{**cfg.to_dict(), "resume": True, "chaos": None}
        )))
        if not os.path.exists(ledger_path + ".quarantined"):
            fail("corrupt ledger was not quarantined")
        if res2.pi != oracle.pi or res2.twin_pairs != oracle.twin_pairs:
            fail(f"resumed run pi={res2.pi}/twins={res2.twin_pairs}, "
                 f"oracle {oracle.pi}/{oracle.twin_pairs}")
        print(f"phase 2 OK: pi={res2.pi} twins={res2.twin_pairs} "
              f"(salvage + resume exact)", flush=True)
        print(launches_line(dev, launches1 + launches2,
                            f"in the workers (phase 1 {launches1}, "
                            f"phase 2 {launches2})"), flush=True)
        _assert_lock_orders()
        print("CHAOS_SMOKE_OK", flush=True)
        return 0
    finally:
        if args.keep is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
