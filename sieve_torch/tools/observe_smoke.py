"""Observatory smoke: a 2-shard fleet under a mixed exact workload with
one injected latency regression and one injected scrape gap — the
observer's ring must contain the regression, exactly ONE
``fleet_anomaly`` bundle trigger must fire (zero false alarms, even
across the gap window), and the exemplar files must hold 100% of the
stalled requests' span trees plus at most a 10% healthy baseline. The
port of the reference's ``tools/observe_smoke.py``, with its thresholds.

Phases:

1. seed — sieve n into ``src``; split the segment ledger into two shard
   ledgers at a segment boundary E.
2. fleet — 2 ``python -m sieve_torch serve`` shard subprocesses (each with a
   ``--debug-dir`` so exemplar files land on disk) fronted by one
   ``python -m sieve_torch route`` subprocess, also with a debug dir.
3. steady — 8 scrape cycles of an in-process :class:`FleetObserver`
   (manual ``scrape_once`` between exact mixed-workload batches, so the
   trend windows are deterministic); a ``svc_scrape_gap:any@s5``
   directive eats one scrape — the gap is counted, no sample is
   fabricated, and NO anomaly fires anywhere in the phase.
4. regression — ``svc_stall`` directives on shard 1's next 10 requests
   under a 0.12 s deadline: every reply is the typed
   ``deadline_exceeded`` (never wrong), the next scrape's err_rate
   spikes, and exactly one ``fleet_anomaly`` fires, writing the merged
   fleet debug bundle. Three more steady scrapes must not re-fire
   (edge-trigger + cooldown).
5. exemplars — shard 1's ``exemplars.jsonl`` holds ALL 10 stalled
   requests (reason ``error``, with span trees), healthy baseline
   retention is <= 10% of healthy requests, and the router's kept
   exemplar for a stalled route carries the downstream shard records
   pulled over the ``exemplars`` wire op.
6. cli — ``python -m sieve_torch observe --scrapes 3`` runs the daemon
   entrypoint against the live fleet; ``python -m
   sieve_torch.tools.fleet_top --once --observe-dir`` renders sparkline
   trend columns from its ring.

With ``--device cuda`` (the default; the card must exist) the source
ledger is sieved on the ``cuda`` backend (the fused kernel) and both
shards serve ``--backend cuda`` on that device; with ``--device cpu``
both use the reference's ``cpu-numpy``. Every query lies inside the
ledger, so the shards sieve no cold chunk. Before the banner the smoke
prints the device and the fused launches of this process and of the
shards, read over the ``metrics`` op before they stop.

Exit status: 0 on full parity (final line ``OBSERVE_SMOKE_OK``), 1 on
any violation (with a FAIL line).

Usage: python -m sieve_torch.tools.observe_smoke [--n N] [--keep DIR] [--device D]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from sieve_torch.tools import (
    REPO,
    Proc,
    SmokeFailure,
    child_launches,
    expect,
    fail,
    launches_line,
    smoke_device,
)

ORACLE_HI = 400_000


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=120_000)
    p.add_argument("--keep", default=None,
                   help="use (and keep) this work dir instead of a temp dir")
    p.add_argument("--device", default="cuda",
                   help="cuda (the fused kernel; the card must exist) or cpu")
    args = p.parse_args(argv)
    try:
        return _run(args)
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1


def _run(args) -> int:
    if args.n > ORACLE_HI // 2:
        fail(f"--n must stay at or below {ORACLE_HI // 2} (oracle headroom)")
    dev, backend = smoke_device(args.device)

    from sieve_torch.chaos import ChaosSchedule, parse_chaos
    from sieve_torch.checkpoint import Ledger
    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local
    from sieve_torch.kernels.cuda_mark import mark_fused
    from sieve_torch.seed import seed_primes
    from sieve_torch.service import ServiceClient
    from sieve_torch.service.exemplar import load_exemplars
    from sieve_torch.service.observe import (
        RING_FILE,
        FleetObserver,
        ObserverSettings,
        read_ring,
    )

    launches0 = mark_fused.launches
    P = seed_primes(ORACLE_HI)

    def o_pi(x: int) -> int:
        return int(np.searchsorted(P, x, side="right"))

    def o_count(lo: int, hi: int) -> int:
        return int(np.searchsorted(P, hi, side="left")
                   - np.searchsorted(P, lo, side="left"))

    workdir = args.keep or tempfile.mkdtemp(prefix="observe_smoke.")
    src = os.path.join(workdir, "src")
    obsdir = os.path.join(workdir, "obs")
    dbg = [os.path.join(workdir, d)
           for d in ("dbg_router", "dbg_shard0", "dbg_shard1")]
    procs: list[Proc] = []
    try:
        # --- phase 1: sieve src, split segments into two shard ledgers ---
        src_cfg = SieveConfig(
            n=args.n, backend=backend, device=str(dev), packing="wheel30",
            n_segments=8, quiet=True, checkpoint_dir=src,
        )
        print(f"phase 1: sieving source dir (n={args.n}, 8 segments)",
              flush=True)
        run_local(src_cfg)
        segs = sorted(
            Ledger.open_readonly(src_cfg).completed().values(),
            key=lambda r: r.lo,
        )
        E = segs[4].lo  # the shard edge, on a segment boundary
        dirs = [os.path.join(workdir, d) for d in ("shard0", "shard1")]
        for d, part in zip(dirs, (segs[:4], segs[4:])):
            led = Ledger.open(dataclasses.replace(src_cfg, checkpoint_dir=d))
            for r in part:
                led.record(r)
        print(f"phase 1 OK: shard ledgers split at edge E={E}", flush=True)

        # --- phase 2: 1 replica per shard + router, all with debug dirs --
        env = dict(os.environ)

        def serve_args(d: str, range_lo: int, dbg_dir: str) -> list[str]:
            a = [
                sys.executable, "-m", "sieve_torch", "serve",
                "--addr", "127.0.0.1:0", "--n", str(args.n),
                "--packing", "wheel30", "--segments", "8",
                "--checkpoint-dir", d, "--deadline-s", "10",
                "--drain-s", "10", "--quiet", "--allow-chaos",
                "--debug-dir", dbg_dir,
                "--backend", backend, "--device", str(dev),
            ]
            if range_lo > 2:
                a += ["--range-lo", str(range_lo)]
            return a

        # both start together (each imports torch, or reaches the card),
        # so neither samples its profiler for longer than the other
        s0 = Proc(serve_args(dirs[0], 2, dbg[1]), env, announce=False)
        s1 = Proc(serve_args(dirs[1], E, dbg[2]), env, announce=False)
        procs.extend([s0, s1])
        s0.announce()
        s1.announce()
        router = Proc([
            sys.executable, "-m", "sieve_torch", "route",
            "--addr", "127.0.0.1:0", "--quiet",
            "--deadline-s", "10", "--timeout-s", "15",
            "--debug-dir", dbg[0],
            "--shard", f"2:{E}={s0.addr}",
            "--shard", f"{E}:{args.n + 1}={s1.addr}",
        ], env)
        procs.append(router)
        expect("router announce event", router.serving["event"], "routing")
        cli = ServiceClient(router.addr, timeout_s=30)
        print(f"phase 2 OK: fleet up (router at {router.addr})", flush=True)

        # --- phase 3: steady scrapes + one injected scrape gap -----------
        obs = FleetObserver(
            router.addr,
            ObserverSettings(
                scrape_s=0.05, warmup=4, min_delta=2.0, z_threshold=8.0,
                cooldown_s=60.0, observe_dir=obsdir, quiet=True,
            ),
            chaos=ChaosSchedule(parse_chaos("svc_scrape_gap:any@s5")),
        )

        def steady_batch(i: int) -> None:
            # mixed exact workload across both shards
            x = 5_000 + 9_000 * (i % 8)
            expect(f"steady pi({x})", cli.query("pi", x=x)["value"], o_pi(x))
            expect(f"steady count s0 {i}",
                   cli.query("count", lo=10_000, hi=30_000)["value"],
                   o_count(10_000, 30_000))
            expect(f"steady count s1 {i}",
                   cli.query("count", lo=E + 10, hi=E + 2_000)["value"],
                   o_count(E + 10, E + 2_000))

        for s in range(1, 9):
            steady_batch(s)
            obs.scrape_once()
            st = obs.stats()
            if st["anomalies"]:
                fail(f"false alarm at steady scrape {s}: {st!r}")
        st = obs.stats()
        expect("one counted scrape gap", st["gaps"], 1)
        ring = read_ring(os.path.join(obsdir, RING_FILE))
        expect("ring rows after steady phase", len(ring), 8)
        gap_rows = [t for snap in ring for t in snap["targets"]
                    if t.get("gap")]
        expect("exactly one gap row in the ring", len(gap_rows), 1)
        expect("gap row fabricates no signals",
               "signals" in gap_rows[0], False)
        expect("gap at the injected scrape", ring[4]["scrape"], 5)
        print("phase 3 OK: 8 steady scrapes, 1 counted gap, 0 alarms",
              flush=True)

        # --- phase 4: svc_stall regression -> exactly one fleet_anomaly --
        with ServiceClient(s1.addr, timeout_s=10) as c1:
            seq1 = c1.stats()["requests"]
            c1.inject_chaos(",".join(
                f"svc_stall:any@s{seq1 + j}:0.25" for j in range(1, 11)
            ))
        stalled = 0
        for _ in range(10):
            rep = cli.query("count", lo=E + 10, hi=E + 2_000,
                            deadline_s=0.12)
            if rep.get("ok"):
                fail(f"stalled request answered ok under 0.12s budget: "
                     f"{rep!r}")
            expect("stalled request error kind", rep["error"],
                   "deadline_exceeded")
            stalled += 1
        obs.scrape_once()
        st = obs.stats()
        expect("exactly one fleet_anomaly fired", st["anomalies"], 1)
        ring = read_ring(os.path.join(obsdir, RING_FILE))
        reg = ring[-1]
        if not reg["anomalies"]:
            fail(f"regression scrape carries no anomaly row: {reg!r}")
        evid = reg["anomalies"][0]
        for key in ("addr", "signal", "value", "mean", "dev", "z",
                    "scrape"):
            if key not in evid:
                fail(f"anomaly evidence row missing {key!r}: {evid!r}")
        hot = [t for t in reg["targets"] if t["addr"] == s1.addr]
        if not hot or hot[0]["signals"]["err_rate"] <= 0:
            fail(f"ring does not contain the regression: {reg!r}")
        bundles = [f for f in os.listdir(obsdir)
                   if f.startswith("anomaly_")]
        expect("one anomaly bundle written", len(bundles), 1)
        with open(os.path.join(obsdir, bundles[0])) as f:
            doc = json.load(f)
        if not any(pr.get("bundle") for pr in doc["processes"]):
            fail(f"anomaly bundle pulled no recorder state: {bundles[0]}")
        for s in range(3):  # edge-trigger: no re-fire on the way down
            steady_batch(s)
            obs.scrape_once()
        expect("no anomaly re-fire after regression",
               obs.stats()["anomalies"], 1)
        print(f"phase 4 OK: {stalled} typed deadline_exceeded, one "
              f"fleet_anomaly ({evid['signal']} z={evid['z']}), one "
              f"bundle, no re-fire", flush=True)

        # --- phase 5: exemplar files ------------------------------------
        with ServiceClient(s1.addr, timeout_s=10) as c1:
            st1 = c1.stats()
        # exemplar appends ride a writer thread in the server process —
        # give the tail a moment to land before reading the files
        deadline = time.time() + 5.0
        while True:
            shard_recs = load_exemplars(
                os.path.join(dbg[2], "exemplars.jsonl"))
            errors = [r for r in shard_recs
                      if r.get("outcome") == "deadline_exceeded"]
            if len(errors) >= stalled or time.time() > deadline:
                break
            time.sleep(0.05)
        if len(errors) < stalled:
            fail(f"shard exemplar file holds {len(errors)} of {stalled} "
                 f"stalled requests")
        for r in errors:
            expect("stalled exemplar reason", r["reason"], "error")
            if not r.get("ctx"):
                fail(f"stalled exemplar carries no trace ctx: {r!r}")
        if not any(r.get("spans") for r in errors):
            fail("no stalled exemplar carries a span tree")
        healthy_seen = st1["exemplars_seen"] - len(errors)
        healthy_kept = len([r for r in shard_recs
                            if r.get("outcome") == "ok"])
        if healthy_kept > max(1, healthy_seen // 10):
            fail(f"healthy retention too high: {healthy_kept} of "
                 f"{healthy_seen}")
        deadline = time.time() + 5.0
        while True:
            router_recs = load_exemplars(
                os.path.join(dbg[0], "exemplars.jsonl"))
            routed_err = [r for r in router_recs
                          if r.get("outcome") not in (None, "ok")]
            if routed_err and any(r.get("downstream") for r in routed_err):
                break
            if time.time() > deadline:
                break
            time.sleep(0.05)
        if not routed_err:
            fail("router kept no exemplar for the stalled route")
        if not any(r.get("downstream") for r in routed_err):
            fail("router exemplar pulled no downstream shard records")
        live = cli.exemplars()
        if not live:
            fail("exemplars wire op returned nothing from the router")
        print(f"phase 5 OK: shard kept {len(errors)}/{stalled} stalled "
              f"(healthy {healthy_kept}/{healthy_seen}), router kept "
              f"{len(routed_err)} with downstream pulls", flush=True)

        # --- phase 6: the CLI daemon + fleet_top sparklines -------------
        obs2 = os.path.join(workdir, "obs2")
        proc = subprocess.run(
            [sys.executable, "-m", "sieve_torch", "observe",
             "--router", router.addr, "--observe-dir", obs2,
             "--scrapes", "3", "--scrape-s", "0.1", "--quiet"],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=60,
        )
        if proc.returncode != 0:
            fail(f"sieve_torch observe rc={proc.returncode}: {proc.stderr[-800:]}")
        lines = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        expect("observe announce", lines[0]["event"], "observing")
        expect("observe summary", lines[-1]["event"], "observed")
        expect("observe CLI scrapes", lines[-1]["scrapes"], 3)
        expect("observe CLI ring rows",
               len(read_ring(os.path.join(obs2, RING_FILE))), 3)
        top = subprocess.run(
            [sys.executable, "-m", "sieve_torch.tools.fleet_top",
             router.addr, "--once", "--observe-dir", obsdir],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=60,
        )
        if top.returncode != 0:
            fail(f"fleet_top rc={top.returncode}: {top.stderr[-800:]}")
        if "hot trend" not in top.stdout:
            fail("fleet_top --observe-dir shows no trend columns")
        if not any(ch in top.stdout for ch in "▁▂▃▄▅▆▇█"):
            fail("fleet_top trend columns carry no sparkline")
        cli.close()
        print("phase 6 OK: observe CLI ran 3 scrapes, fleet_top rendered "
              "ring sparklines", flush=True)
        child = [child_launches(s.addr) for s in (s0, s1)]
        own = mark_fused.launches - launches0
        print(launches_line(dev, own + sum(child),
                            f"(this process {own}, shards {child})"),
              flush=True)
        print("OBSERVE_SMOKE_OK", flush=True)
        return 0
    finally:
        for pr in procs:
            pr.kill()
        if args.keep is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
