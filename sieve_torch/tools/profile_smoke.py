"""Continuous-profiler smoke: a 2-shard subprocess fleet under induced
load, pulled into ONE merged flamegraph-compatible collapsed capture
where >= 90% of samples carry a thread-role tag, then an injected hot
frame (``svc_stall`` burning a worker inside ``server._handle``) that
``fleet_profile --diff`` must report as the top positive self-time
delta. The port of the reference's ``tools/profile_smoke.py``, with its
thresholds.

Phases:

1. seed — sieve n into ``src``; split the segment ledger into two shard
   ledgers at a segment boundary E.
2. fleet — 2 ``python -m sieve_torch serve`` shard subprocesses fronted by
   one ``python -m sieve_torch route`` subprocess, all with ``--prof-hz 97``
   (fast beats keep the smoke short; production default is 19).
3. capture A — mixed exact workload across both shards, then
   ``python -m sieve_torch.tools.fleet_profile`` merges router + both replicas: all 3
   processes present (exit 0), the collapsed file parses, and
   role_tagged_fraction >= 0.9.
4. capture B + diff — ``svc_stall`` directives burn shard 1's worker
   pool inside ``server._handle`` (time.sleep is C-level, so the
   sampled leaf is the handler frame itself — a deterministic injected
   hot frame); a second capture is pulled under the stall load and
   ``fleet_profile --diff A B`` must name ``server._handle`` top
   positive delta.
5. gap — a ``svc_prof_gap`` directive drops shard 0's next profile
   reply: fleet_profile exits 1 naming the missing process, the
   partial merge still lands, and the next pull heals (exit 0).

With ``--device cuda`` (the default; the card must exist) the source
ledger is sieved on the ``cuda`` backend (the fused kernel) and both
shards serve ``--backend cuda`` on that device; with ``--device cpu``
both use the reference's ``cpu-numpy``. Every query lies inside the
ledger, so the shards sieve no cold chunk. Before the banner the smoke
prints the device and the fused launches of this process and of the
shards, read over the ``metrics`` op before they stop.

Exit status: 0 on full parity (final line ``PROFILE_SMOKE_OK``), 1 on
any violation (with a FAIL line).

Usage: python -m sieve_torch.tools.profile_smoke [--n N] [--keep DIR] [--device D]
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
import threading
import time

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
PROF_HZ = "97"  # fast smoke beats; the always-on default is 19


def run_fleet_profile(args: list[str], env: dict) -> tuple[int, dict, str]:
    """Run ``python -m sieve_torch.tools.fleet_profile``; returns (rc,
    summary event, stdout)."""
    proc = subprocess.run(
        [sys.executable, "-m", "sieve_torch.tools.fleet_profile", *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    summary = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            summary = json.loads(ln)
    return proc.returncode, summary, proc.stdout


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

    from sieve_torch.checkpoint import Ledger
    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local
    from sieve_torch.kernels.cuda_mark import mark_fused
    from sieve_torch.service import ServiceClient

    launches0 = mark_fused.launches

    workdir = args.keep or tempfile.mkdtemp(prefix="profile_smoke.")
    src = os.path.join(workdir, "src")
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

        # --- phase 2: 1 replica per shard + router, sampler at 97 Hz ----
        env = dict(os.environ)

        def serve_args(d: str, range_lo: int) -> list[str]:
            a = [
                sys.executable, "-m", "sieve_torch", "serve",
                "--addr", "127.0.0.1:0", "--n", str(args.n),
                "--packing", "wheel30", "--segments", "8",
                "--checkpoint-dir", d, "--deadline-s", "10",
                "--drain-s", "10", "--quiet", "--allow-chaos",
                "--prof-hz", PROF_HZ,
                "--backend", backend, "--device", str(dev),
            ]
            if range_lo > 2:
                a += ["--range-lo", str(range_lo)]
            return a

        # both start together (each imports torch, or reaches the card),
        # so neither samples its profiler for longer than the other
        s0 = Proc(serve_args(dirs[0], 2), env, announce=False)
        s1 = Proc(serve_args(dirs[1], E), env, announce=False)
        procs.extend([s0, s1])
        s0.announce()
        s1.announce()
        router = Proc([
            sys.executable, "-m", "sieve_torch", "route",
            "--addr", "127.0.0.1:0", "--quiet", "--allow-chaos",
            "--deadline-s", "10", "--timeout-s", "15",
            "--prof-hz", PROF_HZ,
            "--shard", f"2:{E}={s0.addr}",
            "--shard", f"{E}:{args.n + 1}={s1.addr}",
        ], env)
        procs.append(router)
        expect("router announce event", router.serving["event"], "routing")
        cli = ServiceClient(router.addr, timeout_s=30)
        print(f"phase 2 OK: fleet up (router at {router.addr}, "
              f"sampler {PROF_HZ} Hz)", flush=True)

        # --- phase 3: induced load -> merged capture A ------------------
        def load(seconds: float) -> int:
            done = 0
            deadline = time.time() + seconds
            while time.time() < deadline:
                x = 5_000 + 9_000 * (done % 8)
                if not cli.query("pi", x=x).get("ok"):
                    fail(f"load pi({x}) failed")
                if not cli.query("count", lo=E + 10,
                                 hi=E + 2_000).get("ok"):
                    fail("load count failed")
                done += 1
            return done

        reqs = load(2.5)
        out_a = os.path.join(workdir, "cap_a")
        rc, summary, _ = run_fleet_profile(
            [router.addr, "--out", out_a], env)
        expect("capture A exit code", rc, 0)
        expect("capture A processes", summary.get("processes"), 3)
        expect("capture A unreachable", summary.get("unreachable"), [])
        frac = summary.get("role_tagged_fraction", 0.0)
        if frac < 0.9:
            fail(f"role-tagged fraction {frac} < 0.9 in capture A")
        collapsed = os.path.join(out_a, "fleet_profile.collapsed")
        with open(collapsed) as f:
            lines = [ln for ln in f.read().splitlines() if ln]
        if not lines:
            fail("capture A collapsed file is empty")
        for ln in lines:
            stack, _, count = ln.rpartition(" ")
            if not (stack and count.isdigit()):
                fail(f"malformed collapsed line: {ln!r}")
            if stack.split(";")[0] not in ("router", "shard0", "shard1"):
                fail(f"collapsed line missing process cell: {ln!r}")
        samples = summary.get("samples", 0)
        if samples < 50:
            fail(f"capture A holds only {samples} samples under load")
        print(f"phase 3 OK: {reqs} request rounds, merged capture A "
              f"({samples} samples, {len(lines)} stacks, "
              f"{frac:.0%} role-tagged)", flush=True)

        # --- phase 4: injected hot frame -> capture B + diff ------------
        # svc_stall burns a worker inside server._handle (time.sleep has
        # no Python frame of its own): the deterministic injected frame
        with ServiceClient(s1.addr, timeout_s=10) as c1:
            seq1 = c1.stats()["requests"]
            c1.inject_chaos(",".join(
                f"svc_stall:any@s{seq1 + j}:0.12" for j in range(1, 25)
            ))
        stall_done = threading.Event()

        def stall_load() -> None:
            with ServiceClient(router.addr, timeout_s=30) as c:
                for _ in range(24):
                    c.query("count", lo=E + 10, hi=E + 2_000)
            stall_done.set()

        t = threading.Thread(target=stall_load, daemon=True)
        t.start()
        time.sleep(1.2)  # sample mid-stall
        out_b = os.path.join(workdir, "cap_b")
        rc, summary, _ = run_fleet_profile(
            [router.addr, "--out", out_b], env)
        expect("capture B exit code", rc, 0)
        stall_done.wait(timeout=30)
        rc, diff_summary, diff_out = run_fleet_profile(
            ["--diff", os.path.join(out_a, "fleet_profile.json"),
             os.path.join(out_b, "fleet_profile.json"), "--top", "10"],
            env)
        expect("diff exit code", rc, 0)
        top = diff_summary.get("top_delta")
        if top != "server._handle":
            fail(f"injected hot frame not top positive delta: got {top!r} "
                 f"(diff table:\n{diff_out})")
        print("phase 4 OK: svc_stall burn surfaced as top positive "
              "delta server._handle", flush=True)

        # --- phase 5: svc_prof_gap -> partial merge, named, healed ------
        with ServiceClient(s0.addr, timeout_s=10) as c0:
            pulls0 = c0.stats()["profile_pulls"] \
                + c0.stats()["profile_gaps"]
            c0.inject_chaos(f"svc_prof_gap:any@s{pulls0 + 1}")
        out_c = os.path.join(workdir, "cap_c")
        rc, summary, _ = run_fleet_profile(
            [router.addr, "--out", out_c, "--timeout", "2"], env)
        expect("gapped capture exit code", rc, 1)
        expect("gapped capture names shard0",
               summary.get("unreachable"), ["shard0"])
        expect("gapped capture still merges the rest",
               summary.get("processes"), 2)
        if not os.path.exists(os.path.join(out_c,
                                           "fleet_profile.collapsed")):
            fail("partial merge wrote no collapsed file")
        out_d = os.path.join(workdir, "cap_d")
        rc, summary, _ = run_fleet_profile(
            [router.addr, "--out", out_d], env)
        expect("healed capture exit code", rc, 0)
        expect("healed capture processes", summary.get("processes"), 3)
        with ServiceClient(s0.addr, timeout_s=10) as c0:
            expect("shard0 counted the gap",
                   c0.stats()["profile_gaps"], 1)
        cli.close()
        print("phase 5 OK: gap dropped one reply (partial merge, exit 1, "
              "shard0 named), next pull healed", flush=True)
        child = [child_launches(s.addr) for s in (s0, s1)]
        own = mark_fused.launches - launches0
        print(launches_line(dev, own + sum(child),
                            f"(this process {own}, shards {child})"),
              flush=True)
        print("PROFILE_SMOKE_OK", flush=True)
        return 0
    finally:
        for pr in procs:
            pr.kill()
        if args.keep is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
