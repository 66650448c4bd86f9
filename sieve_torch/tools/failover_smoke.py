"""Failover smoke: the replicated query plane under a live writer, a
replica SIGKILL, injected refresh corruption, and a graceful drain —
every reply bit-exact or typed, never silent, never wrong. The port of
the reference's ``tools/failover_smoke.py``.

Builds a fully-sieved source dir, seeds a *serving* dir with only its
first segments, and drives the replication story end to end:

1. seed — sieve n into ``src``; copy the first 3 of 8 segments into the
   serving ledger a concurrent writer will keep extending.
2. replicas — two ``python -m sieve_torch serve`` subprocesses on the serving
   dir (``--refresh-s 0.15 --allow-chaos``), plus a :class:`ReplicaSet`
   client over both.
3. live load — a writer thread records the remaining segments every
   ~0.25 s while mixed queries run against the set; mid-load replica 1
   gets a ``replica_down`` window and then a real SIGKILL. Every reply
   must be oracle-exact or a typed overloaded / deadline_exceeded /
   degraded / draining error; a health monitor on replica 2 asserts
   ``covered_hi`` is nondecreasing and strictly grew (>= 1 refresh).
4. refresh corruption — ``svc_refresh_corrupt`` directives on replica
   2's next refresh attempts: ``refresh_failed`` rises, serving
   continues on the previous snapshot, and a later poll recovers.
5. drain — with a cold query in flight, replica 2 gets SIGTERM: the
   in-flight reply comes back exact, a queued follow-up on an open
   connection gets a typed ``draining``, and the process exits 0 with
   its "drained" line reporting a clean drain (zero dropped in-flight).

With ``--device cuda`` (the default; the card must exist) the source
ledger is sieved on the ``cuda`` backend (the fused kernel) and both
replicas serve ``--backend cuda`` on that device, so their cold chunks
run the fused kernel; with ``--device cpu`` both use the reference's
``cpu-numpy``. Before the banner the smoke prints the device and the
fused launches of this process and of the replicas, each replica's read
over the ``metrics`` op before it is stopped: replica 1's before its
SIGKILL, replica 2's before phase 5 (so its in-flight cold query there is
not counted).

Exit status: 0 on full parity, 1 on any violation (with a FAIL line).

Usage: python -m sieve_torch.tools.failover_smoke [--n N] [--keep DIR] [--device D]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import sys
import tempfile
import threading
import time

import numpy as np

from sieve_torch.tools import (
    Proc as Replica,
    SmokeFailure,
    child_launches,
    expect,
    fail,
    launches_line,
    smoke_device,
)

ORACLE_HI = 400_000
ALLOWED_ERRORS = {"overloaded", "deadline_exceeded", "degraded", "draining"}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=200_000)
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
    from sieve_torch.seed import seed_primes
    from sieve_torch.service import ReplicaSet, ServiceClient

    launches0 = mark_fused.launches
    child = {}  # replica index -> its fused launches, read before it stops

    P = seed_primes(ORACLE_HI)

    def o_pi(x: int) -> int:
        return int(np.searchsorted(P, x, side="right"))

    def o_count(lo: int, hi: int) -> int:
        return int(np.searchsorted(P, hi, side="left")
                   - np.searchsorted(P, lo, side="left"))

    def o_primes(lo: int, hi: int) -> list[int]:
        return [int(v) for v in P[(P >= lo) & (P < hi)]]

    def o_pairs(lo: int, hi: int, gap: int) -> int:
        w = P[(P >= lo) & (P < hi)]
        if w.size < 2:
            return 0
        idx = np.searchsorted(w, w + gap)
        ok = idx < w.size
        return int(np.count_nonzero(w[idx[ok]] == w[ok] + gap))

    workdir = args.keep or tempfile.mkdtemp(prefix="failover_smoke.")
    src = os.path.join(workdir, "src")
    serve_dir = os.path.join(workdir, "serving")
    reps: list[Replica] = []
    try:
        # --- phase 1: sieve src fully, seed the serving ledger -----------
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
        serve_cfg = dataclasses.replace(src_cfg, checkpoint_dir=serve_dir)
        wled = Ledger.open(serve_cfg)  # the live writer's ledger
        for r in segs[:3]:
            wled.record(r)
        print(f"phase 1 OK: serving ledger seeded with 3/8 segments "
              f"(covered_hi={segs[2].hi})", flush=True)

        # --- phase 2: two replicas + a ReplicaSet over both --------------
        env = dict(os.environ, SIEVE_SVC_COLD_DELAY_S="0.3")
        serve_args = [
            sys.executable, "-m", "sieve_torch", "serve",
            "--addr", "127.0.0.1:0", "--n", str(args.n),
            "--packing", "wheel30", "--segments", "8",
            "--checkpoint-dir", serve_dir, "--refresh-s", "0.15",
            "--drain-s", "10", "--allow-chaos", "--deadline-s", "10",
            "--quiet", "--backend", backend, "--device", str(dev),
        ]
        # both start together (each imports torch, or reaches the card)
        reps = [Replica(serve_args, env, announce=False) for _ in range(2)]
        for r in reps:
            r.announce()
        expect("replica 0 startup segments", reps[0].serving["segments"], 3)
        rs = ReplicaSet([r.addr for r in reps], timeout_s=30, rounds=4)
        expect("replica set sanity pi", rs.pi(50_000), o_pi(50_000))
        print(f"phase 2 OK: replicas at {reps[0].addr} / {reps[1].addr}",
              flush=True)

        # --- phase 3: live writer + chaos + SIGKILL under client load ----
        mon = ServiceClient(reps[1].addr, timeout_s=30)
        seen_hi: list[int] = []
        mon_stop = threading.Event()
        mon_errs: list[str] = []

        def monitor() -> None:
            while not mon_stop.is_set():
                h = mon.health()
                if seen_hi and h["covered_hi"] < seen_hi[-1]:
                    mon_errs.append(
                        f"covered_hi regressed {seen_hi[-1]} -> "
                        f"{h['covered_hi']}"
                    )
                seen_hi.append(h["covered_hi"])
                time.sleep(0.05)

        def writer() -> None:
            for r in segs[3:]:
                time.sleep(0.25)
                wled.record(r)

        tmon = threading.Thread(target=monitor, daemon=True)
        twr = threading.Thread(target=writer, daemon=True)
        tmon.start()
        twr.start()

        full_hi = segs[-1].hi
        wrong = 0
        typed: dict[str, int] = {}
        n_exact = 0
        plan = [
            ("pi", {"x": 50_000}, o_pi(50_000)),
            ("pi", {"x": args.n - 1}, o_pi(args.n - 1)),
            ("count", {"lo": 10_000, "hi": 60_000}, o_count(10_000, 60_000)),
            ("nth_prime", {"k": 1000}, int(P[999])),
            ("primes", {"lo": 70_000, "hi": 70_200}, o_primes(70_000, 70_200)),
            ("pi", {"x": 120_000}, o_pi(120_000)),
            ("count", {"lo": 2, "hi": 30_000, "kind": "twins"},
             o_pairs(2, 30_000, 2)),
        ]
        for i in range(36):
            op, params, want = plan[i % len(plan)]
            if i == 8:
                # a dead replica from the client's side: replica 1 drops
                # every connection without replying for 1 s. The directive
                # keys on the replica's request sequence number, which
                # tracks its admitted-request counter; a small spread
                # absorbs any drift between the two.
                with ServiceClient(reps[0].addr, timeout_s=10) as c:
                    seq = c.stats()["requests"]
                    c.inject_chaos(",".join(
                        f"replica_down:any@s{seq + j}:1.0"
                        for j in range(1, 7)
                    ))
            if i == 18:
                child[0] = child_launches(reps[0].addr)
                reps[0].kill()  # SIGKILL mid-load: hard replica loss
            rep = rs.query(op, **params)
            if rep.get("ok"):
                if want is not None and rep["value"] != want:
                    wrong += 1
                    print(f"WRONG: {op}{params} -> {rep['value']}, "
                          f"want {want}", flush=True)
                else:
                    n_exact += 1
            else:
                kind = rep.get("error")
                typed[kind] = typed.get(kind, 0) + 1
                if kind not in ALLOWED_ERRORS:
                    fail(f"untyped/unexpected error under load: {rep!r}")
            time.sleep(0.06)
        twr.join(timeout=30)
        if twr.is_alive():
            fail("writer thread hung")

        # replica 2 must catch up to the fully-written ledger; the monitor
        # thread still polls ``mon``, and a client is one socket that two
        # threads must not read at once, so this loop polls on its own
        with ServiceClient(reps[1].addr, timeout_s=30) as chk:
            deadline = time.monotonic() + 10
            while chk.health()["covered_hi"] < full_hi:
                if time.monotonic() > deadline:
                    fail(f"replica 2 never refreshed to covered_hi={full_hi} "
                         f"(at {chk.health()['covered_hi']})")
                time.sleep(0.1)
        mon_stop.set()
        tmon.join(timeout=5)
        if mon_errs:
            fail(f"monitor: {mon_errs[0]}")
        h = mon.health()
        if h["refreshes"] < 1:
            fail(f"replica 2 reported {h['refreshes']} refreshes, want >= 1")
        if not any(b > a for a, b in zip(seen_hi, seen_hi[1:])):
            fail("monitor never observed covered_hi strictly increase")
        if wrong:
            fail(f"{wrong} WRONG values under load")
        if n_exact < 20:
            fail(f"only {n_exact}/36 exact replies under load")
        if rs.failovers < 1:
            fail("ReplicaSet never failed over despite a killed replica")
        # post-refresh exactness on the survivor: the full range is hot now
        expect("post-refresh pi(n-1)", rs.pi(args.n - 1), o_pi(args.n - 1))
        print(f"phase 3 OK: {n_exact} exact, typed {typed}, "
              f"failovers={rs.failovers}, covered_hi {seen_hi[0]} -> "
              f"{seen_hi[-1]}, refreshes={h['refreshes']}", flush=True)

        # --- phase 4: injected refresh corruption is a skipped refresh ---
        s0 = mon.stats()
        att = s0["refresh_attempts"]
        mon.inject_chaos(f"svc_refresh_corrupt:any@s{att + 1}")
        wled.record(segs[-1])  # idempotent rewrite: moves the fingerprint
        deadline = time.monotonic() + 10
        while mon.stats()["refresh_failed"] <= s0["refresh_failed"]:
            if time.monotonic() > deadline:
                fail("svc_refresh_corrupt never produced a failed refresh")
            time.sleep(0.1)
        expect("covered_hi unchanged across corrupt refresh",
               mon.health()["covered_hi"], full_hi)
        expect("still exact across corrupt refresh", mon.pi(90_000),
               o_pi(90_000))
        # the follower retries and recovers once the directive is consumed
        deadline = time.monotonic() + 10
        while mon.stats()["refresh_attempts"] <= att + 1:
            if time.monotonic() > deadline:
                fail("follower never retried after the corrupt refresh")
            time.sleep(0.1)
        print(f"phase 4 OK: corrupt refresh skipped "
              f"(refresh_failed={mon.stats()['refresh_failed']}), serving "
              f"uninterrupted", flush=True)

        # --- phase 5: graceful drain loses zero in-flight answers --------
        child[1] = child_launches(reps[1].addr)
        inflight_cli = ServiceClient(reps[1].addr, timeout_s=30)
        queued_cli = ServiceClient(reps[1].addr, timeout_s=30)
        want_cold = o_pi(390_000)
        box: dict = {}

        def fire() -> None:
            try:
                box["reply"] = inflight_cli.query("pi", x=390_000)
            except BaseException as e:  # noqa: BLE001 — checked below
                box["err"] = e

        t = threading.Thread(target=fire)
        t.start()
        time.sleep(0.15)  # inside the 0.3 s simulated cold latency
        reps[1].proc.send_signal(signal.SIGTERM)
        time.sleep(0.1)
        shed = queued_cli.query("pi", x=1000)
        if shed.get("ok") or shed.get("error") != "draining":
            fail(f"query after SIGTERM: want typed draining, got {shed!r}")
        t.join(timeout=30)
        if t.is_alive():
            fail("in-flight query hung across drain")
        if "err" in box:
            fail(f"in-flight query dropped during drain: {box['err']!r}")
        expect("in-flight reply across drain", box["reply"].get("value"),
               want_cold)
        rc = reps[1].proc.wait(timeout=30)
        expect("drained replica exit code", rc, 0)
        drained = [json.loads(l) for l in reps[1].lines
                   if '"drained"' in l]
        if not drained or not drained[0].get("clean"):
            fail(f"no clean 'drained' line from replica 2: {reps[1].lines}")
        inflight_cli.close()
        queued_cli.close()
        mon.close()
        rs.close()
        print("phase 5 OK: in-flight exact, new query typed draining, "
              "exit 0, drain clean", flush=True)
        own = mark_fused.launches - launches0
        print(launches_line(dev, own + child[0] + child[1],
                            f"(this process {own}, replica 1 {child[0]}, "
                            f"replica 2 {child[1]})"), flush=True)
        print("FAILOVER_SMOKE_OK", flush=True)
        return 0
    finally:
        for r in reps:
            r.kill()
        if args.keep is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
