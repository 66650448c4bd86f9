"""Shard smoke: the range-sharded router fabric under an oracle sweep
across the shard edge, a mid-load shard-replica SIGKILL, a whole-shard
outage, recovery, and an injected ``svc_shard_down`` window — every
reply bit-exact or typed, never silent, never wrong. The port of the
reference's ``tools/shard_smoke.py``.

Builds a fully-sieved source dir, splits its segments into two shard
ledgers at a segment boundary E, and drives the fabric end to end:

1. seed — sieve n into ``src``; segments below E go to the shard-0
   ledger, the rest to shard 1's.
2. fabric — 2 shards x 2 replicas (four ``python -m sieve_torch serve``
   subprocesses; shard 1's run with ``--range-lo E``) fronted by one
   ``python -m sieve_torch route`` subprocess. An oracle sweep crosses the
   edge: pi / count / twins / cousins straddling E, nth_prime across
   the cumulative boundary, primes concatenated across shards,
   is_prime on both sides. Scatter-gather must cache both full-shard
   totals.
3. failover — SIGKILL one shard-1 replica mid-load; every reply stays
   oracle-exact and the router's per-shard ReplicaSet records >= 1
   failover.
4. outage — SIGKILL the surviving shard-1 replica: a query needing
   shard 1 gets a typed ``unavailable`` NAMING the shard (index +
   range), while shard-0-only queries — and pi(n), answerable from
   cached immutable totals — stay exact.
5. recovery — restart one shard-1 replica on its old address; the
   router fails back over and edge queries go exact again.
6. chaos — a wire-injected ``svc_shard_down`` window holds shard 0
   unreachable: shard-1 point queries stay exact, shard-0 queries get
   the typed ``unavailable``, and after the window expires the fabric
   recovers with zero restarts.

With ``--device cuda`` (the default; the card must exist) the source
ledger is sieved on the ``cuda`` backend (the fused kernel) and the four
shard replicas serve ``--backend cuda`` on that device; with ``--device
cpu`` both use the reference's ``cpu-numpy``. Every query of the sweep
lies inside the ledger, so the replicas sieve no cold chunk. Before the
banner the smoke prints the device and the fused launches of this
process and of the replicas, each replica's read over the ``metrics`` op
before it is stopped.

Exit status: 0 on full parity (final line ``SHARD_SMOKE_OK``), 1 on
any violation (with a FAIL line).

Usage: python -m sieve_torch.tools.shard_smoke [--n N] [--keep DIR] [--device D]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from sieve_torch.tools import (
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
    from sieve_torch.service import ServiceClient

    launches0 = mark_fused.launches
    child = []  # each stopped replica's fused launches, read before it stops

    def stop(replica: Proc) -> None:
        child.append(child_launches(replica.addr))
        replica.kill()

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

    workdir = args.keep or tempfile.mkdtemp(prefix="shard_smoke.")
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

        # --- phase 2: 2 shards x 2 replicas + router, oracle edge sweep --
        env = dict(os.environ)

        def serve_args(d: str, range_lo: int, addr: str) -> list[str]:
            a = [
                sys.executable, "-m", "sieve_torch", "serve",
                "--addr", addr, "--n", str(args.n),
                "--packing", "wheel30", "--segments", "8",
                "--checkpoint-dir", d, "--deadline-s", "10",
                "--drain-s", "10", "--quiet",
                "--backend", backend, "--device", str(dev),
            ]
            if range_lo > 2:
                a += ["--range-lo", str(range_lo)]
            return a

        # the four start together (each imports torch, or reaches the card)
        s0 = [Proc(serve_args(dirs[0], 2, "127.0.0.1:0"), env, announce=False)
              for _ in range(2)]
        s1 = [Proc(serve_args(dirs[1], E, "127.0.0.1:0"), env, announce=False)
              for _ in range(2)]
        procs.extend(s0 + s1)
        for pr in s0 + s1:
            pr.announce()
        router = Proc([
            sys.executable, "-m", "sieve_torch", "route",
            "--addr", "127.0.0.1:0", "--allow-chaos", "--quiet",
            "--deadline-s", "10", "--timeout-s", "15",
            "--shard", f"2:{E}={s0[0].addr},{s0[1].addr}",
            "--shard", f"{E}:{args.n + 1}={s1[0].addr},{s1[1].addr}",
        ], env)
        procs.append(router)
        expect("router announce event", router.serving["event"], "routing")
        cli = ServiceClient(router.addr, timeout_s=30)

        k_mid = o_pi(E - 1) + 50  # an nth_prime served by shard 1
        sweep = [
            ("pi", {"x": args.n}, o_pi(args.n)),
            ("pi", {"x": E - 1}, o_pi(E - 1)),
            ("pi", {"x": E}, o_pi(E)),
            ("pi", {"x": E + 1}, o_pi(E + 1)),
            ("count", {"lo": E - 500, "hi": E + 500}, o_count(E - 500, E + 500)),
            ("count", {"lo": E - 500, "hi": E + 500, "kind": "twins"},
             o_pairs(E - 500, E + 500, 2)),
            ("count", {"lo": E - 500, "hi": E + 500, "kind": "cousins"},
             o_pairs(E - 500, E + 500, 4)),
            ("count", {"lo": 2, "hi": args.n + 1, "kind": "twins"},
             o_pairs(2, args.n + 1, 2)),
            ("nth_prime", {"k": k_mid}, int(P[k_mid - 1])),
            ("primes", {"lo": E - 100, "hi": E + 100}, o_primes(E - 100, E + 100)),
            ("is_prime", {"x": int(P[o_pi(E)])}, True),
            ("is_prime", {"x": int(P[o_pi(E)]) + 1}, False),
        ]
        for op, params, want in sweep:
            rep = cli.query(op, **params)
            if not rep.get("ok"):
                fail(f"edge sweep {op}{params}: typed {rep!r}")
            expect(f"edge sweep {op}{params}", rep["value"], want)
        st = cli.stats()
        expect("full-shard totals cached", st["totals_cached"], 2)
        print(f"phase 2 OK: {len(sweep)} edge queries exact "
              f"(router at {router.addr}, totals_cached=2)", flush=True)

        # --- phase 3: SIGKILL one shard-1 replica mid-load ---------------
        plan = [
            ("count", {"lo": E + 10, "hi": E + 2000}, o_count(E + 10, E + 2000)),
            ("is_prime", {"x": int(P[k_mid])}, True),
            ("count", {"lo": E - 300, "hi": E + 300, "kind": "twins"},
             o_pairs(E - 300, E + 300, 2)),
            ("primes", {"lo": E - 50, "hi": E + 50}, o_primes(E - 50, E + 50)),
        ]
        for i in range(12):
            if i == 3:
                stop(s1[0])  # hard shard-replica loss mid-load
            op, params, want = plan[i % len(plan)]
            rep = cli.query(op, **params)
            if not rep.get("ok"):
                fail(f"failover load {op}{params}: typed {rep!r}")
            expect(f"failover load {op}{params}", rep["value"], want)
        st = cli.stats()
        if st["failovers"] < 1:
            fail(f"router never failed over (stats {st['failovers']})")
        print(f"phase 3 OK: 12 exact under replica loss, "
              f"failovers={st['failovers']}", flush=True)

        # --- phase 4: whole shard down -> typed unavailable, named ------
        stop(s1[1])
        rep = cli.query("count", lo=E + 10, hi=E + 2000)
        expect("whole-shard-down error kind", rep.get("error"), "unavailable")
        expect("unavailable names the shard", rep.get("shard"), 1)
        expect("unavailable carries the range", rep.get("shard_range"),
               [E, args.n + 1])
        if "shard 1" not in rep.get("detail", ""):
            fail(f"unavailable detail does not name shard 1: {rep!r}")
        # shard-0-only queries keep answering exact through the outage,
        # and pi(n) still composes from the cached immutable totals
        expect("shard-0 query during outage", cli.query(
            "count", lo=10_000, hi=60_000)["value"], o_count(10_000, 60_000))
        expect("pi(n) from cached totals during outage",
               cli.query("pi", x=args.n)["value"], o_pi(args.n))
        print("phase 4 OK: whole-shard outage typed unavailable "
              "(shard 1 named), shard 0 + cached totals exact", flush=True)

        # --- phase 5: restart a shard-1 replica on its old addr ---------
        s1[0] = Proc(serve_args(dirs[1], E, s1[0].addr), env)
        procs.append(s1[0])
        deadline = time.monotonic() + 20
        while True:
            rep = cli.query("count", lo=E + 10, hi=E + 2000)
            if rep.get("ok"):
                expect("post-recovery count", rep["value"],
                       o_count(E + 10, E + 2000))
                break
            if time.monotonic() > deadline:
                fail(f"router never recovered after restart: {rep!r}")
            time.sleep(0.2)
        print("phase 5 OK: restarted replica picked back up, edge exact",
              flush=True)

        # --- phase 6: injected svc_shard_down window on shard 0 ---------
        seq = cli.stats()["requests"]
        cli.inject_chaos(",".join(
            f"svc_shard_down:0@s{seq + j}:1.5" for j in range(1, 3)
        ))
        # the next request draws the directive and opens the window; a
        # shard-1 point query is untouched by a shard-0 outage. pi(E-1)
        # would STILL answer (cached immutable total), so the probe is a
        # partial-range count that must contact shard 0.
        expect("shard-1 point query inside window", cli.query(
            "is_prime", x=int(P[k_mid]))["value"], True)
        rep = cli.query("count", lo=10_000, hi=60_000)  # needs shard 0
        expect("windowed shard-0 error kind", rep.get("error"), "unavailable")
        expect("windowed shard named", rep.get("shard"), 0)
        st = cli.stats()
        if st["shard_down_windows"] < 1:
            fail(f"no shard_down window recorded: {st!r}")
        time.sleep(1.6)  # let the window expire
        deadline = time.monotonic() + 10
        while True:
            rep = cli.query("count", lo=10_000, hi=60_000)
            if rep.get("ok"):
                expect("post-window count", rep["value"],
                       o_count(10_000, 60_000))
                break
            if time.monotonic() > deadline:
                fail(f"fabric never recovered after the window: {rep!r}")
            time.sleep(0.2)
        cli.close()
        for replica in (*s0, s1[0]):
            stop(replica)
        print("phase 6 OK: svc_shard_down window typed + scoped, fabric "
              "recovered with zero restarts", flush=True)
        own = mark_fused.launches - launches0
        print(launches_line(dev, own + sum(child),
                            f"(this process {own}, replicas {child})"),
              flush=True)
        print("SHARD_SMOKE_OK", flush=True)
        return 0
    finally:
        for pr in procs:
            pr.kill()
        if args.keep is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
