"""Service smoke: the query server under composed chaos, oracle-exact
or typed — never silent, never wrong. The port of the reference's
``tools/service_smoke.py``.

Builds a sieved checkpoint dir, starts a :class:`SieveService` on it,
and drives real TCP clients through seven phases:

1. correctness sweep — every op (pi / count / nth_prime / primes) hot,
   cold, and straddling the covered boundary, bit-exact against a
   cpu-numpy oracle; malformed requests get typed ``bad_request``.
2. hot repeat — the same interior query five times: the index-hit
   counter must rise while the cold-compute counter stays flat
   (answered from the index, nothing re-sieved).
3. coalescing — two overlapping cold queries staggered inside the
   simulated backend latency: the follower must coalesce onto the
   leader's flight and both replies must be exact.
4. composed chaos — an injected ``backend_down`` window plus
   ``svc_stall`` (beyond the deadline) plus ``svc_shed``, then 10
   concurrent mixed queries: every reply is either oracle-exact or a
   typed overloaded / deadline_exceeded / degraded error. Health stays
   observable and hot queries stay exact while the backend is down.
5. recovery — health returns to ok and a cold query is exact again.
6. batched burst + write-back — a fresh ``--persist-cold``
   server on the same dir takes 20 concurrent cold queries: every reply
   oracle-exact, the dispatch counter stays at or below the distinct
   grid chunks touched (single-digit, not 20), and the results land in
   the ledger — a restarted server answers the same burst entirely from
   its index (zero cold computes).
7. priority lanes under flood — a pristine copy of the
   checkpoint dir serves a 20-thread cold flood concurrent with a hot
   stream: hot p95 stays within 5x the unloaded hot p95 (with a small
   absolute floor below which 5x is scheduler jitter), every cold query
   terminates oracle-exact or with a typed reply, cold-lane sheds carry
   ``lane: "cold"``, and the per-lane stats/health fields are live.

With ``--device cuda`` (the default; the card must exist) the ledger is
sieved and every cold chunk served on the ``cuda`` backend, so the fused
kernel runs under ``ColdBackend._lock``; with ``--device cpu`` both use
the reference's ``cpu-numpy``. Before the banner the smoke prints the
device and this process's fused launches, and, under
``SIEVE_LOCK_DEBUG=1``, the observed lock orders checked against the
canonical order.

Exit status: 0 on full parity, 1 on any violation (with a FAIL line).

Usage: python -m sieve_torch.tools.service_smoke [--n N] [--keep DIR] [--device D]
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from sieve_torch.tools import (
    SmokeFailure,
    assert_lock_orders as _assert_lock_orders,
    expect,
    fail,
    launches_line,
    smoke_device,
)

ORACLE_HI = 400_000
ALLOWED_CHAOS_ERRORS = {"overloaded", "deadline_exceeded", "degraded"}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--keep", default=None,
                   help="use (and keep) this checkpoint dir instead of a "
                        "temp dir")
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

    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local
    from sieve_torch.kernels.cuda_mark import mark_fused
    from sieve_torch.seed import seed_primes
    from sieve_torch.service import ServiceClient, ServiceSettings, SieveService

    launches0 = mark_fused.launches
    # numpy oracle: one flat prime table, every answer derived from it
    P = seed_primes(ORACLE_HI)

    def o_pi(x: int) -> int:
        return int(np.searchsorted(P, x, side="right"))

    def o_count(lo: int, hi: int) -> int:
        return int(np.searchsorted(P, hi, side="left")
                   - np.searchsorted(P, lo, side="left"))

    def o_pairs(lo: int, hi: int, gap: int) -> int:
        w = P[(P >= lo) & (P < hi)]
        if w.size < 2:
            return 0
        idx = np.searchsorted(w, w + gap)
        ok = idx < w.size
        return int(np.count_nonzero(w[idx[ok]] == w[ok] + gap))

    def o_primes(lo: int, hi: int) -> list[int]:
        return [int(v) for v in P[(P >= lo) & (P < hi)]]

    workdir = args.keep or tempfile.mkdtemp(prefix="service_smoke.")
    workdir7 = workdir.rstrip("/") + ".lanes"
    svc = None
    try:
        cfg = SieveConfig(
            n=args.n, backend=backend, device=str(dev), packing="wheel30",
            n_segments=4, quiet=True, checkpoint_dir=workdir,
        )
        print(f"phase 0: sieving checkpoint dir (n={args.n})", flush=True)
        run_local(cfg)
        # phase 6 persists cold results into workdir's ledger; phase 7
        # needs the pristine coverage, so snapshot the dir now
        shutil.rmtree(workdir7, ignore_errors=True)
        shutil.copytree(workdir, workdir7)

        # small cold chunks + a simulated 0.3 s backend latency make the
        # coalescing and shed scenarios deterministic at this scale
        settings = ServiceSettings(
            workers=4, queue_limit=32, default_deadline_s=10.0,
            cold_chunk=1 << 17, cold_delay_s=0.3,
            wire_chaos=True,  # phase 4 injects faults over the wire
        )
        svc = SieveService(cfg, settings).start()
        cli = ServiceClient(svc.addr, timeout_s=30)
        covered = svc.index.covered_hi
        total = svc.index.total_primes
        expect("indexed total_primes", total, o_pi(covered - 1))
        print(f"phase 0 OK: serving {svc.addr}, covered_hi={covered}, "
              f"total_primes={total}", flush=True)

        # --- phase 1: every op, hot / cold / straddling, oracle-exact ----
        expect("pi(0)", cli.pi(0), 0)
        expect("pi(2)", cli.pi(2), 1)
        expect("pi hot interior", cli.pi(100_000), o_pi(100_000))
        expect("pi hot boundary", cli.pi(covered - 1), o_pi(covered - 1))
        expect("pi cold", cli.pi(350_000), o_pi(350_000))
        expect("count hot", cli.count(0, args.n), o_count(0, args.n))
        expect("count fully cold", cli.count(250_000, 300_000),
               o_count(250_000, 300_000))
        expect("count lo==hi", cli.count(1000, 1000), 0)
        expect("count twins hot", cli.count(1000, 50_000, "twins"),
               o_pairs(1000, 50_000, 2))
        expect("count cousins hot", cli.count(1000, 50_000, "cousins"),
               o_pairs(1000, 50_000, 4))
        expect("count twins straddling",
               cli.count(190_000, 210_000, "twins"),
               o_pairs(190_000, 210_000, 2))
        expect("nth_prime(5)", cli.nth_prime(5), 11)
        expect("nth_prime in index", cli.nth_prime(1000), int(P[999]))
        expect("nth_prime beyond index", cli.nth_prime(total + 500),
               int(P[total + 499]))
        expect("primes straddling", cli.primes(199_990, 200_010),
               o_primes(199_990, 200_010))
        expect("primes tiny window", cli.primes(13, 14), [13])
        for desc, msg in [
            ("pi non-int", {"op": "pi", "x": "nope"}),
            ("count hi<lo", {"op": "count", "lo": 10, "hi": 5}),
            ("count bad kind", {"op": "count", "lo": 2, "hi": 10,
                                "kind": "sexy"}),
            ("nth_prime k=0", {"op": "nth_prime", "k": 0}),
            ("unknown op", {"op": "frobnicate"}),
        ]:
            r = cli.query(**msg)
            if r.get("ok") or r.get("error") != "bad_request":
                fail(f"{desc}: expected typed bad_request, got {r!r}")
        print("phase 1 OK: all ops oracle-exact, bad requests typed",
              flush=True)

        # --- phase 2: hot repeat answers from the index, no re-sieve -----
        s0 = cli.stats()
        want = o_pi(150_000)
        for _ in range(5):
            expect("hot repeat pi(150000)", cli.pi(150_000), want)
        s1 = cli.stats()
        hits = s1["index_hits"] - s0["index_hits"]
        if hits < 4:
            fail(f"hot repeats: index_hits rose by {hits}, want >= 4")
        if s1["cold_computes"] != s0["cold_computes"]:
            fail("hot repeats triggered cold computes "
                 f"({s0['cold_computes']} -> {s1['cold_computes']})")
        print(f"phase 2 OK: 5 hot repeats, +{hits} index hits, "
              f"0 cold computes", flush=True)

        # --- phase 3: overlapping cold queries coalesce ------------------
        s0 = cli.stats()
        want = o_pi(390_000)
        got: list[int] = []
        errs: list[BaseException] = []

        def q() -> None:
            try:
                with ServiceClient(svc.addr, timeout_s=30) as c:
                    got.append(c.pi(390_000))
            except BaseException as e:  # noqa: BLE001 — surfaced via fail
                errs.append(e)

        t1, t2 = threading.Thread(target=q), threading.Thread(target=q)
        t1.start()
        time.sleep(0.12)  # inside the leader's 0.3 s simulated latency
        t2.start()
        t1.join(25)
        t2.join(25)
        if t1.is_alive() or t2.is_alive():
            fail("coalescing query hung (silent hang)")
        if errs:
            fail(f"coalescing query errored: {errs[0]!r}")
        expect("coalesced values", got, [want, want])
        s1 = cli.stats()
        if s1["coalesced"] - s0["coalesced"] < 1:
            fail("overlapping cold queries did not coalesce")
        print(f"phase 3 OK: follower coalesced "
              f"(+{s1['coalesced'] - s0['coalesced']}), both exact",
              flush=True)

        # --- phase 4: composed chaos -------------------------------------
        # backend_down on the next query opens a 2.5 s degraded window;
        # that query needs a fresh cold chunk so it must come back as a
        # typed degraded reply while hot queries keep answering exactly.
        cli.inject_chaos(f"backend_down:any@s{svc._seq + 1}:2.5")
        r = cli.query("count", lo=395_000, hi=398_000)
        if r.get("ok") or r.get("error") != "degraded":
            fail(f"cold query during backend_down: want typed degraded, "
                 f"got {r!r}")
        expect("health while degraded", cli.health()["status"], "degraded")
        expect("hot pi while degraded", cli.pi(100_000), o_pi(100_000))

        batch = [
            ("pi hot a", {"op": "pi", "x": 120_000}, o_pi(120_000)),
            ("pi hot b", {"op": "pi", "x": 50_000}, o_pi(50_000)),
            ("pi cold", {"op": "pi", "x": 370_000}, o_pi(370_000)),
            ("count hot", {"op": "count", "lo": 10_000, "hi": 90_000},
             o_count(10_000, 90_000)),
            ("twins hot", {"op": "count", "lo": 2, "hi": 30_000,
                           "kind": "twins"}, o_pairs(2, 30_000, 2)),
            ("nth in-index", {"op": "nth_prime", "k": 2000}, int(P[1999])),
            ("nth beyond", {"op": "nth_prime", "k": total + 100},
             int(P[total + 99])),
            ("primes hot", {"op": "primes", "lo": 150_000, "hi": 150_500},
             o_primes(150_000, 150_500)),
            ("primes straddle", {"op": "primes", "lo": 199_900,
                                 "hi": 200_100},
             o_primes(199_900, 200_100)),
            ("count hot big", {"op": "count", "lo": 2, "hi": 200_000},
             o_count(2, 200_000)),
        ]
        # one stall beyond the 1 s per-request deadline, one forced shed,
        # landing on two of the 10 upcoming sequence numbers
        seq = svc._seq
        cli.inject_chaos(f"svc_stall:any@s{seq + 3}:1.5")
        cli.inject_chaos(f"svc_shed:any@s{seq + 6}")
        replies: dict[str, dict] = {}
        rep_lock = threading.Lock()

        def fire(desc: str, msg: dict) -> None:
            try:
                with ServiceClient(svc.addr, timeout_s=30) as c:
                    op = msg.pop("op")
                    rep = c.query(op, deadline_s=1.0, **msg)
            except BaseException as e:  # noqa: BLE001
                rep = {"ok": False, "error": "transport",
                       "detail": repr(e)}
            with rep_lock:
                replies[desc] = rep

        threads = [
            threading.Thread(target=fire, args=(d, dict(m)))
            for d, m, _ in batch
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        if any(t.is_alive() for t in threads):
            fail("chaos batch query hung (silent hang)")
        expect("health during chaos batch", cli.health()["ok"], True)

        n_ok = 0
        tally: dict[str, int] = {}
        for desc, _, want in batch:
            rep = replies[desc]
            if rep.get("ok"):
                n_ok += 1
                expect(f"chaos batch {desc}", rep["value"], want)
            else:
                err = rep.get("error")
                tally[err] = tally.get(err, 0) + 1
                if err not in ALLOWED_CHAOS_ERRORS:
                    fail(f"chaos batch {desc}: untyped/unexpected error "
                         f"{rep!r}")
                if err == "deadline_exceeded" and not isinstance(
                        rep.get("partial"), dict):
                    fail(f"chaos batch {desc}: deadline_exceeded without "
                         f"a partial prefix: {rep!r}")
        if n_ok < 1:
            fail("chaos batch: no query survived — server not serving")
        if tally.get("overloaded", 0) < 1:
            fail(f"chaos batch: injected svc_shed produced no typed "
                 f"overloaded reply (errors: {tally})")
        if tally.get("deadline_exceeded", 0) < 1:
            fail(f"chaos batch: injected svc_stall produced no typed "
                 f"deadline_exceeded reply (errors: {tally})")
        print(f"phase 4 OK: {n_ok}/{len(batch)} exact, "
              f"typed errors {tally}", flush=True)

        # --- phase 5: recovery -------------------------------------------
        deadline = time.monotonic() + 10
        while cli.health()["status"] != "ok":
            if time.monotonic() > deadline:
                fail("health never recovered after backend_down window")
            time.sleep(0.1)
        expect("cold count after recovery", cli.count(395_000, 398_000),
               o_count(395_000, 398_000))
        s = cli.stats()
        if s["internal_errors"] != 0:
            fail(f"{s['internal_errors']} internal errors during smoke")
        for key in ("index_hits", "coalesced", "shed", "deadline_exceeded",
                    "degraded_replies"):
            if s[key] < 1:
                fail(f"stats[{key!r}] == 0 after smoke; scenario not "
                     f"exercised")
        print(f"phase 5 OK: recovered, cold exact again "
              f"(index_hits={s['index_hits']} "
              f"cold_computes={s['cold_computes']} "
              f"coalesced={s['coalesced']} shed={s['shed']})", flush=True)
        cli.close()
        svc.stop()

        # --- phase 6: batched burst + ledger write-back --------------------
        # A fresh server with --persist-cold semantics on the SAME dir:
        # its cold cache is empty, so a 20-thread burst over uncovered
        # ranges must be answered by the batcher in a handful of backend
        # dispatches, and the results must be durable in the ledger.
        settings6 = ServiceSettings(
            workers=8, queue_limit=32, default_deadline_s=15.0,
            cold_chunk=1 << 17, cold_delay_s=0.2, refresh_s=0.2,
            persist_cold=True,
        )
        svc = SieveService(cfg, settings6).start()
        burst = (
            [("pi", {"x": 390_000}, o_pi(390_000))] * 10
            + [("pi", {"x": 300_000}, o_pi(300_000))] * 5
            + [("count", {"lo": 250_000, "hi": 350_000},
                o_count(250_000, 350_000))] * 5
        )
        # distinct grid chunks the burst can touch: targets {250000,
        # 300001, 350000, 390001} past covered_hi split at the single
        # 1<<17 grid boundary in range -> 5 distinct (lo, hi) keys
        max_chunks = 5

        def fire6(i: int, op: str, params: dict, want, out: dict,
                  lock: threading.Lock) -> None:
            try:
                with ServiceClient(svc.addr, timeout_s=30) as c:
                    rep = c.query(op, **params)
            except BaseException as e:  # noqa: BLE001
                rep = {"ok": False, "error": "transport", "detail": repr(e)}
            with lock:
                out[i] = (rep, want)

        out6: dict[int, tuple] = {}
        lock6 = threading.Lock()
        threads = [
            threading.Thread(target=fire6, args=(i, op, dict(ps), want,
                                                 out6, lock6))
            for i, (op, ps, want) in enumerate(burst)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(40)
        if any(t.is_alive() for t in threads):
            fail("batched burst query hung (silent hang)")
        for i, (rep, want) in sorted(out6.items()):
            if not rep.get("ok"):
                fail(f"batched burst query {i}: {rep!r}")
            expect(f"batched burst query {i}", rep["value"], want)
        with ServiceClient(svc.addr, timeout_s=10) as c6:
            s6 = c6.stats()
        if not (1 <= s6["cold_dispatches"] <= max_chunks):
            fail(f"burst of {len(burst)} cold queries took "
                 f"{s6['cold_dispatches']} backend dispatches, want 1.."
                 f"{max_chunks} (batching not happening)")
        if s6["cold_batched_chunks"] > max_chunks:
            fail(f"burst dispatched {s6['cold_batched_chunks']} chunks, "
                 f"want <= {max_chunks} (single-flight dedup broken)")
        if s6["cold_persisted"] < 1:
            fail("persist_cold server wrote nothing back to the ledger")
        print(f"phase 6a OK: 20-query cold burst -> "
              f"{s6['cold_dispatches']} dispatches over "
              f"{s6['cold_batched_chunks']} chunks, "
              f"{s6['cold_persisted']} persisted", flush=True)

        # restart: a brand-new server on the same dir must answer the
        # whole burst from its (now extended) index — zero cold computes
        svc.stop()
        svc = SieveService(cfg, ServiceSettings(
            workers=4, queue_limit=32, default_deadline_s=15.0,
            cold_chunk=1 << 17, cold_delay_s=0.2,
        )).start()
        with ServiceClient(svc.addr, timeout_s=30) as c6:
            for op, ps, want in burst:
                expect(f"post-restart {op}{ps}",
                       c6.query(op, **ps).get("value"), want)
            s6 = c6.stats()
        if s6["cold_computes"] != 0 or s6["cold_dispatches"] != 0:
            fail(f"restarted server re-sieved persisted ranges "
                 f"(cold_computes={s6['cold_computes']}, "
                 f"cold_dispatches={s6['cold_dispatches']})")
        print(f"phase 6b OK: restart answered the burst from the "
              f"persisted index (covered_hi={svc.index.covered_hi}, "
              f"0 cold computes)", flush=True)
        svc.stop()

        # --- phase 7: priority lanes under a cold flood -------------------
        # A server on the pristine dir (covered_hi = n+1): 20 flood
        # threads issue distinct cold queries (each needs a backend
        # dispatch behind the 0.25 s saturation delay) while a hot
        # stream runs concurrently. The dedicated hot worker + the
        # bounded cold lane must keep hot p95 within 5x its unloaded
        # value, and every cold reply must be exact or typed.
        cfg7 = SieveConfig(
            n=args.n, backend=backend, device=str(dev), packing="wheel30",
            n_segments=4, quiet=True, checkpoint_dir=workdir7,
        )
        settings7 = ServiceSettings(
            workers=4, hot_workers=1, queue_limit=64, cold_queue_limit=8,
            default_deadline_s=20.0, cold_chunk=1 << 17, cold_delay_s=0.25,
            cold_age_s=0.5, refresh_s=0.0,
        )
        svc = SieveService(cfg7, settings7).start()

        def pctile(vals: list[float], q: float) -> float:
            vs = sorted(vals)
            return vs[max(0, int(len(vs) * q + 0.999999) - 1)]

        hot_x = [10_000 + 3_500 * i for i in range(40)]  # all < n: hot
        with ServiceClient(svc.addr, timeout_s=30) as c7:
            unloaded: list[float] = []
            for x in hot_x:
                t0 = time.monotonic()
                expect(f"phase 7 unloaded pi({x})", c7.pi(x), o_pi(x))
                unloaded.append(time.monotonic() - t0)
            p95_unloaded = pctile(unloaded, 0.95)

            cold_replies: dict[int, dict] = {}
            cl_lock = threading.Lock()

            def flood(i: int) -> None:
                # distinct targets -> distinct clipped grid chunks, so
                # the flood keeps the cold plane genuinely busy
                x = 210_000 + 8_900 * i
                try:
                    with ServiceClient(svc.addr, timeout_s=60) as c:
                        rep = c.query("pi", x=x)
                except BaseException as e:  # noqa: BLE001
                    rep = {"ok": False, "error": "transport",
                           "detail": repr(e)}
                with cl_lock:
                    cold_replies[i] = (x, rep)

            flood_threads = [threading.Thread(target=flood, args=(i,))
                             for i in range(20)]
            for t in flood_threads:
                t.start()
            loaded: list[float] = []
            for _ in range(3):  # hot stream concurrent with the flood
                for x in hot_x:
                    t0 = time.monotonic()
                    expect(f"phase 7 hot-under-flood pi({x})",
                           c7.pi(x), o_pi(x))
                    loaded.append(time.monotonic() - t0)
            for t in flood_threads:
                t.join(90)
            if any(t.is_alive() for t in flood_threads):
                fail("phase 7: cold flood query hung (silent parking)")
            p95_loaded = pctile(loaded, 0.95)
            # the 5x acceptance bound, with an absolute floor: below
            # ~25 ms, 5x an unloaded sub-ms p95 is scheduler jitter
            bound = max(5 * p95_unloaded, 0.025)
            if p95_loaded > bound:
                fail(f"phase 7: hot p95 under flood {p95_loaded * 1e3:.2f}"
                     f" ms exceeds bound {bound * 1e3:.2f} ms "
                     f"(unloaded p95 {p95_unloaded * 1e3:.2f} ms)")
            tally7: dict[str, int] = {}
            for i, (x, rep) in sorted(cold_replies.items()):
                if rep.get("ok"):
                    tally7["ok"] = tally7.get("ok", 0) + 1
                    expect(f"phase 7 cold pi({x})", rep["value"], o_pi(x))
                    continue
                err = rep.get("error")
                tally7[err] = tally7.get(err, 0) + 1
                if err not in ALLOWED_CHAOS_ERRORS:
                    fail(f"phase 7 cold pi({x}): untyped/unexpected "
                         f"error {rep!r}")
                if err == "overloaded" and rep.get("lane") != "cold":
                    fail(f"phase 7: cold-lane shed without lane detail: "
                         f"{rep!r}")
            if tally7.get("ok", 0) < 1:
                fail(f"phase 7: no cold query survived the flood "
                     f"({tally7})")
            s7 = c7.stats()
            h7 = c7.health()
        for key in ("queue_depth_hot", "queue_depth_cold", "brownout"):
            if key not in s7 or key not in h7:
                fail(f"phase 7: per-lane field {key!r} missing from "
                     f"stats/health")
        if s7["hot_admitted"] < len(hot_x) * 4:
            fail(f"phase 7: hot stream misclassified "
                 f"(hot_admitted={s7['hot_admitted']})")
        if s7["cold_admitted"] < 1:
            fail("phase 7: no cold query admitted on the cold lane")
        print(f"phase 7 OK: hot p95 {p95_unloaded * 1e3:.2f} ms unloaded"
              f" -> {p95_loaded * 1e3:.2f} ms under 20-thread cold flood"
              f" (bound {bound * 1e3:.2f} ms); cold outcomes {tally7}; "
              f"lane_shed_cold={s7['lane_shed_cold']} "
              f"demoted={s7['demoted']}", flush=True)
        print(launches_line(dev, mark_fused.launches - launches0), flush=True)
        _assert_lock_orders()
        print("SERVICE_SMOKE_OK", flush=True)
        return 0
    finally:
        if svc is not None:
            svc.stop()
        shutil.rmtree(workdir7, ignore_errors=True)
        if args.keep is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
