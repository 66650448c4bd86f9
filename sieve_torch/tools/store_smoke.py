"""Store smoke: eviction is a demotion, restart is a warm start, N
processes serve one port. The port of the reference's
``tools/store_smoke.py``.

Builds a sieved checkpoint dir, then drives the tiered segment store
through its full life cycle:

1. burst-materialize under load — an in-process server with a
   deliberately tiny ``BitsetLRU`` (2 slots for 4 chunks) answers an
   oracle-exact hot burst while a ``store_torn_write`` chaos directive
   garbles one demotion mid-append: every answer stays exact, the torn
   record is counted (``torn_writes``), and by the end of the burst
   every chunk has been *demoted* into tier 2 of the store — eviction
   discards nothing.
2. multi-process warm restart — the server is stopped and the same dir
   is served again by ``python -m sieve_torch serve --procs 3``: three full
   processes SO_REUSEPORT-bound to ONE port, each with a cold LRU. The
   same burst, fired over many fresh connections so the kernel spreads
   it across all three, must come back oracle-exact with **zero**
   re-materializations and zero cold dispatches fleet-wide — every
   chunk is answered out of the shared mmap'd store.
3. reply identity — the same ``primes`` query over nine fresh
   connections (landing on different processes) must produce replies
   that are byte-identical after stripping the per-request timing
   field, proving the processes serve one consistent store generation.
4. per-process accounting — SIGTERM to the supervisor fans out a
   graceful drain; each child's ``drained`` JSON line is parsed and
   asserted on individually (materialized == 0, cold_dispatches == 0,
   store hits > 0 fleet-wide, writer election: exactly one writer).

With SIEVE_LOCK_DEBUG=1 the in-process phase additionally asserts the
observed lock acquisition orders against the static canonical order.

With ``--device cuda`` (the default; the card must exist) the ledger is
sieved on the ``cuda`` backend (the fused kernel) and the in-process
server and the ``serve --procs 3`` children run that backend on the
same device — three CUDA contexts on one card; with ``--device cpu``
they run the reference's ``cpu-numpy``. Before the banner the smoke
prints the device and this process's fused launches.

Exit status: 0 on full parity (STORE_SMOKE_OK), 1 on any violation.

Usage: python -m sieve_torch.tools.store_smoke [--n N] [--keep DIR] [--device D]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
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
    P = seed_primes(ORACLE_HI)

    def o_pi(x: int) -> int:
        return int(np.searchsorted(P, x, side="right"))

    def o_count(lo: int, hi: int) -> int:
        return int(np.searchsorted(P, hi, side="left")
                   - np.searchsorted(P, lo, side="left"))

    workdir = args.keep or tempfile.mkdtemp(prefix="store_smoke.")
    svc = None
    proc = None
    try:
        cfg = SieveConfig(
            n=args.n, backend=backend, device=str(dev), packing="odds",
            n_segments=4, quiet=True, checkpoint_dir=workdir,
        )
        print(f"phase 0: sieving checkpoint dir (n={args.n})", flush=True)
        run_local(cfg)

        # the burst targets: prefix counts and windows spread over all 4
        # segments (= all 4 index chunks), everything inside [0, n)
        seg = args.n // 4
        burst = []
        for s in range(4):
            lo = s * seg
            burst.append(("pi", {"x": lo + seg // 2},
                          o_pi(lo + seg // 2)))
            burst.append(("count", {"lo": lo + 100, "hi": lo + seg - 100},
                          o_count(lo + 100, lo + seg - 100)))

        # --- phase 1: burst under load, evictions demote, torn counted ---
        cfg1 = SieveConfig(
            n=args.n, backend=backend, device=str(dev), packing="odds",
            n_segments=4, quiet=True, checkpoint_dir=workdir,
            chaos="store_torn_write:any@s2",  # garble the 2nd demotion
        )
        settings1 = ServiceSettings(
            workers=4, queue_limit=64, refresh_s=0.0, lru_segments=2,
        )
        svc = SieveService(cfg1, settings1).start()
        replies: dict[int, tuple] = {}
        rep_lock = threading.Lock()

        def fire(i: int, op: str, params: dict, want) -> None:
            try:
                with ServiceClient(svc.addr, timeout_s=30) as c:
                    rep = c.query(op, **params)
            except BaseException as e:  # noqa: BLE001 — surfaced via fail
                rep = {"ok": False, "error": "transport", "detail": repr(e)}
            with rep_lock:
                replies[i] = (rep, want)

        threads = [threading.Thread(target=fire, args=(i, op, dict(ps), w))
                   for i, (op, ps, w) in enumerate(burst * 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        if any(t.is_alive() for t in threads):
            fail("phase 1 burst query hung")
        for i, (rep, want) in sorted(replies.items()):
            if not rep.get("ok"):
                fail(f"phase 1 burst query {i}: {rep!r}")
            expect(f"phase 1 burst query {i}", rep["value"], want)

        # cycle the 2-slot LRU through all 4 chunks until every chunk
        # has been demoted into tier 2 (a torn demotion re-materializes
        # and re-demotes on a later eviction)
        deadline = time.monotonic() + 30
        with ServiceClient(svc.addr, timeout_s=30) as c1:
            while True:
                st = svc.store.stats()
                if st["entries"][2] >= 4:
                    break
                if time.monotonic() > deadline:
                    fail(f"phase 1: only {st['entries'][2]}/4 chunks "
                         f"demoted to tier 2 ({st})")
                for op, ps, want in burst:
                    expect(f"phase 1 cycle {op}{ps}",
                           c1.query(op, **ps).get("value"), want)
            s1 = c1.stats()
        st1 = svc.store.stats()
        if st1["demotions"] < 4:
            fail(f"phase 1: {st1['demotions']} demotions, want >= 4")
        if st1["torn_writes"] < 1:
            fail(f"phase 1: injected store_torn_write never fired ({st1})")
        if s1["internal_errors"] != 0:
            fail(f"phase 1: {s1['internal_errors']} internal errors")
        print(f"phase 1 OK: burst exact under load; "
              f"{st1['demotions']} demotions, tier2={st1['entries'][2]}, "
              f"torn_writes={st1['torn_writes']} (answers stayed exact)",
              flush=True)
        svc.stop()
        svc = None
        _assert_lock_orders()

        # --- phase 2: 3-process warm restart over the shared store -------
        env2 = dict(os.environ)
        env2.pop("SIEVE_LOCK_DEBUG", None)  # children: no debug overhead
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env2["PYTHONPATH"] = repo + os.pathsep + env2.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "sieve_torch", "serve", "--n", str(args.n),
             "--segments", "4", "--checkpoint-dir", workdir,
             "--addr", "127.0.0.1:0", "--procs", "3", "--quiet",
             "--backend", backend, "--device", str(dev)],
            env=env2, stdout=subprocess.PIPE, text=True, cwd=repo)
        assert proc.stdout is not None
        line = proc.stdout.readline()
        try:
            doc = json.loads(line)
        except ValueError:
            fail(f"phase 2: unparseable serving line {line!r}")
        expect("phase 2 serving event", doc.get("event"), "serving")
        expect("phase 2 supervisor procs", doc.get("procs"), 3)
        addr = doc["addr"]
        print(f"phase 2: 3-proc fleet serving {addr}", flush=True)

        # many fresh connections: the kernel spreads them over all 3
        # processes, so every process answers part of the burst
        procs_seen = set()
        for rnd in range(3):
            for op, ps, want in burst:
                with ServiceClient(addr, timeout_s=30) as c:
                    expect(f"phase 2 {op}{ps}",
                           c.query(op, **ps).get("value"), want)
                    procs_seen.add(c.health().get("proc"))
        print(f"phase 2 OK: burst exact over processes {sorted(procs_seen)}",
              flush=True)

        # --- phase 3: byte-identical replies across processes ------------
        probe = {"op": "primes", "lo": seg - 200, "hi": seg + 200}
        canon = set()
        probe_procs = set()
        for i in range(9):
            with ServiceClient(addr, timeout_s=30) as c:
                rep = c.query(probe["op"], lo=probe["lo"], hi=probe["hi"])
                probe_procs.add(c.health().get("proc"))
            if not rep.get("ok"):
                fail(f"phase 3 probe {i}: {rep!r}")
            for k in ("elapsed_ms", "t_recv", "t_sent"):
                rep.pop(k, None)     # per-request timing legitimately varies
            rep.pop("source", None)  # lru vs store provenance may differ
            canon.add(json.dumps(rep, sort_keys=True).encode())
        if len(canon) != 1:
            fail(f"phase 3: {len(canon)} distinct reply encodings across "
                 f"processes {sorted(probe_procs)}")
        print(f"phase 3 OK: byte-identical replies from processes "
              f"{sorted(probe_procs)}", flush=True)

        # --- phase 4: drain, per-process accounting ----------------------
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        drained = []
        for ln in out.splitlines():
            try:
                d = json.loads(ln)
            except ValueError:
                continue
            if d.get("event") == "drained":
                drained.append(d)
        sup = [d for d in drained if d.get("supervisor")]
        kids = sorted((d for d in drained if not d.get("supervisor")),
                      key=lambda d: d.get("proc", -1))
        if len(sup) != 1 or not sup[0].get("clean"):
            fail(f"phase 4: supervisor did not drain clean: {sup}")
        if len(kids) != 3:
            fail(f"phase 4: want 3 per-process drained lines, got {kids}")
        store_hits = 0
        writers = 0
        for d in kids:
            st = d["stats"]
            if st["materialized"] != 0:
                fail(f"phase 4: proc {d['proc']} re-materialized "
                     f"{st['materialized']} chunks after restart "
                     f"(store miss): {d}")
            if st["cold_dispatches"] != 0 or st["cold_computes"] != 0:
                fail(f"phase 4: proc {d['proc']} went cold after restart: "
                     f"{d}")
            store_hits += st["store_hits"]
            writers += 1 if (d.get("store") or {}).get("writer") else 0
        if store_hits < 4:
            fail(f"phase 4: only {store_hits} store hits fleet-wide, "
                 f"want >= 4 (the burst was not served from the store)")
        if writers != 1:
            fail(f"phase 4: {writers} store writers elected, want exactly "
                 f"1 (proc 0)")
        if proc.returncode != 0:
            fail(f"phase 4: supervisor exit code {proc.returncode}")
        proc = None
        print(f"phase 4 OK: 3/3 procs drained clean, 0 re-materializations,"
              f" 0 cold dispatches, {store_hits} store hits, 1 writer",
              flush=True)

        print(launches_line(dev, mark_fused.launches - launches0), flush=True)
        print("STORE_SMOKE_OK", flush=True)
        return 0
    finally:
        if svc is not None:
            svc.stop()
        if proc is not None and proc.poll() is None:
            proc.kill()
        if args.keep is None:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
