"""Time the rounds path (``run_mesh``, workers=1) on the cuda backend:
a cold run, then a warm run traced with sieve_torch.trace and summarized
by sieve_torch.tools.trace_report (``--trace-out FILE`` also keeps the
Perfetto-loadable file), and the warm run's host phases: stack,
dispatch, drain and the device's idle share.

Usage: python -m sieve_torch.tools.profile_rounds [n] [rounds] [--twins]
           [--trace-out FILE] [--device D]

The port of the reference's tools/profile_rounds.py. Times are host clock
around the whole run (it ends in a fetch of every round's result); with
``--device cpu`` the kernels' plain versions run on the CPU.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import time

from sieve_torch.backends.cuda import resolve_device


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", default="1e10")
    p.add_argument("rounds", nargs="?", type=int, default=8)
    p.add_argument("--twins", action="store_true")
    p.add_argument("--trace-out", default=None, metavar="FILE")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    n = int(float(a.n))
    dev = resolve_device(a.device)

    from sieve_torch import trace
    from sieve_torch.config import SieveConfig
    from sieve_torch.parallel.mesh import run_mesh
    from sieve_torch.tools.trace_report import load_events, report

    cfg = SieveConfig(n=n, backend="cuda", packing="odds", workers=1,
                      rounds=a.rounds, twins=a.twins, quiet=True, device=str(dev))
    t0 = time.perf_counter()
    res = run_mesh(cfg)
    cold = time.perf_counter() - t0
    trace.enable()  # capture spans for the warm (steady-state) run only
    try:
        t0 = time.perf_counter()
        res = run_mesh(cfg)
        warm = time.perf_counter() - t0
    finally:
        trace.disable()
    print(f"n={n:.0e} rounds={a.rounds} twins={a.twins} pi={res.pi} "
          f"twin={res.twin_pairs}")
    print(f"cold={cold:.4f}s warm={warm:.4f}s "
          f"({(n - 1) / warm:.3e} values/s warm, {dev})")
    ph = res.host_phases or {}
    print("host_phases " + json.dumps(
        {k: ph.get(k) for k in ("stack_s", "dispatch_s", "drain_s",
                                "device_idle_frac", "prep_s", "prep_wait_s",
                                "reduction_mode")}))

    if a.trace_out is not None:
        trace.save(a.trace_out)
        print(f"trace written to {a.trace_out}")
    buf = io.StringIO()
    trace.save(buf)
    buf.seek(0)
    print()
    print(report(load_events(buf)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
