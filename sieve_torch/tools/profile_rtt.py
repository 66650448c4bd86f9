"""Separate the card's round-trip floor from its compute: one trivial op
and a synchronize, timed 5 times; then k back-to-back launches of the
split kernel and its postlude (the n-value odds segment from 2) with ONE
final readback, k in (1, 2, 4, 8), best of 3. The least-squares slope
over k is the per-launch device time, the intercept the launch and
fetch overhead.

Usage: python -m sieve_torch.tools.profile_rtt [n] [--args] [--device D]

``--args`` times the segment end to end from host tables (the copy of
the tables included) against tables already on the device, and the copy
alone. The port of the reference's tools/profile_rtt.py, whose floor is a
scalar jit round trip. All times are host clock around a synchronized
result; with ``--device cpu`` the plain versions run on the CPU.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

from sieve_torch.backends.cuda import resolve_device
from sieve_torch.tools import sync

KS = (1, 2, 4, 8)


def _segment(n: int):
    from sieve_torch.kernels.cuda_mark import prepare_cuda
    from sieve_torch.seed import seed_primes

    return prepare_cuda("odds", 2, n + 1, seed_primes(math.isqrt(n)))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", default="1e9")
    p.add_argument("--args", action="store_true",
                   help="host tables against device-resident tables")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    n = int(float(a.n))
    dev = resolve_device(a.device)
    return (_args if a.args else _chain)(n, dev)


def _chain(n: int, dev) -> int:
    import torch

    from sieve_torch.kernels.cuda_mark import fused_inputs, split_reduce
    from sieve_torch.kernels.pairs import TWIN_ADJ

    one = torch.ones(1, dtype=torch.int32, device=dev)
    (one + 1).cpu()
    t0 = time.perf_counter()
    for _ in range(5):
        (one + 1).sum().item()  # one op and its readback
    rtt = (time.perf_counter() - t0) / 5
    print(f"one op + synchronize round trip on {dev}: {rtt * 1e3:8.4f} ms")

    seg = _segment(n)
    x = fused_inputs(seg, dev)
    totals = {}
    res = None
    for k in KS:
        def run():
            acc = 0
            for _ in range(k):
                acc = acc + split_reduce(x, TWIN_ADJ)
            return acc.cpu()  # the one readback

        run()  # warm
        dt = float("inf")
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            out = run()
            dt = min(dt, time.perf_counter() - t0)
        totals[k] = dt
        res = tuple(int(v) // k for v in out.tolist())
        print(f"k={k}: total {dt * 1e3:9.4f} ms   ({dt / k * 1e3:9.4f} ms/launch)")
    ks = list(KS)
    mk = sum(ks) / len(ks)
    mt = sum(totals.values()) / len(ks)
    slope = (sum((k - mk) * (totals[k] - mt) for k in ks)
             / sum((k - mk) ** 2 for k in ks))
    print(f"--> split kernel + postlude per launch (slope): {slope * 1e3:9.4f} ms; "
          f"launch + fetch overhead (intercept): {(mt - slope * mk) * 1e3:9.4f} ms")
    print(f"segment (count, pairs, first, last) = {res}")
    return 0


def _args(n: int, dev) -> int:
    from sieve_torch.kernels.cuda_mark import fused_inputs, split_reduce
    from sieve_torch.kernels.pairs import TWIN_ADJ

    seg = _segment(n)

    def host_args():
        return split_reduce(fused_inputs(seg, dev), TWIN_ADJ).cpu()

    x = fused_inputs(seg, dev)
    for label, fn in (("host args", host_args),
                      ("device args", lambda: split_reduce(x, TWIN_ADJ).cpu())):
        fn()  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        print(f"{label}: {best * 1e3:8.4f} ms end-to-end")
    sync(dev)
    t0 = time.perf_counter()
    fused_inputs(seg, dev)
    sync(dev)
    print(f"copy of the tables to {dev}: {(time.perf_counter() - t0) * 1e3:8.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
