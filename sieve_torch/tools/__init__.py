"""The port's measurement tools, each run as ``python -m
sieve_torch.tools.<name>`` and each with ``main(argv) -> int`` so a script
can call it in process:

* ``trace_report``: renders a ``--trace`` file, a flight-recorder bundle
  or an exemplar file (host code: it loads no torch);
* ``profile_prepare``: host spec preparation by phase (host numpy);
* ``profile_kernel``: the fused kernel, the split kernel and the split
  postlude on one segment, k launches back to back;
* ``profile_rtt``: the card's round-trip floor against k split launches
  with one final fetch;
* ``profile_breakdown``: one n=1e9 segment split into host prepare, the
  copy of the tables, the kernels and the coordinator;
* ``profile_rounds``: the rounds path, cold then warm and traced;
* ``microbench``: steady-state ``mark_words`` (or ``--cuda``: the fused
  kernel) on one segment;
* ``mesh_cold_smoke``: the cold plane's ``MeshWorker`` against the numpy
  worker and a direct oracle, then its throughput against the loop.

The tools that touch a device take ``--device`` (default ``cuda``) and
raise when it names a card that is not there (``resolve_device``). On a CUDA device they time
with CUDA events; on the CPU (``--device cpu``, the kernels' plain
versions) they time with the host clock and say so. The helpers below
import torch only when called.
"""

from __future__ import annotations

import time


def clock_name(dev) -> str:
    """How ``best_of`` times on ``dev``: printed beside every time."""
    return "device, CUDA events" if dev.type == "cuda" else "host clock, CPU"


def best_of(fn, k: int, reps: int, dev) -> float:
    """Seconds for k back-to-back calls of ``fn`` on one stream, best of
    ``reps``, after one warm-up call. On a CUDA device the window is a
    pair of CUDA events around the k launches; on the CPU, where every op
    is synchronous, the host clock."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            import torch

            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            for _ in range(k):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            best = min(best, time.perf_counter() - t0)
    return best


def slope(times_by_k: dict) -> float:
    """Time per call: the slope between the smallest and the largest k."""
    ks = sorted(times_by_k)
    k0, k1 = ks[0], ks[-1]
    return (times_by_k[k1] - times_by_k[k0]) / (k1 - k0)


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
