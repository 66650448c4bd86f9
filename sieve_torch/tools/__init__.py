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
  worker and a direct oracle, then its throughput against the loop;
* the static gates over ``sieve_torch/`` (stdlib only, no torch):
  ``check_concurrency`` (the analyzer of :mod:`sieve_torch.analysis`
  against ``concurrency_baseline.json``), ``check_env_vars``,
  ``check_event_schema``, ``check_wire_ops`` (its live leg sieves a ledger
  on ``--device``) and ``check_all``, which runs the four;
* the smokes, the gates' runtime half: ``service_smoke`` (the server
  under composed chaos), ``chaos_smoke`` (the cluster under composed
  faults, then a torn-ledger resume) and ``store_smoke`` (demotion, a
  ``serve --procs 3`` warm restart, per-process drain); under
  ``SIEVE_LOCK_DEBUG=1`` each checks its observed lock orders;
* the fleet smokes, each over ``serve`` (and ``route``) processes:
  ``failover_smoke`` (replicas under a live writer, a SIGKILL, refresh
  corruption and a drain), ``shard_smoke`` (the router across the shard
  edge, replica and shard loss, ``svc_shard_down``), ``observe_smoke``
  (the observer's ring, one ``fleet_anomaly``, exemplars, the ``observe``
  CLI and ``fleet_top``) and ``profile_smoke`` (merged flame captures and
  their diff through ``fleet_profile``);
* the fleet tools (host code, no torch): ``fleet_top`` (the live table,
  ``--once``, ``--json``), ``fleet_debug`` (one merged postmortem bundle)
  and ``fleet_profile`` (one merged flame capture, ``--diff``);
* ``autotune_kernel``: the fused kernel's knobs by coordinate descent,
  written to the port's tuned file (``tuned_cuda.json``).

The tools that touch a device take ``--device`` (default ``cuda``) and
raise when it names a card that is not there (``resolve_device``). On a CUDA device they time
with CUDA events; on the CPU (``--device cpu``, the kernels' plain
versions) they time with the host clock and say so. The helpers below
import torch only when called.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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


class SmokeFailure(Exception):
    """A smoke's parity, liveness or accounting violation: its ``main``
    prints it as a ``FAIL:`` line and returns 1."""


def fail(msg: str) -> None:
    raise SmokeFailure(msg)


def expect(desc: str, got, want) -> None:
    if got != want:
        fail(f"{desc}: got {got!r}, want {want!r}")


def assert_lock_orders() -> None:
    """The dynamic half of the concurrency gate, for the smokes: under
    ``SIEVE_LOCK_DEBUG=1`` the acquisition orders this process observed
    must agree with the canonical order (sieve_torch/analysis/model.py),
    or the smoke fails. Prints the observed pairs as one JSON list, then
    ``lock debug OK: K observed acquisition orders ...``. Does nothing
    with the flag off."""
    import json

    from sieve_torch import env
    from sieve_torch.analysis import lockdebug

    if not env.env_flag("SIEVE_LOCK_DEBUG"):
        return
    problems = lockdebug.check_static_consistency()
    if problems:
        fail("lock sanitizer: observed orders disagree with the static "
             "graph:\n  " + "\n  ".join(problems))
    pairs = lockdebug.observed_pairs()
    print("lock debug pairs: " + json.dumps(sorted(list(p) for p in pairs)),
          flush=True)
    print(f"lock debug OK: {len(pairs)} observed acquisition orders "
          "consistent with the static graph", flush=True)


def smoke_device(name: str):
    """The device a smoke runs on (``--device``; a CUDA device must exist)
    and the SieveConfig backend that sieves there: ``cuda`` (the fused
    kernel) on a card, the reference's ``cpu-numpy`` on the CPU."""
    from sieve_torch.backends.cuda import resolve_device

    dev = resolve_device(name)
    return dev, ("cuda" if dev.type == "cuda" else "cpu-numpy")


def launches_line(dev, launches: int, what: str = "in this process") -> str:
    """The line each smoke prints before its banner: the device it ran on
    and the fused kernel's launches it caused."""
    label = str(dev)
    if dev.type == "cuda":
        import torch

        label += f" ({torch.cuda.get_device_name(dev)})"
    return f"device: {label}; fused launches {what}: {launches}"


class Proc:
    """One ``python -m sieve_torch serve``/``route`` process started from
    the repository's root, its first stdout line (the JSON address line)
    read, the rest collected in ``lines`` by a thread. With
    ``announce=False`` the caller reads the address line later
    (``announce()``), so that several processes start together: a
    ``serve`` process takes seconds to import torch, or to reach the card,
    and shards started one after another would each sample their
    profilers for that much longer than the next."""

    def __init__(self, args: list[str], env: dict, announce: bool = True):
        self.args = args
        self.proc = subprocess.Popen(
            args, env=env, cwd=REPO, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        )
        if announce:
            self.announce()

    def announce(self) -> "Proc":
        head = self.proc.stdout.readline()
        try:
            self.serving = json.loads(head)
        except ValueError:
            self.proc.kill()
            raise RuntimeError(f"process did not announce itself: {head!r}")
        self.addr = self.serving["addr"]
        self.lines: list[str] = []
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()
        return self

    def _drain(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


def child_launches(addr: str, wait_s: float = 5.0) -> int:
    """A ``serve`` process's fused launches so far: its registry's
    ``kernel.mark_fused.launches``, read over the ``metrics`` op. Retried
    for ``wait_s`` while the process drops connections (``replica_down``);
    raises if it never answers."""
    from sieve_torch.service import ServiceClient
    from sieve_torch.service.client import CallTimeout

    deadline = time.monotonic() + wait_s
    while True:
        try:
            with ServiceClient(addr, timeout_s=2) as c:
                got = c.metrics().get("kernel.mark_fused.launches") or {}
            return int(got.get("value", 0))
        except (CallTimeout, OSError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
