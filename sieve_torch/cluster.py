"""cpu-cluster backend: a coordinator and worker processes over TCP.

The reference's main distributed path (sieve/cluster.py), with its wire
protocol unchanged, so a coordinator of either package drives workers of
either. The coordinator ships the config and the seed primes to each
worker that says hello, then hands out segments from a shared queue and
merges the results; control crosses the network twice per segment
(assign, done). Messages (the framing of sieve_torch/rpc.py):

  worker -> coordinator: {"type": "hello", "worker_id": i, "capacity": c}
                         {"type": "progress", "seg_id", "t_recv", "t_hb"}
                         {"type": "done", "result": SegmentResult dict,
                          "extras": [SegmentResult dict, ..],
                          "ctx", "t_recv", "t_reply", "telemetry"}
                         {"type": "error", "seg_id", "error", ...}
  coordinator -> worker: {"type": "config", "config": .., "seeds": [..]}
                         {"type": "assign", "seg_id", "lo", "hi",
                          "extra": [{"seg_id", "lo", "hi", "ctx"}, ..],
                          "chaos", "chaos_die", "run_id", "ctx", "t_send"}
                         {"type": "shutdown"}

Workers on the card: a worker computes with the backend
``SIEVE_CLUSTER_WORKER_BACKEND`` names (``cuda`` runs the fused kernel of
sieve_torch/kernels/csrc/fused_mark.cu once per segment, ``torch`` the
word kernel), on the device of the handshake config; unset, it runs
``cpu-native`` if that builds, else ``cpu-numpy``. A worker told to use a
card it does not have answers each assignment with a typed ``error``
reply, and the run aborts after ``MAX_ATTEMPTS``: it never carries on on
the CPU. Its hello advertises a capacity (``torch.cuda.device_count()``
for a device backend on a card, else 1) that caps how many segments one
assignment carries; the batch goes through ``process_segments``.

Each assignment carries a silence deadline refreshed by the worker's
heartbeats (one a second, sent while the segment runs in a thread): the
static ``SIEVE_CLUSTER_DEADLINE_S`` floor, a few heartbeats, the p95
attempt time times a slack, and 8x the worker's round trip. A worker that
dies or goes silent has its segments requeued; results key on the
segment id, so a segment done twice counts once. A segment that fails
``MAX_ATTEMPTS`` times aborts the run. Workers may join late or rejoin
after a drop (capped exponential backoff with jitter), and every socket
read is bounded.

Tracing: each assign carries a trace context (``run_id`` and a
per-attempt id ``ctx``) that the worker puts on its ``worker.recv`` /
``worker.segment`` / ``worker.reply`` spans. The worker's spans and
registry ride its terminal reply; the coordinator keeps a min-RTT clock
offset per worker, rebases the events and merges them into its tracer
under one process track per worker, so ``--trace`` writes one timeline.

Fault injection: ``--chaos`` (sieve_torch/chaos.py) and the legacy
``--chaos-kill-worker k@s``; directives ride the ``assign`` and are
consumed at assign time, so a reassigned segment runs fault-free.
"""

from __future__ import annotations

import collections
import math
import os
import queue
import random
import socket
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

from sieve_torch import env, trace
from sieve_torch.analysis.lockdebug import named_lock
from sieve_torch.chaos import ChaosSchedule
from sieve_torch.checkpoint import Ledger
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import SieveResult, merge_results
from sieve_torch.metrics import MetricsLogger, registry
from sieve_torch.rpc import parse_addr, recv_msg, send_msg
from sieve_torch.seed import seed_primes
from sieve_torch.segments import Segment, plan_segments, validate_plan
from sieve_torch.worker import SegmentResult, telemetry_payload, telemetry_start

HEARTBEAT_S = 1.0
_HANDSHAKE_TIMEOUT_S = 30.0
# the backends a cluster worker runs on a device (``device`` places them)
DEVICE_BACKENDS = ("cuda", "torch")


def _base_deadline_s() -> float:
    """Static silence-deadline floor, read per call so a run can tune it."""
    return env.env_float("SIEVE_CLUSTER_DEADLINE_S", 60.0)


def _worker_recv_timeout_s() -> float:
    """Worker-side bound on any one socket read: a worker whose
    coordinator went silent reconnects (or gives up) instead of waiting."""
    return env.env_float("SIEVE_WORKER_RECV_TIMEOUT_S", 30.0)


# --- worker role -------------------------------------------------------------


def serve_worker(config: SieveConfig, worker_id: int | None = None) -> None:
    """Worker main: connect (and reconnect) to the coordinator and process
    assignments until it says shutdown.

    A lost connection (a refused connect while the coordinator binds, a
    coordinator restart, a chaos disconnect) is retried with capped
    exponential backoff and jitter (``SIEVE_WORKER_BACKOFF_S`` base,
    doubled per try up to ``SIEVE_WORKER_BACKOFF_CAP_S``, at most
    ``SIEVE_WORKER_RECONNECT_MAX`` failures in a row); then the worker
    says so on stderr and returns."""
    if worker_id is None:
        worker_id = env.env_int("SIEVE_WORKER_ID", 0)
    host, port = parse_addr(config.coordinator_addr)
    base = env.env_float("SIEVE_WORKER_BACKOFF_S", 0.1)
    cap = env.env_float("SIEVE_WORKER_BACKOFF_CAP_S", 5.0)
    max_tries = env.env_int("SIEVE_WORKER_RECONNECT_MAX", 6)

    session = _WorkerSession(config, worker_id, shipping=telemetry_start())
    tries = 0
    try:
        while True:
            err: BaseException | None = None
            sock: socket.socket | None = None
            try:
                sock = socket.create_connection((host, port), timeout=10)
                sock.settimeout(_worker_recv_timeout_s())
                if session.serve(sock):
                    return  # explicit shutdown from the coordinator
                err = ConnectionError("coordinator closed the connection")
            except (ConnectionError, OSError) as e:
                err = e
            finally:
                if sock is not None:
                    sock.close()
            if session.handshaken:
                tries = 0  # a fresh outage after a healthy session
                session.handshaken = False
            tries += 1
            if tries > max_tries:
                print(
                    f"sieve_torch worker {worker_id}: giving up after "
                    f"{tries - 1} reconnect attempts: {err!r}",
                    file=sys.stderr, flush=True,
                )
                return
            # a fleet retrying a restarted coordinator must not reconnect
            # in lockstep
            delay = min(cap, base * (2 ** (tries - 1)))
            time.sleep(delay * (0.5 + random.random()))
    finally:
        session.close()


class _WorkerSession:
    """Worker-side state that survives reconnects: the compute backend,
    the telemetry-shipping flag and the last handshake."""

    def __init__(self, config: SieveConfig, worker_id: int, shipping: bool):
        self.config = config
        self.worker_id = worker_id
        self.shipping = shipping
        self.worker = None  # compute backend, made at the first assignment
        self.compute_cfg: SieveConfig | None = None
        self.seeds: np.ndarray | None = None
        self.handshaken = False

    def close(self) -> None:
        if self.worker is not None:
            self.worker.close()

    def _compute_worker(self):
        """The compute backend, made on first use inside the segment's
        thread: a backend that cannot start (a card asked for and absent)
        fails that assignment with a typed ``error`` reply."""
        if self.worker is None:
            from sieve_torch.backends import make_worker

            self.worker = make_worker(self.compute_cfg)
        return self.worker

    def serve(self, sock: socket.socket) -> bool:
        """One connected session; True means explicit shutdown (exit)."""
        send_msg(sock, {
            "type": "hello", "worker_id": self.worker_id,
            "capacity": _worker_capacity(self.config.device),
        })
        try:
            msg = recv_msg(sock)
        except socket.timeout:
            raise ConnectionError("coordinator silent during handshake")
        if msg is None:
            raise ConnectionError("coordinator closed during handshake")
        if msg["type"] == "shutdown":
            return True
        if msg["type"] != "config":
            raise ConnectionError(f"bad handshake: {msg['type']!r}")
        self.handshaken = True
        run_cfg = msg["config"]
        self.seeds = np.asarray(msg["seeds"], dtype=np.int64)
        if self.compute_cfg is None:
            # the device of the handshake; a reference coordinator's config
            # names none, and the worker's own --device holds
            self.compute_cfg = SieveConfig.from_dict({
                **run_cfg, "backend": _worker_backend(),
                "device": run_cfg.get("device", self.config.device),
            })
        while True:
            t_wait0 = trace.now_s()
            try:
                msg = recv_msg(sock)
            except socket.timeout:
                raise ConnectionError(
                    f"no traffic from coordinator for "
                    f"{_worker_recv_timeout_s():.0f}s"
                )
            t_recv = trace.now_s()
            if msg is None:
                raise ConnectionError("coordinator closed the connection")
            if msg["type"] == "shutdown":
                return True
            if msg["type"] != "assign":
                raise ConnectionError(f"unexpected message {msg['type']!r}")
            self._assignment(sock, msg, t_wait0, t_recv)

    def _assignment(self, sock: socket.socket, msg: dict, t_wait0: float,
                    t_recv: float) -> None:
        worker_id = self.worker_id
        chaos = msg.get("chaos") or []
        if msg.get("chaos_die") or any(c["kind"] == "kill" for c in chaos):
            os._exit(17)  # simulated hard crash, no cleanup
        ctx = msg.get("ctx")
        trace.add_span("worker.recv", t_wait0, t_recv - t_wait0,
                       seg=msg["seg_id"], worker=worker_id, ctx=ctx)
        reg = registry()
        reg.histogram("worker.recv_wait_ms").observe(
            round((t_recv - t_wait0) * 1000, 3))
        disconnect = next((c for c in chaos if c["kind"] == "disconnect"), None)
        if disconnect is not None:
            # mid-segment network blip: the coordinator requeues, we reconnect
            time.sleep(float(disconnect.get("param") or 0.05))
            raise ConnectionError("chaos: injected mid-segment disconnect")
        drop_hb = any(c["kind"] == "drop_hb" for c in chaos)
        stall_s = max((float(c.get("param") or 1.0)
                       for c in chaos if c["kind"] == "stall"), default=0.0)
        # a capacity batch: the segment plus any extras, in one
        # process_segments call
        batch = [(msg["seg_id"], msg["lo"], msg["hi"])] + [
            (e["seg_id"], e["lo"], e["hi"]) for e in msg.get("extra") or []
        ]
        result: list[SegmentResult] = []
        failure: list[str] = []

        def _work():
            try:
                raise_seg = env.env_str("SIEVE_CHAOS_RAISE")
                if any(raise_seg == str(sid) for sid, _, _ in batch):
                    raise RuntimeError("chaos: injected segment failure")
                worker = self._compute_worker()
                with trace.span("worker.segment", seg=msg["seg_id"],
                                worker=worker_id, ctx=ctx, batch=len(batch)):
                    result.extend(worker.process_segments(
                        [(lo, hi) for _, lo, hi in batch], self.seeds,
                        seg_ids=[sid for sid, _, _ in batch],
                    ))
            except Exception as e:  # reported: the coordinator retries or aborts
                failure.append(f"{e!r}\n{traceback.format_exc()}")

        # the segment runs in a thread (the kernel's ctypes call and torch's
        # waits release the GIL) while this one sends heartbeats
        t = threading.Thread(target=_work, daemon=True)
        t.start()
        while t.is_alive():
            t.join(HEARTBEAT_S)
            if t.is_alive() and not drop_hb:
                # t_recv/t_hb also give the coordinator a clock sample
                send_msg(sock, {"type": "progress", "seg_id": msg["seg_id"],
                                "t_recv": t_recv, "t_hb": trace.now_s()})
        if stall_s:
            # silent straggle: done, heartbeats stopped, the reply late
            time.sleep(stall_s)
        if failure:
            reg.counter("worker.segment_errors").inc()
            reply = {"type": "error", "seg_id": msg["seg_id"], "error": failure[0]}
        else:
            reg.counter("worker.segments_done").inc(len(result))
            for r in result:
                reg.histogram("worker.segment_ms").observe(round(r.elapsed_s * 1000, 3))
            reply = {"type": "done", "result": result[0].to_dict()}
            if len(result) > 1:
                reply["extras"] = [r.to_dict() for r in result[1:]]
        reply["ctx"] = ctx
        reply["t_recv"] = t_recv
        if self.shipping:
            # this attempt's worker.recv and worker.segment (and earlier
            # worker.reply spans) ride this reply
            reply["telemetry"] = telemetry_payload(worker_id)
        t_reply = trace.now_s()
        reply["t_reply"] = t_reply
        send_msg(sock, reply)
        trace.add_span("worker.reply", t_reply, trace.now_s() - t_reply,
                       seg=msg["seg_id"], worker=worker_id, ctx=ctx)


def _worker_backend() -> str:
    """Compute backend of a cluster worker: ``SIEVE_CLUSTER_WORKER_BACKEND``
    if set, else cpu-native if it builds, else cpu-numpy."""
    forced = env.env_str("SIEVE_CLUSTER_WORKER_BACKEND")
    if forced:
        return forced
    from sieve_torch.backends.cpu_native import _build_and_load

    try:
        _build_and_load()
    except (OSError, RuntimeError):  # no g++, or it failed
        return "cpu-numpy"
    return "cpu-native"


def _worker_capacity(device: str) -> int:
    """The capacity a worker advertises in its hello: how many segments
    one assignment may carry. ``SIEVE_WORKER_CAPACITY`` forces it; a
    device backend on a card advertises the cards torch sees, anything
    else 1."""
    forced = env.env_int("SIEVE_WORKER_CAPACITY", 0)
    if forced > 0:
        return forced
    if _worker_backend() in DEVICE_BACKENDS:
        import torch

        if torch.device(device).type == "cuda":
            return max(1, torch.cuda.device_count())
    return 1


# --- coordinator role --------------------------------------------------------


def _ctx_of(current) -> str | None:
    """Primary trace context of an in-flight assignment (batch or single)."""
    if not current:
        return None
    if isinstance(current, list):
        return current[0][3]
    return current[3]


class _WorkerConn(threading.Thread):
    """One coordinator thread per connected worker: assigns segments from
    the shared queue, enforces the silence deadline, requeues on failure,
    and reports joins and leaves."""

    def __init__(self, cluster: "_Cluster", sock: socket.socket):
        super().__init__(daemon=True)
        self.cluster = cluster
        self.sock = sock
        self.worker_id = -1

    def run(self) -> None:
        cl = self.cluster
        # [(seg_id, lo, hi, ctx), ..]: the in-flight batch, so a dead
        # worker requeues all of it and failures name their attempt
        current: list[tuple[int, int, int, str]] | None = None
        joined = False
        leave_reason = "run complete"
        try:
            self.sock.settimeout(_HANDSHAKE_TIMEOUT_S)
            hello = recv_msg(self.sock)
            if not hello or hello["type"] != "hello":
                return
            self.worker_id = hello["worker_id"]
            # absent on old workers -> 1, the one-segment protocol
            cl.set_capacity(self.worker_id, hello.get("capacity", 1))
            send_msg(self.sock, {"type": "config", "config": cl.config.to_dict(),
                                 "seeds": cl.seeds.tolist()})
            # a hello at any point of the run is a join
            cl.worker_joined(self.worker_id)
            joined = True
            # serve until the whole run is done: a segment requeued by
            # another worker's failure must find a live owner
            while not cl.all_done.is_set():
                try:
                    seg = cl.queue.get(timeout=0.5)
                except queue.Empty:
                    continue
                if seg.seg_id in cl.done:
                    continue
                segs = [seg]
                want = cl.assign_batch_size(self.worker_id)
                while len(segs) < want:
                    try:
                        nxt = cl.queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt.seg_id in cl.done:
                        continue
                    segs.append(nxt)
                # per-attempt span id: rpc.assign here and worker.segment
                # there carry the same ctx
                current = []
                for s in segs:
                    attempt = cl.attempts.get(s.seg_id, 0)
                    current.append((s.seg_id, s.lo, s.hi,
                                    f"{cl.run_id}/{s.seg_id}.{attempt}"))
                ctx = current[0][3]
                chaos = []
                for s in segs:
                    chaos.extend(cl.chaos.take(self.worker_id, s.seg_id))
                # any message refreshes the deadline (settimeout per recv):
                # only a silent worker breaches it
                deadline_s = cl.assign_deadline_s(self.worker_id)
                self.sock.settimeout(deadline_s)
                reg = registry()
                t_assign = trace.now_s()
                send_msg(self.sock, {
                    "type": "assign",
                    "seg_id": seg.seg_id,
                    "lo": seg.lo,
                    "hi": seg.hi,
                    "chaos": chaos,
                    "chaos_die": any(c["kind"] == "kill" for c in chaos),
                    "run_id": cl.run_id,
                    "ctx": ctx,
                    "t_send": t_assign,
                    "extra": [{"seg_id": sid, "lo": lo, "hi": hi, "ctx": c}
                              for sid, lo, hi, c in current[1:]],
                })
                while True:
                    try:
                        msg = recv_msg(self.sock)
                    except socket.timeout:
                        raise ConnectionError(
                            f"worker {self.worker_id} silent for "
                            f"{deadline_s:.1f}s on segment {seg.seg_id} "
                            f"(adaptive deadline)"
                        )
                    t_now = trace.now_s()
                    inflight = t_now - t_assign
                    if msg is None:
                        raise ConnectionError("worker closed mid-assignment")
                    if msg["type"] == "progress":
                        reg.counter("cluster.heartbeats").inc()
                        reg.gauge(f"cluster.worker{self.worker_id}.inflight_s").set(
                            round(inflight, 4))
                        reg.gauge("cluster.straggler_s").max(round(inflight, 4))
                        trace.instant("cluster.heartbeat", worker=self.worker_id,
                                      seg=seg.seg_id)
                        if "t_hb" in msg and "t_recv" in msg:
                            cl.clock_sample(self.worker_id, t_assign,
                                            msg["t_recv"], msg["t_hb"], t_now)
                        continue
                    if msg["type"] in ("done", "error"):
                        if "t_reply" in msg and "t_recv" in msg:
                            cl.clock_sample(self.worker_id, t_assign,
                                            msg["t_recv"], msg["t_reply"], t_now)
                        if msg.get("telemetry"):
                            cl.ship(self.worker_id, msg["telemetry"])
                        # one RPC round trip: assign -> terminal reply
                        trace.add_span("rpc.assign", t_assign, inflight,
                                       worker=self.worker_id, seg=seg.seg_id,
                                       ctx=ctx, outcome=msg["type"],
                                       batch=len(current))
                        reg.histogram("cluster.rpc_ms").observe(inflight * 1000)
                        reg.gauge(f"cluster.worker{self.worker_id}.inflight_s").set(0.0)
                    if msg["type"] == "done":
                        # a batch is one round trip but len(current)
                        # segments of compute
                        cl.observe_attempt(inflight / max(1, len(current)))
                        cl.complete(SegmentResult.from_dict(msg["result"]))
                        for r in msg.get("extras") or []:
                            cl.complete(SegmentResult.from_dict(r))
                        current = None
                        break
                    if msg["type"] == "error":
                        cl.observe_attempt(inflight / max(1, len(current)))
                        cl.segment_error(current, msg["error"])
                        current = None
                        break
                    raise ConnectionError(f"unexpected message {msg['type']}")
        except (ConnectionError, OSError) as e:  # socket.timeout is an OSError
            leave_reason = repr(e)
            cl.worker_failed(self.worker_id, current, leave_reason)
        finally:
            # tell the worker to exit only when the run is over: one dropped
            # for a deadline breach may be alive and should reconnect
            if cl.all_done.is_set():
                try:
                    send_msg(self.sock, {"type": "shutdown"})
                except OSError:
                    pass
            self.sock.close()
            if joined:
                cl.worker_left(self.worker_id, leave_reason)


class _Cluster:
    MAX_ATTEMPTS = 4

    def __init__(self, config: SieveConfig, seeds, segments, metrics, ledger):
        self.config = config
        self.seeds = seeds
        self.metrics = metrics
        self.ledger = ledger
        self.queue: queue.Queue = queue.Queue()
        self.done: dict[int, SegmentResult] = {}  # guard: lock
        self.lock = named_lock("_Cluster.lock")
        self.n_expected = len(segments)
        self.all_done = threading.Event()
        self.attempts: dict[int, int] = {}  # guard: lock
        self.fatal: str | None = None
        # one run id stamps every assign's trace context; shipped telemetry
        # and clock samples accumulate per worker until the merge
        self.run_id = os.urandom(4).hex()
        self.tele_lock = named_lock("_Cluster.tele_lock")
        self.telemetry: dict[int, list[dict]] = {}   # guard: tele_lock
        self.worker_registry: dict[int, dict] = {}   # guard: tele_lock
        self.tele_dropped: dict[int, int] = {}       # guard: tele_lock
        self.clock: dict[int, trace.ClockAlign] = {}  # guard: tele_lock
        # one-shot fault schedule, consumed at assign time
        self.chaos = ChaosSchedule(config.chaos_directives())
        # recent attempt durations feed the deadline's p95 term
        self._attempt_s: collections.deque = collections.deque(maxlen=256)
        self._deadline_last: float | None = None
        self._active_workers = 0
        self.worker_capacity: dict[int, int] = {}  # guard: lock
        self.joins = 0
        self.leaves = 0
        for seg in segments:
            self.queue.put(seg)

    # --- membership + adaptive deadline --------------------------------------

    def worker_joined(self, worker_id: int) -> None:
        with self.lock:
            self._active_workers += 1
            self.joins += 1
            active = self._active_workers
        registry().counter("cluster.worker_joins").inc()
        registry().gauge("cluster.active_workers").set(active)
        self.metrics.event("worker_joined", worker=worker_id, run_id=self.run_id,
                           active=active)
        trace.instant("cluster.worker_joined", worker=worker_id, active=active)

    def worker_left(self, worker_id: int, reason: str) -> None:
        with self.lock:
            self._active_workers -= 1
            self.leaves += 1
            active = self._active_workers
        registry().counter("cluster.worker_leaves").inc()
        registry().gauge("cluster.active_workers").set(active)
        self.metrics.event("worker_left", worker=worker_id,
                           reason=reason.splitlines()[0], run_id=self.run_id,
                           active=active)
        trace.instant("cluster.worker_left", worker=worker_id, active=active)

    def set_capacity(self, worker_id: int, capacity) -> None:
        """Record a worker's advertised capacity from its hello."""
        try:
            cap = max(1, int(capacity))
        except (TypeError, ValueError):
            cap = 1  # a malformed hello never breaks assignment
        with self.lock:
            self.worker_capacity[worker_id] = cap
        registry().gauge(f"cluster.worker{worker_id}.capacity").set(cap)

    def assign_batch_size(self, worker_id: int) -> int:
        """Segments per assignment for ``worker_id``: its capacity at most;
        half of it until there are 4 attempt samples and a clock sample;
        then halved while p95 x slack x batch would outrun the deadline
        budget (the static floor or 8x the round trip)."""
        with self.lock:
            cap = self.worker_capacity.get(worker_id, 1)
            samples = sorted(self._attempt_s)
        if cap <= 1:
            return 1
        align = self.clock.get(worker_id)
        if len(samples) < 4 or align is None or not align.samples:
            return max(1, cap // 2)
        slack = env.env_float("SIEVE_CLUSTER_DEADLINE_SLACK", 4.0)
        p95 = samples[min(len(samples) - 1, math.ceil(0.95 * len(samples)) - 1)]
        budget = max(_base_deadline_s(), align.rtt_s * 8)
        batch = cap
        while batch > 1 and p95 * slack * batch > budget:
            batch //= 2
        return max(1, batch)

    def observe_attempt(self, dur_s: float) -> None:
        """Feed one finished assignment's duration to the deadline model."""
        with self.lock:
            self._attempt_s.append(dur_s)

    def assign_deadline_s(self, worker_id: int) -> float:
        """Silence deadline of one assignment to ``worker_id``: the largest
        of the static floor (``SIEVE_CLUSTER_DEADLINE_S``),
        ``SIEVE_CLUSTER_HB_MISS`` heartbeats, the p95 attempt time times
        ``SIEVE_CLUSTER_DEADLINE_SLACK``, and 8x the worker's round trip."""
        hb_miss = env.env_float("SIEVE_CLUSTER_HB_MISS", 4.0)
        slack = env.env_float("SIEVE_CLUSTER_DEADLINE_SLACK", 4.0)
        with self.lock:
            samples = sorted(self._attempt_s)
        p95 = 0.0
        if len(samples) >= 4:
            p95 = samples[min(len(samples) - 1, math.ceil(0.95 * len(samples)) - 1)]
        align = self.clock.get(worker_id)
        rtt = align.rtt_s if align is not None and align.samples else 0.0
        deadline = max(_base_deadline_s(), HEARTBEAT_S * hb_miss, p95 * slack, rtt * 8)
        self._note_deadline(deadline, p95)
        return deadline

    def _note_deadline(self, deadline_s: float, p95_s: float) -> None:
        """``deadline_adjusted`` on the first deadline and on every change
        of more than 20% since the last one reported."""
        with self.lock:
            prev = self._deadline_last
            if prev is not None and abs(deadline_s - prev) <= 0.2 * prev:
                return
            self._deadline_last = deadline_s
        registry().gauge("cluster.deadline_s").set(round(deadline_s, 3))
        self.metrics.event(
            "deadline_adjusted",
            deadline_s=round(deadline_s, 3),
            prev_s=round(prev, 3) if prev is not None else None,
            p95_s=round(p95_s, 3),
            run_id=self.run_id,
        )
        trace.instant("cluster.deadline_adjusted", deadline_s=round(deadline_s, 3),
                      prev_s=round(prev, 3) if prev is not None else None)

    def ship(self, worker_id: int, payload: dict) -> None:
        """Keep a worker's telemetry (raw worker-clock events; they are
        rebased once, at the merge, with the final offset)."""
        with self.tele_lock:
            self.telemetry.setdefault(worker_id, []).extend(payload.get("events") or [])
            self.worker_registry[worker_id] = payload.get("registry") or {}
            self.tele_dropped[worker_id] = int(payload.get("dropped") or 0)

    def clock_sample(self, worker_id: int, t_send, t_remote_recv,
                     t_remote_send, t_done) -> None:
        with self.tele_lock:
            align = self.clock.get(worker_id)
            if align is None:
                align = self.clock[worker_id] = trace.ClockAlign()
        align.sample(t_send, t_remote_recv, t_remote_send, t_done)

    def complete(self, res: SegmentResult) -> None:
        with self.lock:
            if res.seg_id in self.done:
                return  # a reassigned segment finished twice
            self.done[res.seg_id] = res
            if self.ledger is not None:
                self.ledger.record(res)
            self.metrics.segment(res)
            if len(self.done) >= self.n_expected:
                self.all_done.set()

    def worker_failed(self, worker_id, current, reason: str) -> None:
        registry().counter("cluster.worker_failures").inc()
        self.metrics.event("worker_failed", worker=worker_id, reason=reason,
                           run_id=self.run_id, ctx=_ctx_of(current))
        self._requeue(current, reason)

    def segment_error(self, current, reason: str) -> None:
        """A worker survived but its segment raised: retry elsewhere, abort
        after MAX_ATTEMPTS strikes (the failure looks deterministic)."""
        registry().counter("cluster.segment_errors").inc()
        self.metrics.event("segment_error", reason=reason.splitlines()[0],
                           run_id=self.run_id, ctx=_ctx_of(current))
        self._requeue(current, reason)

    def _requeue(self, current, reason: str) -> None:
        if current is None:
            return
        if isinstance(current, list):
            # every segment of a failed batch goes back, each with its own
            # attempt count
            for item in current:
                self._requeue(item, reason)
            return
        seg_id, lo, hi, ctx = current
        with self.lock:
            if seg_id in self.done:
                return
            self.attempts[seg_id] = self.attempts.get(seg_id, 0) + 1
            if self.attempts[seg_id] >= self.MAX_ATTEMPTS:
                self.fatal = (
                    f"segment {seg_id} failed {self.attempts[seg_id]} times; "
                    f"last error: {reason}"
                )
                self.all_done.set()
                return
        registry().counter("cluster.reassigned").inc()
        self.metrics.event("reassign", seg_id=seg_id, run_id=self.run_id, ctx=ctx)
        self.queue.put(Segment(seg_id=seg_id, lo=lo, hi=hi))


# Merged-trace layout: each worker's events land under a synthetic pid, so
# Perfetto shows one process track per worker, apart from any real pid.
_WORKER_PID_BASE = 1_000_000


def _merge_worker_telemetry(cluster: _Cluster, metrics: MetricsLogger) -> dict:
    """Rebase and merge every worker's shipped telemetry into this
    process's tracer and registry; returns the summary that rides
    ``SieveResult.host_phases``.

    ``coordinator_time = worker_time - offset`` with each worker's min-RTT
    offset (error <= RTT/2). Each worker's track also gets a
    ``clock.align`` instant with offset, rtt, err and dropped."""
    tr = trace.get_tracer()
    reg = registry()
    merged: list[dict] = []
    total_events = 0
    total_dropped = 0
    max_err = None
    for wid in sorted(set(cluster.telemetry) | set(cluster.clock)):
        events = cluster.telemetry.get(wid, [])
        align = cluster.clock.get(wid)
        off_us = (align.offset_s if align else 0.0) * 1e6
        pid = _WORKER_PID_BASE + wid
        merged.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                       "args": {"name": f"worker {wid}"}})
        for e in events:
            e = dict(e)
            e["pid"] = pid
            if "ts" in e:
                e["ts"] = round(e["ts"] - off_us, 3)
            merged.append(e)
        dropped = cluster.tele_dropped.get(wid, 0)
        info: dict = {"worker": wid, "events": len(events), "dropped": dropped}
        if align is not None and align.samples:
            info.update(offset_s=round(align.offset_s, 6),
                        rtt_s=round(align.rtt_s, 6),
                        err_s=round(align.err_s, 6),
                        samples=align.samples)
            reg.gauge(f"cluster.worker{wid}.clock_offset_s").set(round(align.offset_s, 6))
            reg.gauge(f"cluster.worker{wid}.clock_err_s").set(round(align.err_s, 6))
            max_err = align.err_s if max_err is None else max(max_err, align.err_s)
        merged.append({"name": "clock.align", "ph": "i", "s": "p",
                       "ts": round(trace.now_s() * 1e6, 3), "pid": pid, "tid": 0,
                       "args": info})
        # the worker's registry as namespaced gauges, so this process's
        # registry covers the whole cluster
        for name, snap in (cluster.worker_registry.get(wid) or {}).items():
            base = f"cluster.worker{wid}.{name}"
            if snap.get("type") in ("counter", "gauge"):
                val = snap.get("value")
                if isinstance(val, (int, float)):
                    reg.gauge(base).set(val)
            elif snap.get("type") == "histogram" and snap.get("count"):
                reg.gauge(f"{base}.count").set(snap["count"])
                reg.gauge(f"{base}.mean").set(round(snap["mean"], 4))
        if dropped:
            reg.counter("cluster.telemetry_dropped").inc(dropped)
        reg.gauge(f"cluster.worker{wid}.telemetry_dropped").set(dropped)
        total_events += len(events)
        total_dropped += dropped
        metrics.event("worker_telemetry", **info)
    if merged:
        tr.ingest(merged)
    summary = {
        "telemetry_workers": sum(1 for ev in cluster.telemetry.values() if ev),
        "telemetry_events": total_events,
        "telemetry_dropped_events": total_dropped,
        "workers_joined": cluster.joins,
        "workers_left": cluster.leaves,
    }
    if max_err is not None:
        summary["clock_err_max_s"] = round(max_err, 6)
        reg.gauge("cluster.clock_err_max_s").set(summary["clock_err_max_s"])
    return summary


def _prebuild(cfg: SieveConfig) -> None:
    """Build the CUDA kernels once before spawning local ``cuda`` workers,
    so they load the library instead of each building it. A coordinator
    spawning card workers on a host without a card fails here."""
    if env.env_str("SIEVE_CLUSTER_WORKER_BACKEND") != "cuda":
        return
    from sieve_torch.backends.cuda import resolve_device

    if resolve_device(cfg.device).type == "cuda":
        from sieve_torch.kernels import build

        build.build()


def run_cluster(config: SieveConfig) -> SieveResult:
    """Coordinator entry: serve assignments, spawn ``workers`` local worker
    processes (``python -m sieve_torch --role worker``) unless
    SIEVE_CLUSTER_NO_SPAWN=1 (workers started elsewhere), merge results.
    With ``--trace`` the file is the merged cluster timeline."""
    cfg = config
    t0 = trace.now_s()
    metrics = MetricsLogger(cfg)
    with trace.span("run.seed", backend=cfg.backend):
        seeds = seed_primes(cfg.seed_limit)
    n_segments = cfg.resolved_n_segments()
    if cfg.n_segments is None and cfg.segment_values is None:
        n_segments = max(cfg.workers * 4, 16)  # a pull model wants several per worker
    segs = plan_segments(cfg.n, n_segments)
    validate_plan(segs, cfg.n)
    eff = SieveConfig(**{**cfg.to_dict(), "n_segments": len(segs)})

    ledger = Ledger.open(eff) if eff.checkpoint_dir else None
    if ledger is not None and ledger.salvaged:
        metrics.event("ledger_salvaged", salvaged=ledger.salvaged,
                      quarantined=ledger.quarantined)
    restored: dict[int, SegmentResult] = {}
    if ledger is not None and eff.resume:
        restored = ledger.completed()
        metrics.event("resume", restored=len(restored))

    todo = [s for s in segs if s.seg_id not in restored]
    cluster = _Cluster(eff, seeds, todo, metrics, ledger)
    trace.instant("cluster.run", run_id=cluster.run_id, workers=eff.workers)
    cluster.done.update(restored)
    cluster.n_expected = len(segs)
    if len(cluster.done) >= len(segs):
        cluster.all_done.set()

    spawn = not cluster.all_done.is_set() and not env.env_str("SIEVE_CLUSTER_NO_SPAWN")
    if spawn:
        _prebuild(eff)
    host, port = parse_addr(eff.coordinator_addr)
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind((host, port))
    actual_addr = f"{server.getsockname()[0]}:{server.getsockname()[1]}"
    server.listen(64)
    server.settimeout(0.5)

    procs: list[subprocess.Popen] = []
    threads: list[_WorkerConn] = []
    try:
        if spawn:
            repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            for i in range(eff.workers):
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "sieve_torch", "--role", "worker",
                     "--n", str(eff.n), "--coordinator-addr", actual_addr,
                     "--packing", eff.packing, "--device", eff.device]
                    + (["--twins"] if eff.twins else []),
                    cwd=repo_root,
                    env={**os.environ, "SIEVE_WORKER_ID": str(i)},
                ))
        # a duration budget on the trace clock: the fixed grace for spawn
        # and handshake plus the run at SIEVE_CLUSTER_FLOOR_VPS values/s
        # per worker (default 1e6, far below any backend's rate)
        floor_vps = env.env_float("SIEVE_CLUSTER_FLOOR_VPS", 1e6)
        workload_s = eff.n / (floor_vps * max(1, eff.workers))
        deadline = trace.now_s() + max(_base_deadline_s() * 4, 300) + workload_s
        while not cluster.all_done.is_set():
            if trace.now_s() > deadline:
                raise RuntimeError(
                    f"cluster run timed out with "
                    f"{cluster.n_expected - len(cluster.done)} segments outstanding"
                )
            try:
                sock, _ = server.accept()
            except socket.timeout:
                continue
            conn = _WorkerConn(cluster, sock)
            conn.start()
            threads.append(conn)
    finally:
        server.close()
        for t in threads:
            t.join(timeout=2)
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    # merge after every connection thread shipped its last telemetry, and
    # before the fatal check, so an aborted run keeps the workers' spans
    telemetry = _merge_worker_telemetry(cluster, metrics)
    if cluster.fatal:
        raise RuntimeError(f"cluster run aborted: {cluster.fatal}")
    results = [cluster.done[s.seg_id] for s in segs]
    with trace.span("run.merge"):
        pi, twins = merge_results(eff, results)
    elapsed = trace.now_s() - t0
    result = SieveResult(
        n=eff.n,
        pi=pi,
        twin_pairs=twins,
        backend="cpu-cluster",
        packing=eff.packing,
        n_segments=len(segs),
        elapsed_s=elapsed,
        values_per_sec=(eff.n - 1) / elapsed if elapsed > 0 else float("inf"),
        segments=results,
        host_phases=telemetry,
    )
    metrics.run_summary(result)
    return result
