"""Blocking client for the query service, with optional pipelining.

The reference's ``sieve/service/client.py``: the same ops, wire, ``hello``
negotiation and failover policy, so it talks to a server of either
package. ``pi``/``count``/... are one-request-at-a-time. The server
answers replies in COMPLETION order, not send order — a hot query pipelined behind a cold
one comes back first — so the client correlates replies to requests by
the ``id`` each reply echoes, stashing out-of-order arrivals until
their turn. :meth:`ServiceClient.submit` sends without waiting and
returns the wire id; :meth:`ServiceClient.drain` collects any set of
outstanding replies; :meth:`ServiceClient.query_batch` ships M member
queries in ONE ``batch`` RPC and returns M typed per-member outcomes.
Concurrency is still one client per thread — pipelining happens within
a thread, not across threads.

Typed errors surface as :class:`ServiceError` with the server's error
kind (``overloaded`` / ``deadline_exceeded`` / ``degraded`` /
``draining`` / ``bad_request`` / ``internal``) and any partial answer;
callers that want the raw reply dict (to inspect typed outcomes) use
:meth:`ServiceClient.query`.

A ``socket.timeout`` mid-call poisons the connection: the request is
still in flight server-side, so the *next* recv on that socket would
read this call's reply as its own — silent desync, wrong numbers. The
client closes the socket and raises :class:`CallTimeout` instead; every
later call on the same client fails fast with :class:`ConnectionError`.

:class:`ReplicaSet` wraps N replica addresses behind the same
ops surface with failover: health-probe-based selection, a per-replica
circuit (consecutive connection failures open it for a capped-
exponential cooldown; reuse of a half-open replica re-probes first), and
a retry policy typed per error kind — connection drops / timeouts /
``overloaded`` / ``degraded`` / ``draining`` fail over to the next
replica, while ``bad_request`` and ``deadline_exceeded`` never retry
(the answer would be the same, and a deadline'd retry doubles the spend
the caller bounded). Exhausting every replica across all rounds raises
the last typed error seen, else ``ServiceError("unavailable")`` — the
set never invents an answer.

Every query is stamped with a trace context:
``ctx = "<run_id>/<seq>.<attempt>"`` plus a ``t_send`` timestamp on the
sender's trace epoch. The server echoes the ctx into its spans (so a
routed query's shard-side ``rpc.query`` correlates with the router's
``rpc.route``) and echoes receive/send timestamps for NTP-style clock
alignment. A :class:`ReplicaSet` mints a FRESH attempt suffix per try —
two attempts of one logical query are two distinct contexts, so a
retried request never aliases spans from the attempt that failed. With
``telemetry=True`` the reply may piggyback the replica's bounded span
ring (the router asks for this when tracing); the set annotates each
returned reply with a ``probe`` record (addr + its own send/done
timestamps) so the caller can feed the clock aligner.
"""

from __future__ import annotations

import itertools
import random
import socket
import struct
import threading
import time
import uuid
from typing import Any, Sequence

import numpy as np

from sieve_torch import env, trace
from sieve_torch.analysis.lockdebug import named_lock
from sieve_torch.metrics import registry
from sieve_torch.rpc import (
    SUPPORTED_WIRE,
    WIRE_V1,
    WIRE_V2,
    _recv_exact,
    batch_items_to_cols,
    batch_reply_value,
    decode_body,
    encode_msg,
    encode_msg_v2,
    parse_addr,
    primes_reply_value,
)


class ServiceError(RuntimeError):
    def __init__(self, kind: str, detail: str, partial: dict | None = None,
                 shard: int | None = None):
        super().__init__(f"{kind}: {detail}")
        self.kind = kind
        self.detail = detail
        self.partial = partial
        # multi-hop provenance: when the reply crossed the
        # router tier, which shard the error originated on (None for a
        # direct single-server reply or a router-level error)
        self.shard = shard


class CallTimeout(ServiceError):
    """The reply didn't arrive within the socket timeout. The connection
    is closed (reply stream desynced) — the request may still complete
    server-side, so the outcome is *unknown*, never assumed failed."""

    def __init__(self, detail: str):
        super().__init__("timeout", detail)


#: lazily-built logger for client-side wire events (the client has no
#: config of its own — same quiet-shim trick the router uses)
_wire_logger = None
_wire_logger_lock = named_lock("client._wire_logger_lock")


def _emit_wire_downgrade(addr: str, negotiated: int) -> None:
    global _wire_logger
    import types as _types

    from sieve_torch.metrics import MetricsLogger

    with _wire_logger_lock:
        if _wire_logger is None:
            _wire_logger = MetricsLogger(_types.SimpleNamespace(quiet=True))
        logger = _wire_logger
    registry().counter("wire.downgrade").inc()
    logger.event("wire_downgrade", quietable=True, addr=addr,
                 negotiated=negotiated)


class ServiceClient:
    def __init__(self, addr: str, timeout_s: float = 60.0,
                 negotiate: bool | None = None, keep_arrays: bool = False):
        host, port = parse_addr(addr)
        self._addr = addr
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        try:
            # request frames are one sendall each; never Nagle-hold the
            # tail segment of a multi-segment binary batch
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        self._ids = itertools.count(1)
        self._run_id = uuid.uuid4().hex[:8]
        self._ctx_seq = itertools.count(1)
        self._dead = False
        # pipelining: ids awaiting a reply (→ send timestamp)
        # and replies that arrived before their turn (id → reply)
        self._pending: dict[Any, float] = {}
        self._replies: dict[Any, dict] = {}
        # binary wire v2: negotiated send version, member-op
        # memory for columnar batches in flight (id → op names), raw
        # wire byte counters (bytes per batch member read them),
        # and keep_arrays=True hands decoded ``primes`` values out as
        # int64 arrays instead of lists (the router's shard legs — no
        # round trip through Python ints on a pass-through)
        self.wire_v = WIRE_V1  # guard: none(written only during
        # __init__'s hello, before the client is shared; readers after
        # that see a frozen value)
        self.downgraded = False  # guard: none(same write-once-in-init
        # discipline as wire_v)
        self.keep_arrays = keep_arrays
        self.bytes_sent = 0  # guard: none(ServiceClient is documented
        # single-thread-per-call; counters ride the caller's thread)
        self.bytes_recv = 0  # guard: none(see bytes_sent)
        self._batch_ops: dict[Any, list] = {}  # guard: none(touched
        # only inside _send/_recv_for on the caller's thread, same as
        # _pending/_replies above)
        if negotiate is None:
            negotiate = env.env_flag("SIEVE_WIRE_V2", True)
        if negotiate:
            self._negotiate()

    def _negotiate(self) -> None:
        """The wire hello: offer ``SUPPORTED_WIRE``, adopt the server's
        pick. A v1-only peer answers ``wire: 1`` (or, pre-negotiation
        builds, a typed bad_request) — either way the client stays on
        JSON and logs ONE ``wire_downgrade`` event (+ counter), so a
        silently degraded fleet is visible in metrics."""
        try:
            reply = self._call({"type": "hello",
                                "wire": list(SUPPORTED_WIRE)})
        except (CallTimeout, ConnectionError, OSError):
            # a connection dying under the hello is an outage, not a
            # protocol downgrade: close it and let the FIRST REAL CALL
            # raise the ConnectionError — the exact place a
            # pre-negotiation client would have surfaced it (the
            # constructor itself never sent anything back then)
            self.close()
            return
        if reply.get("type") == "hello" and reply.get("ok"):
            try:
                self.wire_v = int(reply.get("wire") or WIRE_V1)
            except (TypeError, ValueError):
                self.wire_v = WIRE_V1
        if self.wire_v < WIRE_V2:
            self.downgraded = True
            _emit_wire_downgrade(self._addr, self.wire_v)

    def close(self) -> None:
        self._dead = True
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "ServiceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- raw -------------------------------------------------------------

    def _send(self, msg: dict):
        """Ship one message without waiting; returns its wire id."""
        if self._dead:
            raise ConnectionError(
                "connection closed (earlier timeout desynced the reply "
                "stream); open a new client"
            )
        rid = msg.setdefault("id", next(self._ids))
        frame = None
        if (self.wire_v >= WIRE_V2 and msg.get("op") == "batch"
                and "items" in msg):
            packed = batch_items_to_cols(msg["items"])
            if packed is not None:
                cols, ops = packed
                header = {k: v for k, v in msg.items() if k != "items"}
                frame = encode_msg_v2(header, cols)
                self._batch_ops[rid] = ops
        if frame is None:
            frame = encode_msg(msg)
        self._sock.sendall(frame)
        self.bytes_sent += len(frame)
        self._pending[rid] = trace.now_s()
        return rid

    def _recv_for(self, rid) -> dict:
        """Block until the reply for ``rid`` arrives. Replies come in
        COMPLETION order; ones for other outstanding ids are stashed
        and handed out when their id is asked for."""
        if rid in self._replies:
            self._pending.pop(rid, None)
            return self._replies.pop(rid)
        while True:
            try:
                reply = self._recv()
            except socket.timeout:
                # requests are still in flight server-side: a later recv
                # on this socket would read THEIR replies as its own —
                # close it (every stashed reply already collected stays
                # valid; everything still pending is lost)
                self.close()
                raise CallTimeout(
                    f"no reply within {self._sock.gettimeout()}s; "
                    "connection closed (request outcome unknown)"
                ) from None
            if reply is None:
                raise ConnectionError("service closed the connection")
            got = reply.get("id")
            self._rehydrate(got, reply)
            if got == rid:
                self._pending.pop(rid, None)
                return reply
            self._replies[got] = reply

    def _recv(self) -> dict | None:
        """One frame off the socket, counted into ``bytes_recv``."""
        header = _recv_exact(self._sock, 8)
        if header is None:
            return None
        (length,) = struct.unpack(">Q", header)
        blob = _recv_exact(self._sock, length)
        if blob is None:
            return None
        self.bytes_recv += 8 + length
        return decode_body(blob)

    def _rehydrate(self, rid, reply: dict) -> None:
        """Rebuild the v1-shaped ``value`` from a v2 columnar reply, in
        place — callers above this point never see columns. A JSON
        reply (including a whole-batch error for a columnar request)
        passes through untouched."""
        if "_cols" not in reply:
            self._batch_ops.pop(rid, None)
            return
        del reply["_cols"]
        vkind = reply.pop("vkind", None)
        if vkind == "batch":
            reply["value"] = batch_reply_value(
                reply, self._batch_ops.pop(rid, None)
            )
        elif vkind == "primes":
            reply["value"] = primes_reply_value(
                reply, as_array=self.keep_arrays
            )

    def _call(self, msg: dict) -> dict:
        return self._recv_for(self._send(msg))

    def query(self, op: str, deadline_s: float | None = None,
              **params: Any) -> dict:
        """One query; returns the raw reply dict (ok or typed error)."""
        msg: dict[str, Any] = {"type": "query", "op": op, **params}
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        # trace ctx: a caller-supplied ctx (the router
        # forwarding its route context) wins; a bare client is attempt 0
        msg.setdefault("ctx", f"{self._run_id}/{next(self._ctx_seq)}.0")
        msg.setdefault("t_send", round(trace.now_s(), 6))
        return self._call(msg)

    # --- pipelining -------------------------------------------

    def submit(self, op: str, deadline_s: float | None = None,
               **params: Any):
        """Send one query WITHOUT waiting for its reply; returns the
        wire id to pass to :meth:`drain`. Any number may be in flight."""
        msg: dict[str, Any] = {"type": "query", "op": op, **params}
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        msg.setdefault("ctx", f"{self._run_id}/{next(self._ctx_seq)}.0")
        msg.setdefault("t_send", round(trace.now_s(), 6))
        return self._send(msg)

    def drain(self, ids: Sequence | None = None) -> dict:
        """Collect replies for ``ids`` (default: every outstanding
        submit), keyed by wire id. Blocks until each asked-for reply
        has arrived; replies for ids NOT asked for stay stashed."""
        if ids is None:
            ids = list(self._pending)
        return {rid: self._recv_for(rid) for rid in ids}

    def pending(self) -> int:
        """Submitted requests whose replies have not been collected."""
        return len(self._pending)

    def query_batch(self, items: Sequence[dict],
                    deadline_s: float | None = None) -> list[dict]:
        """One ``batch`` RPC carrying M member queries; returns M typed
        per-member outcomes (``{"ok": True, "value": ...}`` or
        ``{"ok": False, "error": kind, ...}``), in member order. Raises
        :class:`ServiceError` only for whole-batch failures (malformed
        items container, oversized batch)."""
        return self._value(self.query("batch", deadline_s,
                                      items=list(items)))

    def _value(self, reply: dict):
        if reply.get("ok"):
            return reply["value"]
        raise ServiceError(
            reply.get("error", "internal"),
            reply.get("detail", ""),
            reply.get("partial"),
            shard=reply.get("shard"),
        )

    # --- ops -------------------------------------------------------------

    def pi(self, x: int, deadline_s: float | None = None) -> int:
        return self._value(self.query("pi", deadline_s, x=x))

    def is_prime(self, x: int, deadline_s: float | None = None) -> bool:
        return bool(self._value(self.query("is_prime", deadline_s, x=x)))

    def count(self, lo: int, hi: int, kind: str = "primes",
              deadline_s: float | None = None) -> int:
        return self._value(
            self.query("count", deadline_s, lo=lo, hi=hi, kind=kind)
        )

    def nth_prime(self, k: int, deadline_s: float | None = None) -> int:
        return self._value(self.query("nth_prime", deadline_s, k=k))

    def primes(self, lo: int, hi: int,
               deadline_s: float | None = None) -> list[int]:
        return self._value(self.query("primes", deadline_s, lo=lo, hi=hi))

    # --- control plane ---------------------------------------------------

    def health(self) -> dict:
        return self._call({"type": "health"})

    def stats(self) -> dict:
        return self._call({"type": "stats"})["stats"]

    def shutdown(self) -> dict:
        """Ask the server to drain (the wire twin of SIGTERM)."""
        return self._call({"type": "shutdown"})

    def metrics(self) -> dict:
        """Full metrics-registry snapshot (the live telemetry op)."""
        return self._call({"type": "metrics"})["metrics"]

    def debug(self) -> dict | None:
        """Inline flight-recorder bundle (the postmortem op).

        Answered by the reader thread like ``metrics``, so it works
        against a server whose worker pool is wedged. None when the
        endpoint runs with the recorder disabled."""
        return self._call({"type": "debug"})["bundle"]

    def profile(self) -> dict | None:
        """Continuous-profiler snapshot (the flame-pull op).

        The endpoint's collapsed-stack table — every sample tagged with
        its thread role and active span — answered inline like ``debug``
        so a wedged worker pool still profiles. None when the endpoint
        runs with the sampler disabled (SIEVE_PROF_HZ=0)."""
        return self._call({"type": "profile"})["profile"]

    def exemplars(self, ctx: str | None = None,
                  n: int | None = None) -> list[dict]:
        """Kept tail-sampled exemplars, newest last.

        Served inline from the endpoint's in-memory ring; ``ctx`` is a
        trace-context prefix filter (how the router pulls the downstream
        exemplars of one slow route), ``n`` caps the count. Empty when
        the endpoint runs with exemplar sampling disabled."""
        msg: dict = {"type": "exemplars"}
        if ctx is not None:
            msg["ctx"] = ctx
        if n is not None:
            msg["n"] = n
        return self._call(msg)["exemplars"]

    def inject_chaos(self, spec: str) -> dict:
        return self._call({"type": "chaos", "spec": spec})


class ClientPool:
    """One pipelined :class:`ServiceClient` per address, reused across
    calls. A fleet poller visits every endpoint once per refresh cycle;
    without the pool each poll would open (and tear down) a fresh TCP
    connection per target. The pool
    hands back the cached client until a transport failure invalidates
    it, and counts reconnects so the reuse is provable in tests."""

    def __init__(self, timeout_s: float = 5.0):
        self.timeout_s = timeout_s
        self._clients: dict[str, ServiceClient] = {}
        self._ever: set[str] = set()
        self._lock = named_lock("ClientPool._lock")
        self.connects = 0    # guard: _lock
        self.reconnects = 0  # guard: _lock

    def get(self, addr: str) -> ServiceClient:
        """Cached client for ``addr``; (re)connects only when there is
        none or the cached one is dead. A re-connection to an address
        seen before counts as a reconnect."""
        with self._lock:
            cli = self._clients.get(addr)
            if cli is not None and not cli._dead:
                return cli
            cli = ServiceClient(addr, timeout_s=self.timeout_s)
            self._clients[addr] = cli
            self.connects += 1
            if addr in self._ever:
                self.reconnects += 1
            self._ever.add(addr)
            return cli

    def invalidate(self, addr: str) -> None:
        """Drop the cached client after a transport failure; the next
        :meth:`get` reconnects (and counts it)."""
        with self._lock:
            cli = self._clients.pop(addr, None)
        if cli is not None:
            cli.close()

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for cli in clients:
            cli.close()

    def __enter__(self) -> "ClientPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --- replica failover --------------------------------------------------------

# typed error kinds that justify trying another replica: the condition is
# local to the replica (its queue, its backend, its lifecycle), so a
# sibling may well answer. bad_request would fail identically everywhere;
# deadline_exceeded already spent the caller's budget.
FAILOVER_KINDS = frozenset({"overloaded", "degraded", "draining"})


class _Replica:
    """One address + its connection and circuit state. ``lock`` guards
    the connection: one THREAD at a time drives it, though that thread
    may pipeline any number of requests."""

    __slots__ = ("addr", "client", "lock", "fails", "open_until", "probed")

    def __init__(self, addr: str):
        self.addr = addr
        self.client: ServiceClient | None = None
        self.lock = named_lock("_Replica.lock")
        self.fails = 0
        self.open_until = 0.0
        # monotonic timestamp of the last successful health probe
        # (0.0 = never / invalidated by _mark_down)
        self.probed = 0.0


class ReplicaSet:
    """Failover client over N replica addresses (see module docstring).

    Thread-safe: the set-level lock covers selection and circuit state;
    each replica's lock serializes its connection. ``rounds`` full passes
    over the replica list are attempted, with a capped-exponential
    + jitter backoff between passes, before giving up.
    """

    def __init__(
        self,
        addrs: Sequence[str],
        timeout_s: float = 60.0,
        probe_timeout_s: float = 2.0,
        rounds: int = 3,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 1.0,
        circuit_cooldown_s: float = 1.0,
        probe_ttl_s: float | None = None,
        negotiate: bool | None = None,
        keep_arrays: bool = False,
    ):
        if not addrs:
            raise ValueError("ReplicaSet needs at least one address")
        self._replicas = [_Replica(a) for a in addrs]
        self.timeout_s = timeout_s
        self.probe_timeout_s = probe_timeout_s
        self.rounds = rounds
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.circuit_cooldown_s = circuit_cooldown_s
        # probe freshness: None keeps the legacy contract — a
        # replica probes once and stays trusted until marked down. The
        # router passes a short TTL so per-request shard selection never
        # adds a probe round-trip on the hot path yet still re-detects
        # draining replicas within one TTL.
        self.probe_ttl_s = probe_ttl_s
        self._lock = named_lock("ReplicaSet._lock")
        self._rr = 0
        self._run_id = uuid.uuid4().hex[:8]
        self._ctx_seq = itertools.count(1)
        # observability for callers and tests: how often selection failed over
        self.failovers = 0
        self.probes = 0
        # wire v2: per-connection negotiation preference
        # (None = SIEVE_WIRE_V2 env default), array pass-through for
        # the router's shard legs, and how many fresh connections came
        # up downgraded to v1 JSON (surfaced in router stats)
        self.negotiate = negotiate
        self.keep_arrays = keep_arrays
        self.downgrades = 0

    def _connect(self, addr: str) -> ServiceClient:
        cli = ServiceClient(addr, timeout_s=self.timeout_s,
                            negotiate=self.negotiate,
                            keep_arrays=self.keep_arrays)
        if cli.downgraded:
            with self._lock:
                self.downgrades += 1
        return cli

    def close(self) -> None:
        for rep in self._replicas:
            with rep.lock:
                if rep.client is not None:
                    rep.client.close()
                    rep.client = None

    def __enter__(self) -> "ReplicaSet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- selection & circuit ---------------------------------------------

    def _candidates(self) -> list[_Replica]:
        """Replicas in try-order: round-robin rotation, circuit-closed
        first; open-but-expired (half-open) after; still-open last — a
        fully broken set must still attempt *something* each round."""
        now = time.monotonic()
        with self._lock:
            order = (self._replicas[self._rr:] + self._replicas[: self._rr])
            self._rr = (self._rr + 1) % len(self._replicas)
        closed = [r for r in order if r.fails == 0]
        half = [r for r in order if r.fails > 0 and now >= r.open_until]
        still = [r for r in order if r.fails > 0 and now < r.open_until]
        return closed + half + still

    def _mark_down(self, rep: _Replica) -> None:
        with self._lock:
            rep.fails += 1
            cooldown = min(
                self.backoff_cap_s * 8,
                self.circuit_cooldown_s * (2 ** min(rep.fails - 1, 6)),
            )
            rep.open_until = time.monotonic() + cooldown
            rep.probed = 0.0
        with rep.lock:
            if rep.client is not None:
                rep.client.close()
                rep.client = None

    def _mark_up(self, rep: _Replica) -> None:
        with self._lock:
            rep.fails = 0
            rep.open_until = 0.0

    def _probe_fresh(self, rep: _Replica, now: float) -> bool:
        if rep.probed <= 0.0:
            return False
        if self.probe_ttl_s is None:  # legacy: trusted until marked down
            return True
        return now - rep.probed <= self.probe_ttl_s

    def _ensure_client(self, rep: _Replica) -> ServiceClient:
        """Connect + health-probe (caller holds rep.lock). A replica that
        was marked down — or never used — must prove itself with a probe
        before it gets real queries; a draining replica fails the probe
        so rolling restarts steer new work away without a single typed
        ``draining`` round-trip wasted. With ``probe_ttl_s`` set, a probe
        stays trusted for that window — the counters make the cache
        provable (``router.probe_cached`` vs ``router.probe_sent``)."""
        if rep.client is None:
            rep.client = self._connect(rep.addr)
            rep.probed = 0.0
        now = time.monotonic()
        if self._probe_fresh(rep, now):
            registry().counter("router.probe_cached").inc()
            return rep.client
        registry().counter("router.probe_sent").inc()
        rep.client._sock.settimeout(self.probe_timeout_s)
        try:
            health = rep.client.health()
        finally:
            rep.client._sock.settimeout(self.timeout_s)
        with self._lock:
            self.probes += 1
        if health.get("draining"):
            raise ServiceError("draining", f"{rep.addr} is draining")
        rep.probed = time.monotonic()
        return rep.client

    # --- calls ------------------------------------------------------------

    def query(self, op: str, deadline_s: float | None = None, *,
              ctx: str | None = None, telemetry: bool = False,
              **params: Any) -> dict:
        """One query with failover; returns the raw reply dict. Raises
        ConnectionError-shaped failures only as a final
        ``ServiceError("unavailable")`` after every replica and round is
        exhausted; a non-failover typed error returns immediately.

        ``ctx`` is the trace-context BASE (``run_id/<seq>``, minted here
        when absent — the router passes its route context down); each
        try gets a fresh ``.{try}`` attempt suffix so retried requests
        never alias spans. ``telemetry=True`` asks the replica to
        piggyback its span ring on the reply."""
        msg: dict[str, Any] = {"type": "query", "op": op, **params}
        if deadline_s is not None:
            msg["deadline_s"] = deadline_s
        if ctx is None:
            ctx = f"{self._run_id}/{next(self._ctx_seq)}"
        last_typed: dict | None = None
        last_err: Exception | None = None
        tries = 0
        for attempt in range(1, self.rounds + 1):
            for i, rep in enumerate(self._candidates()):
                if i > 0:
                    with self._lock:
                        self.failovers += 1
                try:
                    with rep.lock:
                        client = self._ensure_client(rep)
                        # fresh copy per attempt: ids are per-connection,
                        # a retried dict must not pin a stale one, and
                        # the trace ctx names THIS attempt
                        attempt_msg = dict(msg)
                        attempt_msg["ctx"] = f"{ctx}.{tries}"
                        t_send = round(trace.now_s(), 6)
                        attempt_msg["t_send"] = t_send
                        if telemetry:
                            attempt_msg["telemetry"] = True
                        tries += 1
                        reply = client._call(attempt_msg)
                except (ConnectionError, OSError, CallTimeout) as e:
                    self._mark_down(rep)
                    last_err = e
                    continue
                except ServiceError as e:  # probe said draining
                    self._mark_down(rep)
                    last_typed = {"ok": False, "error": e.kind,
                                  "detail": e.detail, "op": op}
                    continue
                # clock-probe annotation for the caller's aligner: which
                # replica answered, bracketed by our send/done timestamps
                reply["probe"] = {
                    "addr": rep.addr,
                    "t_send": t_send,
                    "t_done": round(trace.now_s(), 6),
                }
                self._mark_up(rep)
                if reply.get("ok") or reply.get("error") not in FAILOVER_KINDS:
                    return reply
                last_typed = reply  # overloaded/degraded/draining: next
            if attempt < self.rounds:
                # backoff: capped exponential, full jitter
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** (attempt - 1)))
                time.sleep(delay * (0.5 + random.random()))
        if last_typed is not None:
            return last_typed
        raise ServiceError(
            "unavailable",
            f"no replica answered after {self.rounds} rounds over "
            f"{len(self._replicas)} replicas (last: {last_err!r})",
        )

    def query_batch(self, items: Sequence[dict],
                    deadline_s: float | None = None, *,
                    ctx: str | None = None,
                    telemetry: bool = False) -> list[dict]:
        """One ``batch`` RPC with whole-batch failover: the standard
        :meth:`query` retry policy applies to the RPC itself (a member's
        typed outcome is the SERVER's answer and is never retried
        here — per-member semantics live inside the batch reply)."""
        return self._value(self.query("batch", deadline_s, ctx=ctx,
                                      telemetry=telemetry,
                                      items=list(items)))

    def query_many(self, requests: Sequence[dict],
                   deadline_s: float | None = None, *,
                   ctx: str | None = None,
                   window: int | None = None) -> list[dict]:
        """Pipeline N independent queries with failover; returns one raw
        reply dict per request, in REQUEST order.

        Every still-unanswered request rides ONE pipelined connection
        (at most ``window`` in flight when set), drained in send order.
        A transport failure mid-pipeline marks that replica down and
        retries ONLY the unanswered suffix on the next candidate —
        replies already collected are kept, the suffix gets fresh
        attempt contexts. A typed FAILOVER_KINDS reply retries just
        that member; other typed replies (bad_request,
        deadline_exceeded) are final. Members no replica ever answered
        come back as synthesized ``unavailable`` replies (or their last
        failover-kind reply), so positions are stable and the set never
        invents an answer."""
        n = len(requests)
        results: list[dict | None] = [None] * n
        typed: dict[int, dict] = {}
        if ctx is None:
            ctx = f"{self._run_id}/{next(self._ctx_seq)}"
        last_err: Exception | None = None
        tries = 0
        for attempt in range(1, self.rounds + 1):
            for i_rep, rep in enumerate(self._candidates()):
                todo = [i for i in range(n) if results[i] is None]
                if not todo:
                    return results
                if i_rep > 0:
                    with self._lock:
                        self.failovers += 1
                tries += 1
                try:
                    with rep.lock:
                        client = self._ensure_client(rep)
                        cap = window if window and window > 0 else len(todo)
                        inflight: list[tuple[int, Any, float]] = []
                        qi = 0
                        while qi < len(todo) or inflight:
                            while qi < len(todo) and len(inflight) < cap:
                                i = todo[qi]
                                qi += 1
                                msg = dict(requests[i])
                                msg["type"] = "query"
                                msg.pop("id", None)  # ids are per-conn
                                if (deadline_s is not None
                                        and "deadline_s" not in msg):
                                    msg["deadline_s"] = deadline_s
                                msg["ctx"] = f"{ctx}.{tries}:{i}"
                                t_send = round(trace.now_s(), 6)
                                msg["t_send"] = t_send
                                inflight.append(
                                    (i, client._send(msg), t_send)
                                )
                            i, rid, t_send = inflight.pop(0)
                            reply = client._recv_for(rid)
                            reply["probe"] = {
                                "addr": rep.addr,
                                "t_send": t_send,
                                "t_done": round(trace.now_s(), 6),
                            }
                            if (reply.get("ok")
                                    or reply.get("error")
                                    not in FAILOVER_KINDS):
                                results[i] = reply
                            else:
                                typed[i] = reply  # retry on next replica
                except (ConnectionError, OSError, CallTimeout) as e:
                    self._mark_down(rep)
                    last_err = e
                    continue
                except ServiceError as e:  # probe said draining
                    self._mark_down(rep)
                    for i in todo:
                        typed.setdefault(i, {
                            "ok": False, "error": e.kind,
                            "detail": e.detail,
                            "op": str(requests[i].get("op", "")),
                        })
                    continue
                self._mark_up(rep)
            if (attempt < self.rounds
                    and any(r is None for r in results)):
                delay = min(self.backoff_cap_s,
                            self.backoff_base_s * (2 ** (attempt - 1)))
                time.sleep(delay * (0.5 + random.random()))
        for i in range(n):
            if results[i] is None:
                results[i] = typed.get(i) or {
                    "ok": False,
                    "op": str(requests[i].get("op", "")),
                    "error": "unavailable",
                    "detail": f"no replica answered after {self.rounds} "
                              f"rounds over {len(self._replicas)} "
                              f"replicas (last: {last_err!r})",
                }
        return results

    def health(self) -> dict:
        """Health of the first reachable replica (no probe gate: a
        draining replica's health is exactly what the caller wants to
        see). Used by the router to aggregate per-shard health."""
        last_err: Exception | None = None
        for rep in self._candidates():
            try:
                with rep.lock:
                    if rep.client is None:
                        rep.client = self._connect(rep.addr)
                    rep.client._sock.settimeout(self.probe_timeout_s)
                    try:
                        return rep.client.health()
                    finally:
                        if rep.client is not None:
                            rep.client._sock.settimeout(self.timeout_s)
            except (ConnectionError, OSError, CallTimeout) as e:
                self._mark_down(rep)
                last_err = e
        raise ServiceError(
            "unavailable",
            f"no replica health over {len(self._replicas)} replicas "
            f"(last: {last_err!r})",
        )

    def metrics(self) -> dict:
        """Metrics snapshot of the first reachable replica (the fleet
        poller asks each replica directly; this is the failover twin)."""
        last_err: Exception | None = None
        for rep in self._candidates():
            try:
                with rep.lock:
                    if rep.client is None:
                        rep.client = self._connect(rep.addr)
                    return rep.client.metrics()
            except (ConnectionError, OSError, CallTimeout) as e:
                self._mark_down(rep)
                last_err = e
        raise ServiceError(
            "unavailable",
            f"no replica metrics over {len(self._replicas)} replicas "
            f"(last: {last_err!r})",
        )

    def telemetry_flush(self) -> list[dict]:
        """Pull the residual span ring from EVERY reachable replica.

        The batched piggyback leaves up to ``telemetry_batch - 1``
        events sitting in each replica's ring; the router calls this
        when its trace closes so the span tail still lands in the
        merged file. Every replica is visited (not first-reachable —
        each holds distinct spans); unreachable ones are skipped, and
        each reply is probe-annotated for the caller's clock aligner.
        """
        replies: list[dict] = []
        for rep in self._replicas:
            try:
                with rep.lock:
                    if rep.client is None:
                        rep.client = self._connect(rep.addr)
                    t_send = round(trace.now_s(), 6)
                    reply = rep.client._call(
                        {"type": "telemetry", "t_send": t_send}
                    )
                    reply["probe"] = {
                        "addr": rep.addr,
                        "t_send": t_send,
                        "t_done": round(trace.now_s(), 6),
                    }
                    replies.append(reply)
            except (ConnectionError, OSError, CallTimeout):
                self._mark_down(rep)
        return replies

    def exemplars(self, ctx: str | None = None) -> list[dict]:
        """Kept exemplars from EVERY reachable replica.

        Every replica is visited, not first-reachable — a routed
        request's downstream query ran on exactly one of them, and the
        caller does not know which. Each record is tagged with the
        replica address it came from; unreachable replicas are skipped
        (a down replica must not fail the pull that is trying to
        explain why a route was slow). A failed pull only drops the
        cached connection — it never marks the replica down: the
        observability plane must not mutate routing state, or a
        monitoring sweep would pre-empt (and hide) the query path's own
        failover accounting."""
        out: list[dict] = []
        msg: dict = {"type": "exemplars"}
        if ctx is not None:
            msg["ctx"] = ctx
        for rep in self._replicas:
            try:
                with rep.lock:
                    if rep.client is None:
                        rep.client = self._connect(rep.addr)
                    reply = rep.client._call(dict(msg))
                for rec in reply.get("exemplars") or []:
                    rec["addr"] = rep.addr
                    out.append(rec)
            except (ConnectionError, OSError, CallTimeout):
                with rep.lock:
                    if rep.client is not None:
                        rep.client.close()
                        rep.client = None
        return out

    def _value(self, reply: dict):
        if reply.get("ok"):
            return reply["value"]
        raise ServiceError(
            reply.get("error", "internal"),
            reply.get("detail", ""),
            reply.get("partial"),
            shard=reply.get("shard"),
        )

    # --- ops (same surface as ServiceClient) ------------------------------

    def pi(self, x: int, deadline_s: float | None = None) -> int:
        return self._value(self.query("pi", deadline_s, x=x))

    def is_prime(self, x: int, deadline_s: float | None = None) -> bool:
        return bool(self._value(self.query("is_prime", deadline_s, x=x)))

    def count(self, lo: int, hi: int, kind: str = "primes",
              deadline_s: float | None = None) -> int:
        return self._value(
            self.query("count", deadline_s, lo=lo, hi=hi, kind=kind)
        )

    def nth_prime(self, k: int, deadline_s: float | None = None) -> int:
        return self._value(self.query("nth_prime", deadline_s, k=k))

    def primes(self, lo: int, hi: int,
               deadline_s: float | None = None) -> list[int]:
        return self._value(self.query("primes", deadline_s, lo=lo, hi=hi))
