"""Range-sharded router tier.

The reference's ``sieve/service/router.py``: the same routing math,
failure semantics, settings (and their ``SIEVE_*`` variables), reply
fields, counters, events and lock names, so a router of either package
fronts shard servers of either package, in v1 and v2 frames. The router
does no device work; its shard servers' cold chunks run on the card.

:class:`SieveRouter` fronts N contiguous range shards — each its own
ledger + :class:`~sieve_torch.service.client.ReplicaSet` — behind the exact
wire protocol the single server speaks (sieve_torch/rpc.py framing, the same
query/health/stats/shutdown/chaos message types, the same typed error
kinds). Clients need zero changes: a :class:`ServiceClient` pointed at
the router cannot tell it is not one server, except that the served
range is the union of every shard's.

Routing semantics, per op:

* ``is_prime(x)`` / ``nth_prime(k)`` — point queries, routed to ONE
  shard: ``is_prime`` by range (values past the map route to the last
  shard, whose cold tier extends the fabric), ``nth_prime`` by walking
  cumulative per-shard totals and forwarding ``k - primes_below`` to the
  owning shard (shard servers anchor at ``range_lo``, so their ``nth``
  is natively "k-th prime >= shard.lo").
* ``pi(x)`` / ``count(lo, hi)`` — scatter-gather as the sum of
  fully-covered shard TOTALS (cached forever: a full-shard prime count
  is an immutable math fact) plus at most two boundary-shard counts.
* ``count(lo, hi, twins|cousins)`` — per-shard pair counts (both
  members inside the shard window) plus an edge SPLICE per interior
  boundary E: primes in [E-gap, E) from the left shard and [E, E+gap)
  from the right are matched to count the pairs that straddle E —
  the same boundary-window trick the mesh merge uses for cross-device
  pairs. ``ShardMap.MIN_SPAN`` guarantees a pair straddles at most one
  edge.
* ``primes(lo, hi)`` — per-shard enumerations concatenated ascending.

Failure semantics compose from the failover client: per-shard failover and
circuit state live in each ReplicaSet (with ``probe_ttl_s`` so shard
selection never adds a probe round-trip on the hot path); a shard whose
replicas are all gone — or held down by the ``svc_shard_down`` chaos
kind — surfaces as a typed ``unavailable`` reply NAMING the shard, and
downstream typed sheds (``overloaded`` with its lane, ``degraded``,
``draining``, ``deadline_exceeded`` with its partial) are relayed with
a ``shard`` field attached. Deadline budgeting forwards the *remaining*
deadline to every downstream call; scatters always run ascending, so a
mid-scatter deadline yields the same contiguous-prefix partial contract
the single server keeps.

Fleet tracing: every routed query carries a trace context —
the client's own, or one minted here (``run_id/<seq>.0``) — and each
downstream call forwards a child context (``<ctx>/s<shard>.<call>``,
plus the ReplicaSet's per-attempt suffix), so a shard's ``rpc.query``
spans are prefix-correlated children of this router's ``rpc.route``.
When the router is tracing it also asks shards to piggyback their
bounded span rings on terminal replies; each payload is rebased onto
the router's timeline via per-replica min-RTT clock alignment (every
reply echoes receive/send timestamps — the same NTP-style estimator
the cluster coordinator uses) and ingested under a synthetic per-replica
pid, so one ``--trace`` file carries the router plus a track per shard
replica. A reply that should have carried telemetry but didn't
(``svc_trace_drop`` chaos, or a malformed payload) degrades to
uncorrelated spans: counted in ``telemetry_gaps``, evented as
``router_trace_gap``, never an error.
"""

from __future__ import annotations

import dataclasses
import math
import socket
import threading
import types
import uuid
from typing import Any

from sieve_torch.chaos import (
    ANY_WORKER,
    ChaosSchedule,
    PROFILE_KINDS,
    ROUTER_REQUEST_KINDS,
    parse_chaos,
)
from sieve_torch.enumerate import MAX_HI
from sieve_torch.debug import FlightRecorder
from sieve_torch.profile import StackProfiler
from sieve_torch.metrics import MetricsHistory, MetricsLogger, registry
import numpy as np

from sieve_torch.rpc import (
    SUPPORTED_WIRE,
    WIRE_V1,
    WIRE_V2,
    BatchOutcomes,
    batch_cols_to_items,
    encode_msg,
    encode_msg_v2,
    parse_addr,
    recv_msg,
)
from sieve_torch.service.client import CallTimeout, ReplicaSet, ServiceError
from sieve_torch.service.exemplar import EXEMPLAR_SPAN_RING, ExemplarSampler
from sieve_torch.service.server import BadRequest, DeadlineExceeded, Draining
from sieve_torch.service.shards import ShardMap
from sieve_torch import trace
from sieve_torch.analysis.lockdebug import named_lock

_PAIR_GAP = {"twins": 2, "cousins": 4}

# error kinds a downstream shard can reply with that the router relays
# verbatim (plus a "shard" field); anything else is the router's own
_RELAY_KINDS = frozenset({
    "overloaded", "degraded", "draining", "deadline_exceeded",
    "bad_request", "internal", "timeout",
})

# server wire message types the router deliberately does NOT route
# (a wire-ops audit checks this list against both dispatchers):
# "telemetry" is a per-replica span-ring flush — the router pulls it
# from each replica itself via ReplicaSet.telemetry_flush, so a client
# sending it to the router gets the standard typed unknown-type reply.
UNROUTED_TYPES = ("telemetry",)


class ShardUnavailable(Exception):
    """A shard's whole replica set is unreachable (or chaos-held down)."""

    def __init__(self, shard: int, lo: int, hi: int, reason: str):
        super().__init__(
            f"shard {shard} [{lo}, {hi}) unavailable: {reason}"
        )
        self.shard = shard
        self.lo = lo
        self.hi = hi
        self.reason = reason


class _Relay(Exception):
    """A downstream typed error to forward as-is, tagged with its shard."""

    def __init__(self, reply: dict, shard: int):
        super().__init__(reply.get("detail", reply.get("error", "")))
        self.reply = reply
        self.shard = shard


@dataclasses.dataclass
class RouterSettings:
    """Router knobs; validated at construction like ServiceSettings."""

    default_deadline_s: float = 30.0
    # downstream ReplicaSet shape
    timeout_s: float = 60.0
    probe_timeout_s: float = 2.0
    # probe freshness window: per-request shard selection
    # must not pay a health round-trip, so probes are cached this long
    probe_ttl_s: float = 2.0
    rounds: int = 2
    drain_s: float = 5.0
    wire_chaos: bool = False
    quiet: bool = False
    # flight recorder: same black box as ServiceSettings —
    # shard_down is the router's edge trigger; debug_dir is where
    # bundles freeze (None = inline-only via the ``debug`` wire op)
    recorder: bool = True
    debug_dir: str | None = None
    debug_cooldown_s: float = 30.0
    metrics_sample_s: float = 1.0
    # binary wire v2: False makes this a v1-only router —
    # hello answers ``wire: 1`` upstream AND the downstream shard legs
    # skip negotiation (the mixed-fleet simulation knob)
    wire_v2: bool = True
    # tail-sampled exemplars: same sampler as the service,
    # applied at route completion. A kept route also pulls the touched
    # shards' exemplars for its trace context (the ``exemplars`` wire
    # op), so a slow route and its downstream query land in one record.
    # Env spellings are shared with the service (SIEVE_SVC_EXEMPLAR_*).
    exemplars: bool = True
    exemplar_slack: float = 2.0
    exemplar_baseline: int = 100
    exemplar_window: int = 256
    exemplar_warmup: int = 30
    exemplar_ring: int = 256
    exemplar_file_bytes: int = 4 << 20
    # always-on continuous profiler: same sampler as the
    # service (shared SIEVE_PROF_* env spellings); prof_hz=0 disables
    prof_hz: float = 19.0
    prof_stacks: int = 512
    prof_idle: bool = False

    def validate(self) -> "RouterSettings":
        for name in ("default_deadline_s", "timeout_s", "probe_timeout_s"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v <= 0 or not math.isfinite(v):
                raise ValueError(
                    f"router settings: {name}={v!r} must be a positive "
                    "number"
                )
        for name in ("probe_ttl_s", "drain_s", "debug_cooldown_s",
                     "metrics_sample_s"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0 or not math.isfinite(v):
                raise ValueError(
                    f"router settings: {name}={v!r} must be a non-negative "
                    "number"
                )
        if not isinstance(self.rounds, int) or isinstance(self.rounds, bool) \
                or self.rounds < 1:
            raise ValueError(
                f"router settings: rounds={self.rounds!r} must be a "
                "positive integer"
            )
        for name in ("exemplar_baseline", "exemplar_window",
                     "exemplar_ring", "exemplar_file_bytes",
                     "prof_stacks"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                raise ValueError(
                    f"router settings: {name}={v!r} must be a positive "
                    "integer"
                )
        if (not isinstance(self.prof_hz, (int, float))
                or isinstance(self.prof_hz, bool) or self.prof_hz < 0
                or not math.isfinite(self.prof_hz)):
            raise ValueError(
                f"router settings: prof_hz={self.prof_hz!r} must be a "
                "non-negative number"
            )
        if (not isinstance(self.exemplar_warmup, int)
                or isinstance(self.exemplar_warmup, bool)
                or self.exemplar_warmup < 0):
            raise ValueError(
                f"router settings: exemplar_warmup="
                f"{self.exemplar_warmup!r} must be a non-negative integer"
            )
        if (not isinstance(self.exemplar_slack, (int, float))
                or isinstance(self.exemplar_slack, bool)
                or self.exemplar_slack < 1.0
                or not math.isfinite(self.exemplar_slack)):
            raise ValueError(
                f"router settings: exemplar_slack="
                f"{self.exemplar_slack!r} must be a number >= 1"
            )
        return self

    @classmethod
    def from_env(cls, **overrides: Any) -> "RouterSettings":
        """Defaults + the shared SIEVE_SVC_EXEMPLAR_* env spellings
        (the router has far fewer env knobs than the service; explicit
        overrides — the CLI flags — always win)."""
        from sieve_torch import env

        s = cls(
            exemplars=env.env_flag("SIEVE_SVC_EXEMPLARS", True),
            exemplar_slack=env.env_float(
                "SIEVE_SVC_EXEMPLAR_SLACK", cls.exemplar_slack
            ),
            exemplar_baseline=env.env_int(
                "SIEVE_SVC_EXEMPLAR_BASELINE", cls.exemplar_baseline
            ),
            exemplar_window=env.env_int(
                "SIEVE_SVC_EXEMPLAR_WINDOW", cls.exemplar_window
            ),
            exemplar_warmup=env.env_int(
                "SIEVE_SVC_EXEMPLAR_WARMUP", cls.exemplar_warmup
            ),
            exemplar_ring=env.env_int(
                "SIEVE_SVC_EXEMPLAR_RING", cls.exemplar_ring
            ),
            exemplar_file_bytes=env.env_int(
                "SIEVE_SVC_EXEMPLAR_FILE_BYTES", cls.exemplar_file_bytes
            ),
            prof_hz=env.env_float("SIEVE_PROF_HZ", cls.prof_hz),
            prof_stacks=env.env_int("SIEVE_PROF_STACKS", cls.prof_stacks),
            prof_idle=env.env_flag("SIEVE_PROF_IDLE", False),
        )
        return dataclasses.replace(s, **overrides)


class _RouteCtx:
    """Per-request scatter bookkeeping: which shards were touched, the
    contiguous prefix answered so far (for typed partials), splices,
    and the trace context downstream calls derive children from."""

    __slots__ = ("shards", "answered_hi", "count_so_far", "spliced",
                 "ctx", "calls")

    def __init__(self) -> None:
        self.shards: set[int] = set()
        self.answered_hi = 2
        self.count_so_far = 0
        self.spliced = 0
        self.ctx = ""
        self.calls = 0  # downstream calls made — numbers child contexts


_ROUTER_STATS = (
    "requests",
    "routed_point",
    "scattered",
    "spliced",
    "shard_errors",
    "unavailable_replies",
    "shed_relayed",
    "deadline_exceeded",
    "bad_requests",
    "internal_errors",
    "draining_replies",
    "shard_down_windows",
    "telemetry_merged",
    "telemetry_events",
    "telemetry_gaps",
    # batch plane: batch_rpcs counts DOWNSTREAM batch RPCs —
    # the ≤1-per-shard-per-client-batch scatter contract is gated on it
    "batch_requests",
    "batch_members",
    "batch_rpcs",
    # tail-sampled exemplars
    "exemplars_seen",
    "exemplars_kept",
    "exemplar_pulls",
    # continuous profiler
    "profile_pulls",
    "profile_gaps",
)

# synthetic pid base for per-shard-replica tracks in the merged trace
# (the cluster merge uses 1_000_000 + worker id; staying clear of it
# lets one report read a trace that carries both planes)
_REPLICA_PID_BASE = 2_000_000


class SieveRouter:
    """The shard-fabric front door. See the module docstring."""

    def __init__(
        self,
        shardmap: ShardMap,
        settings: RouterSettings | None = None,
        addr: str | None = None,
        chaos_spec: str = "",
    ):
        self.map = shardmap
        self.settings = (settings or RouterSettings()).validate()
        self._addr_req = addr or "127.0.0.1:0"
        # MetricsLogger only reads .quiet off its config; the router has
        # no SieveConfig, so a minimal shim stands in
        self.metrics = MetricsLogger(
            types.SimpleNamespace(quiet=self.settings.quiet)
        )
        s = self.settings
        self.sets = [
            ReplicaSet(
                sh.addrs,
                timeout_s=s.timeout_s,
                probe_timeout_s=s.probe_timeout_s,
                rounds=s.rounds,
                probe_ttl_s=s.probe_ttl_s,
                # shard legs go columnar when both ends speak v2; a
                # v1-only router never even offers.
                # keep_arrays: decoded primes columns stay int64 arrays
                # through _primes/_count_pairs and re-encode straight
                # into this router's own reply columns — no JSON and no
                # Python-int round trip anywhere on the path
                negotiate=None if s.wire_v2 else False,
                keep_arrays=True,
            )
            for sh in shardmap
        ]
        self.chaos = ChaosSchedule(parse_chaos(chaos_spec))
        # cumulative-totals cache: _totals[i] = primes in shard i's full
        # declared range — an immutable fact, cached forever once known
        self._totals: dict[int, int] = {}  # guard: _totals_lock
        self._totals_lock = named_lock("SieveRouter._totals_lock")
        # svc_shard_down windows: shard index -> monotonic expiry
        self._down_until: dict[int, float] = {}  # guard: _down_lock
        self._down_lock = named_lock("SieveRouter._down_lock")
        # fleet tracing: trace-ctx run id for requests that
        # arrive unstamped, per-replica clock aligners keyed by address,
        # and the synthetic pid each replica's merged track renders under
        self._run_id = uuid.uuid4().hex[:8]
        self._tele_lock = named_lock("SieveRouter._tele_lock")
        self._aligns: dict[str, trace.ClockAlign] = {}  # guard: _tele_lock
        self._replica_pids: dict[str, int] = {}  # guard: _tele_lock
        self._replica_shard: dict[str, int] = {}  # guard: _tele_lock
        self._replica_named: set[str] = set()  # guard: _tele_lock
        self._stats = {k: 0 for k in _ROUTER_STATS}  # guard: _stats_lock
        self._stats_lock = named_lock("SieveRouter._stats_lock")
        self._seq = 0  # guard: _seq_lock
        self._seq_lock = named_lock("SieveRouter._seq_lock")
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()  # guard: _conns_lock
        self._conns_lock = named_lock("SieveRouter._conns_lock")
        self._listener: socket.socket | None = None  # guard: none(set
        # once in start() before the accept thread exists)
        self._bound_addr: str | None = None
        self._closing = False  # guard: none(monotonic stop flag;
        # bool reads are GIL-atomic)
        self._draining = False  # guard: none(monotonic drain flag;
        # a racy reader sheds at most one extra request)
        self._inflight_n = 0  # guard: _inflight_lock
        self._inflight_lock = named_lock("SieveRouter._inflight_lock")
        self.drain_event = threading.Event()
        self._drained = threading.Event()
        # flight recorder: armed in start(); router_shard_down
        # is the router's edge trigger
        # continuous profiler: built before the recorder so
        # bundles embed its snapshot; per-conn dispatch threads draw the
        # svc_prof_gap chaos on a shared pull counter under _stats_lock
        self.profiler: StackProfiler | None = None
        if s.prof_hz > 0:
            self.profiler = StackProfiler(
                "router",
                hz=s.prof_hz,
                max_stacks=s.prof_stacks,
                include_idle=s.prof_idle,
            )
        self._prof_pulls = 0  # guard: _stats_lock
        self.history: MetricsHistory | None = None
        self.recorder: FlightRecorder | None = None
        if s.recorder:
            self.history = MetricsHistory(sample_s=s.metrics_sample_s)
            self.recorder = FlightRecorder(
                "router",
                debug_dir=s.debug_dir,
                history=self.history,
                config=s,
                logger=self.metrics,
                cooldown_s=s.debug_cooldown_s,
                profiler=self.profiler,
            )
        # tail-sampled exemplars: route-completion retention;
        # a kept route embeds the touched shards' downstream exemplars
        # for its trace context under "downstream"
        self.exemplar: ExemplarSampler | None = None
        if s.exemplars:
            self.exemplar = ExemplarSampler(
                "router",
                slack=s.exemplar_slack,
                baseline=s.exemplar_baseline,
                window=s.exemplar_window,
                warmup=s.exemplar_warmup,
                ring=s.exemplar_ring,
                file_bytes=s.exemplar_file_bytes,
                debug_dir=s.debug_dir,
                logger=self.metrics,
            )

    # --- lifecycle -------------------------------------------------------

    @property
    def addr(self) -> str:
        if self._bound_addr is None:
            raise RuntimeError("router not started")
        return self._bound_addr

    def start(self) -> "SieveRouter":
        host, port = parse_addr(self._addr_req)
        self._listener = socket.create_server((host, port))
        self._listener.listen(64)
        bhost, bport = self._listener.getsockname()[:2]
        self._bound_addr = f"{bhost}:{bport}"
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="router-accept")
        t.start()
        self._threads.append(t)
        if self.recorder is not None:
            self.history.start()
            self.recorder.install()
        if self.profiler is not None:
            self.profiler.start()
        if self.exemplar is not None:
            # arm the process tracer's exemplar span ring (independent
            # of full event capture — ``trace.enable`` stays off)
            trace.get_tracer().exemplar_enable(EXEMPLAR_SPAN_RING)
        return self

    def drain(self) -> None:
        """Stop accepting, shed new queries as typed ``draining``, let
        in-flight scatters finish. Idempotent; SIGTERM and the wire
        ``shutdown`` message both land here."""
        if self._draining:
            return
        self._draining = True
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._inflight_lock:
            inflight = self._inflight_n
        self.metrics.event("router_drain", inflight=inflight)
        self.drain_event.set()
        self._maybe_drained()

    def wait_drained(self, timeout: float | None = None) -> bool:
        return self._drained.wait(timeout)

    def _maybe_drained(self) -> None:
        with self._inflight_lock:
            done = self._draining and self._inflight_n == 0
        if done:
            self._drained.set()

    def stop(self) -> None:
        self._closing = True
        if self._listener is not None:
            # shutdown() before close(): a plain close does not wake a
            # thread blocked in accept(), which would stall the join below
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)
        if trace.enabled():
            # pull the residual span ring out of every shard replica
            # before the connections go away — the batched piggyback
            # only ships full batches, so the tail of the trace lives
            # here until this flush merges it
            for i, rs in enumerate(self.sets):
                try:
                    for reply in rs.telemetry_flush():
                        self._absorb_reply(i, reply)
                except Exception:  # noqa: BLE001 — stop() must not raise
                    pass
        for rs in self.sets:
            rs.close()
        if self.exemplar is not None:
            self.exemplar.close()
        if self.profiler is not None:
            self.profiler.stop()
        if self.recorder is not None:
            self.recorder.uninstall()
            self.history.stop()
        self._drained.set()

    def __enter__(self) -> "SieveRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- bookkeeping -----------------------------------------------------

    def _bump(self, name: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[name] += n
        registry().counter(f"router.{name}").inc(n)

    def _next_seq(self) -> int:
        with self._seq_lock:
            self._seq += 1
            return self._seq

    def inject_chaos(self, spec: str) -> int:
        ds = parse_chaos(spec)
        self.chaos.extend(ds)
        return len(ds)

    # --- chaos & availability --------------------------------------------

    def _draw_chaos(self, seq: int) -> None:
        """Consume svc_shard_down directives for this request sequence.
        The directive's worker field addresses a shard (ANY = every
        shard); windows extend, never shrink."""
        now = trace.now_s()
        for i in range(len(self.map)):
            for d in self.chaos.take_kinds(i, seq, ROUTER_REQUEST_KINDS):
                secs = float(d.get("param") or 0.0)
                targets = (range(len(self.map))
                           if d.get("worker") == ANY_WORKER else (i,))
                for t in targets:
                    with self._down_lock:
                        self._down_until[t] = max(
                            self._down_until.get(t, 0.0), now + secs
                        )
                    self._bump("shard_down_windows")
                    reason = f"chaos svc_shard_down ({secs}s)"
                    self.metrics.event(
                        "router_shard_down", shard=t, reason=reason,
                    )
                    if self.recorder is not None:
                        self.recorder.trigger(
                            "shard_down", shard=t, reason=reason,
                        )

    def _check_shard_up(self, i: int) -> None:
        with self._down_lock:
            until = self._down_until.get(i, 0.0)
        if trace.now_s() < until:
            sh = self.map.shards[i]
            raise ShardUnavailable(
                i, sh.lo, sh.hi,
                "svc_shard_down window live "
                f"({until - trace.now_s():.2f}s remaining)",
            )

    # --- downstream calls ------------------------------------------------

    def _shard_query(self, i: int, op: str, deadline: float,
                     rctx: _RouteCtx, **params: Any):
        """One downstream call with deadline budgeting + typed relay.

        Raises :class:`DeadlineExceeded` when the budget is spent,
        :class:`ShardUnavailable` when the shard cannot answer at all,
        and :class:`_Relay` for downstream typed errors."""
        self._check_shard_up(i)
        remaining = deadline - trace.now_s()
        if remaining <= 0:
            raise DeadlineExceeded(rctx.answered_hi, rctx.count_so_far)
        rctx.shards.add(i)
        rctx.calls += 1
        # child trace ctx: <route ctx>/s<shard>.<call>; the ReplicaSet
        # appends its own .<attempt>, so the shard-side span context is
        # prefix-correlated with this route AND unique per wire attempt
        child_ctx = f"{rctx.ctx}/s{i}.{rctx.calls}"
        sh = self.map.shards[i]
        t0 = trace.now_s()
        outcome = "ok"
        try:
            try:
                reply = self.sets[i].query(op, deadline_s=remaining,
                                           ctx=child_ctx,
                                           telemetry=trace.enabled(),
                                           **params)
            except (ServiceError, CallTimeout) as e:
                # ReplicaSet exhaustion ("unavailable") or a poisoned
                # call: the shard as a whole could not answer
                outcome = "unavailable"
                raise ShardUnavailable(i, sh.lo, sh.hi, str(e)) from None
            self._absorb_reply(i, reply)
            if reply.get("ok"):
                return reply["value"]
            outcome = str(reply.get("error", "internal"))
            raise _Relay(reply, i)
        finally:
            trace.add_span("route.scatter", t0, trace.now_s() - t0,
                           shard=i, op=op, outcome=outcome, ctx=child_ctx)

    def _absorb_reply(self, shard: int, reply: dict) -> None:
        """Fold one downstream reply's trace freight into the router:
        sample the replica's clock aligner from the echoed timestamps,
        then rebase + ingest any piggybacked span ring under the
        replica's synthetic pid. A reply whose telemetry was dropped or
        mangled degrades to a counted ``router_trace_gap`` — correlation
        is lost for those spans, the query result is untouched."""
        probe = reply.get("probe")
        probe = probe if isinstance(probe, dict) else {}
        addr = probe.get("addr")
        align = None
        if isinstance(addr, str) and addr:
            with self._tele_lock:
                align = self._aligns.get(addr)
                if align is None:
                    align = self._aligns[addr] = trace.ClockAlign()
                    self._replica_pids[addr] = (
                        _REPLICA_PID_BASE + len(self._replica_pids)
                    )
                    self._replica_shard[addr] = shard
            stamps = (probe.get("t_send"), reply.get("t_recv"),
                      reply.get("t_sent"), probe.get("t_done"))
            if all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in stamps):
                align.sample(*stamps)
                reg = registry()
                reg.gauge(f"router.replica.{addr}.clock_offset_s").set(
                    round(align.offset_s, 6)
                )
                reg.gauge(f"router.replica.{addr}.clock_err_s").set(
                    round(align.err_s, 6)
                )
        if "telemetry" not in reply:
            return  # replica not shipping (e.g. in-process embed): fine
        tele = reply.pop("telemetry")
        if not isinstance(tele, dict):
            self._bump("telemetry_gaps")
            self.metrics.event(
                "router_trace_gap", quietable=True, shard=shard,
                reason="dropped" if tele is None else "malformed",
                replica=addr or "?",
            )
            return
        events = tele.get("events") or []
        dropped = int(tele.get("dropped") or 0)
        with self._tele_lock:
            key = addr if isinstance(addr, str) and addr else f"shard{shard}"
            pid = self._replica_pids.get(key)
            if pid is None:
                pid = self._replica_pids[key] = (
                    _REPLICA_PID_BASE + len(self._replica_pids)
                )
                self._replica_shard[key] = shard
            first = key not in self._replica_named
            self._replica_named.add(key)
        off_us = (align.offset_s if align is not None and align.samples
                  else 0.0) * 1e6
        merged: list[dict] = []
        if first:
            merged.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"shard{shard} {key}"},
            })
        for e in events:
            e = dict(e)
            if "ts" in e:
                e["ts"] = round(e["ts"] - off_us, 3)
            e["pid"] = pid
            merged.append(e)
        info: dict[str, Any] = {"shard": shard, "replica": key,
                                "events": len(events), "dropped": dropped}
        if align is not None and align.samples:
            info.update(
                offset_s=round(align.offset_s, 6),
                rtt_s=round(align.rtt_s, 6),
                err_s=round(align.err_s, 6),
                samples=align.samples,
            )
        merged.append({
            "name": "clock.align", "ph": "i", "s": "p",
            "ts": round(trace.now_s() * 1e6, 3), "pid": pid, "tid": 0,
            "args": info,
        })
        trace.get_tracer().ingest(merged)
        self._bump("telemetry_merged")
        self._bump("telemetry_events", len(events))
        if first:
            # one track-established event per replica, not one per reply
            self.metrics.event("router_telemetry", quietable=True, **info)

    def _shard_total(self, i: int, deadline: float, rctx: _RouteCtx) -> int:
        """Primes in shard i's full declared range, cached forever."""
        with self._totals_lock:
            if i in self._totals:
                registry().counter("router.totals_hit").inc()
                return self._totals[i]
        registry().counter("router.totals_miss").inc()
        sh = self.map.shards[i]
        total = self._shard_query(i, "count", deadline, rctx,
                                  lo=sh.lo, hi=sh.hi)
        with self._totals_lock:
            self._totals[i] = int(total)
        return int(total)

    # --- routed ops ------------------------------------------------------

    def _execute(self, op: str, msg: dict, deadline: float,
                 rctx: _RouteCtx):
        if op == "pi":
            x = _req_int(msg, "x")
            if x < 0 or x + 1 > MAX_HI:
                raise BadRequest(f"pi({x}): x must be in [0, {MAX_HI})")
            self._bump("scattered")
            return self._count_primes(2, x + 1, deadline, rctx)
        if op == "is_prime":
            x = _req_int(msg, "x")
            if x + 1 > MAX_HI:
                raise BadRequest(f"is_prime({x}): x must be < {MAX_HI}")
            if x < 2:
                return False
            self._bump("routed_point")
            i = self.map.shard_for(x)
            rctx.answered_hi = max(rctx.answered_hi, x)
            return bool(self._shard_query(i, "is_prime", deadline, rctx,
                                          x=x))
        if op == "count":
            lo, hi = _req_int(msg, "lo"), _req_int(msg, "hi")
            kind = str(msg.get("kind", "primes"))
            if hi > MAX_HI:
                raise BadRequest(f"count: hi={hi} exceeds {MAX_HI}")
            if hi < lo:
                raise BadRequest(f"count: hi={hi} < lo={lo}")
            self._bump("scattered")
            if kind == "primes":
                return self._count_primes(lo, hi, deadline, rctx)
            if kind in _PAIR_GAP:
                return self._count_pairs(lo, hi, kind, deadline, rctx)
            raise BadRequest(
                f"count: unknown kind {kind!r} (primes, twins, cousins)"
            )
        if op == "nth_prime":
            k = _req_int(msg, "k")
            if k < 1:
                raise BadRequest(f"nth_prime({k}): k must be >= 1")
            self._bump("routed_point")
            return self._nth_prime(k, deadline, rctx)
        if op == "primes":
            lo, hi = _req_int(msg, "lo"), _req_int(msg, "hi")
            if hi > MAX_HI:
                raise BadRequest(f"primes: hi={hi} exceeds {MAX_HI}")
            if hi < lo:
                raise BadRequest(f"primes: hi={hi} < lo={lo}")
            self._bump("scattered")
            return self._primes(lo, hi, deadline, rctx)
        if op == "batch":
            return self._execute_batch(msg, deadline, rctx)
        raise BadRequest(
            f"unknown op {op!r} (one of pi, is_prime, count, nth_prime, "
            "primes, batch)"
        )

    def _shard_batch(self, i: int, items: list[dict], deadline: float,
                     rctx: _RouteCtx) -> list[dict]:
        """ONE downstream ``batch`` RPC to shard i (the scatter
        contract gated by the ``batch_rpcs`` counter). Same budgeting,
        chaos gate, telemetry absorption, and typed relay as
        :meth:`_shard_query`."""
        self._check_shard_up(i)
        remaining = deadline - trace.now_s()
        if remaining <= 0:
            raise DeadlineExceeded(rctx.answered_hi, rctx.count_so_far)
        rctx.shards.add(i)
        rctx.calls += 1
        child_ctx = f"{rctx.ctx}/s{i}.{rctx.calls}"
        sh = self.map.shards[i]
        self._bump("batch_rpcs")
        t0 = trace.now_s()
        outcome = "ok"
        try:
            try:
                reply = self.sets[i].query("batch", deadline_s=remaining,
                                           ctx=child_ctx,
                                           telemetry=trace.enabled(),
                                           items=items)
            except (ServiceError, CallTimeout) as e:
                outcome = "unavailable"
                raise ShardUnavailable(i, sh.lo, sh.hi, str(e)) from None
            self._absorb_reply(i, reply)
            if reply.get("ok"):
                return reply["value"]
            outcome = str(reply.get("error", "internal"))
            raise _Relay(reply, i)
        finally:
            trace.add_span("route.scatter", t0, trace.now_s() - t0,
                           shard=i, op="batch", outcome=outcome,
                           ctx=child_ctx)

    def _execute_batch(self, msg: dict, deadline: float,
                       rctx: _RouteCtx) -> list[dict]:
        """Routed ``batch``: M member queries fan out as at
        most ONE downstream batch RPC per shard.

        Each member decomposes exactly like its scalar op — is_prime
        routes point to its owning shard; pi/count(kind=primes) split
        into per-shard count sub-queries, with fully-covered shards
        served from the immutable totals cache (a miss rides the same
        batch RPC and fills the cache). Sub-queries are deduped per
        shard, so a batch of M members never costs a shard more than
        its distinct sub-query set in one RPC. A shard that fails
        (unavailable / typed relay / spent deadline) fails ONLY the
        members with a term on it — each gets a typed outcome tagged
        with the shard — while members on healthy shards still answer
        exactly."""
        if "b_op" in msg:
            # columnar v2 request: rebuild member dicts and
            # run the ordinary planner — the router's work per member
            # is routing, not decoding, so the dict form costs nothing
            # extra here and the per-shard legs re-pack into columns
            # anyway (each ReplicaSet client negotiates its own wire)
            try:
                items = batch_cols_to_items(
                    msg["b_op"], msg["b_a"], msg["b_b"])
            except (KeyError, TypeError, ValueError):
                raise BadRequest(
                    "batch: malformed b_op/b_a/b_b columns") from None
        else:
            items = msg.get("items")
        if not isinstance(items, list) or not items:
            raise BadRequest("batch: items must be a non-empty list")
        self._bump("batch_requests")
        self._bump("batch_members", len(items))
        self._bump("scattered")
        per_shard: dict[int, dict[tuple, dict]] = {}

        def term(i: int, key: tuple, sub: dict) -> tuple[int, tuple]:
            per_shard.setdefault(i, {}).setdefault(key, sub)
            return (i, key)

        # plan each member:
        #   ("err", outcome) | ("const", op, value)
        #   | ("point", op, term) | ("sum", op, const, [terms])
        plans: list[tuple] = []
        for m in items:
            mop = str(m.get("op", "")) if isinstance(m, dict) else ""
            try:
                if not isinstance(m, dict):
                    raise BadRequest("batch member must be an object")
                if mop == "is_prime":
                    x = _req_int(m, "x")
                    if x + 1 > MAX_HI:
                        raise BadRequest(
                            f"is_prime({x}): x must be < {MAX_HI}"
                        )
                    if x < 2:
                        plans.append(("const", mop, False))
                        continue
                    i = self.map.shard_for(x)
                    plans.append(("point", mop,
                                  term(i, ("is_prime", x),
                                       {"op": "is_prime", "x": x})))
                elif mop in ("pi", "count"):
                    if mop == "pi":
                        x = _req_int(m, "x")
                        if x < 0 or x + 1 > MAX_HI:
                            raise BadRequest(
                                f"pi({x}): x must be in [0, {MAX_HI})"
                            )
                        lo, hi = 2, x + 1
                    else:
                        lo, hi = _req_int(m, "lo"), _req_int(m, "hi")
                        if hi > MAX_HI:
                            raise BadRequest(
                                f"count: hi={hi} exceeds {MAX_HI}"
                            )
                        if hi < lo:
                            raise BadRequest(f"count: hi={hi} < lo={lo}")
                        if str(m.get("kind", "primes")) != "primes":
                            raise BadRequest(
                                "batch count members support "
                                "kind=primes only"
                            )
                        lo = max(lo, 2)
                    if hi <= lo:
                        plans.append(("const", mop, 0))
                        continue
                    if lo < self.map.lo:
                        raise BadRequest(
                            f"{mop}: lo={lo} below the fabric range "
                            f"[{self.map.lo}, ...)"
                        )
                    const = 0
                    terms: list[tuple[int, tuple]] = []
                    for i, a, b in self.map.shards_in(lo, hi):
                        sh = self.map.shards[i]
                        if (a, b) == (sh.lo, sh.hi):
                            with self._totals_lock:
                                cached = self._totals.get(i)
                            if cached is not None:
                                registry().counter("router.totals_hit").inc()
                                const += cached
                                continue
                            registry().counter("router.totals_miss").inc()
                        terms.append(term(i, ("count", a, b),
                                          {"op": "count", "lo": a, "hi": b}))
                    plans.append(("sum", mop, const, terms))
                else:
                    raise BadRequest(
                        f"unknown batch member op {mop!r} "
                        "(one of pi, is_prime, count)"
                    )
            except BadRequest as e:
                plans.append(("err", {
                    "ok": False, "op": mop, "error": "bad_request",
                    "detail": str(e), "partial": None,
                }))
        # scatter: ONE deduped batch RPC per touched shard, ascending
        resolved: dict[tuple[int, tuple], dict] = {}
        for i in sorted(per_shard):
            keys = sorted(per_shard[i])
            subs = [per_shard[i][k] for k in keys]
            fault: dict | None = None
            try:
                outs = self._shard_batch(i, subs, deadline, rctx)
                if not isinstance(outs, list) or len(outs) != len(subs):
                    got = (len(outs) if isinstance(outs, list)
                           else type(outs).__name__)
                    sh = self.map.shards[i]
                    raise ShardUnavailable(
                        i, sh.lo, sh.hi,
                        f"batch reply shape: {got} outcomes for "
                        f"{len(subs)} members",
                    )
            except ShardUnavailable as e:
                self._bump("shard_errors")
                fault = {"error": "unavailable", "detail": str(e),
                         "partial": None}
            except DeadlineExceeded as e:
                fault = {"error": "deadline_exceeded", "detail": str(e),
                         "partial": {"answered_hi": e.answered_hi,
                                     "count_so_far": e.count_so_far}}
            except _Relay as e:
                self._bump("shard_errors")
                fault = {"error": str(e.reply.get("error", "internal")),
                         "detail": e.reply.get("detail", ""),
                         "partial": e.reply.get("partial")}
            if fault is not None:
                for k in keys:
                    resolved[(i, k)] = {"ok": False, "shard": i, **fault}
                continue
            for k, o in zip(keys, outs):
                if not isinstance(o, dict):
                    o = {"ok": False, "error": "internal",
                         "detail": "malformed batch member outcome"}
                if not o.get("ok"):
                    o.setdefault("shard", i)
                elif k[0] == "count":
                    # a full-shard count rode along: fill the totals
                    # cache (immutable math fact, cached forever)
                    sh = self.map.shards[i]
                    if (k[1], k[2]) == (sh.lo, sh.hi):
                        with self._totals_lock:
                            self._totals.setdefault(i, int(o["value"]))
                resolved[(i, k)] = o
        # assemble per-member outcomes, in member order
        out: list[dict] = []
        for plan in plans:
            kind = plan[0]
            if kind == "err":
                out.append(plan[1])
            elif kind == "const":
                out.append({"ok": True, "op": plan[1], "value": plan[2]})
            elif kind == "point":
                o = dict(resolved[plan[2]])
                o["op"] = plan[1]
                if o.get("ok"):
                    o["value"] = bool(o["value"])
                out.append(o)
            else:  # sum
                _, mop, const, terms = plan
                bad = next((resolved[t] for t in terms
                            if not resolved[t].get("ok")), None)
                if bad is not None:
                    o = dict(bad)
                    o["op"] = mop
                    out.append(o)
                else:
                    out.append({"ok": True, "op": mop,
                                "value": const + sum(
                                    int(resolved[t]["value"])
                                    for t in terms)})
        return out

    @staticmethod
    def _partial(op: str, rctx: _RouteCtx) -> dict:
        """Typed partial in the single server's key schema: the fabric
        prefix [map.lo, answered_hi) is fully answered."""
        if op == "pi":
            return {"answered_hi": rctx.answered_hi,
                    "pi_so_far": rctx.count_so_far}
        if op == "nth_prime":
            return {"searched_hi": rctx.answered_hi,
                    "count_so_far": rctx.count_so_far}
        return {"answered_hi": rctx.answered_hi,
                "count_so_far": rctx.count_so_far}

    def _fold_partial(self, e: _Relay, rctx: _RouteCtx) -> None:
        """A downstream deadline partial is a contiguous prefix of ITS
        shard window; since scatters run ascending, folding it into the
        route context keeps the fabric-level prefix contiguous too."""
        p = e.reply.get("partial") or {}
        hi = p.get("answered_hi", p.get("searched_hi"))
        if isinstance(hi, int):
            rctx.answered_hi = max(rctx.answered_hi, hi)
        c = p.get("count_so_far", p.get("pi_so_far"))
        if isinstance(c, int):
            rctx.count_so_far += c

    def _count_primes(self, lo: int, hi: int, deadline: float,
                      rctx: _RouteCtx) -> int:
        lo = max(lo, 2)
        if hi <= lo:
            return 0
        if lo < self.map.lo:
            raise BadRequest(
                f"count: lo={lo} below the fabric range "
                f"[{self.map.lo}, ...)"
            )
        total = 0
        for i, a, b in self.map.shards_in(lo, hi):
            sh = self.map.shards[i]
            if (a, b) == (sh.lo, sh.hi):
                v = self._shard_total(i, deadline, rctx)
            else:
                v = self._shard_query(i, "count", deadline, rctx,
                                      lo=a, hi=b)
            total += int(v)
            rctx.answered_hi = max(rctx.answered_hi, b)
            rctx.count_so_far = total
        return total

    def _count_pairs(self, lo: int, hi: int, kind: str, deadline: float,
                     rctx: _RouteCtx) -> int:
        gap = _PAIR_GAP[kind]
        lo = max(lo, 2)
        if hi <= lo:
            return 0
        if lo < self.map.lo:
            raise BadRequest(
                f"count: lo={lo} below the fabric range "
                f"[{self.map.lo}, ...)"
            )
        parts = self.map.shards_in(lo, hi)
        total = 0
        # pairs fully inside one shard window
        for i, a, b in parts:
            total += int(self._shard_query(i, "count", deadline, rctx,
                                           lo=a, hi=b, kind=kind))
        # splice each interior edge E: a straddling pair (p, p+gap) has
        # p in [E-gap, E) on the left shard and p+gap in [E, E+gap) on
        # the right — MIN_SPAN guarantees both windows stay inside their
        # shard, so each downstream ask is range-legal
        for (il, _al, bl), (ir, ar, _br) in zip(parts, parts[1:]):
            edge = bl
            assert edge == ar, "shards_in returned non-adjacent parts"
            left_lo = max(lo, edge - gap)
            right_hi = min(hi, edge + gap)
            if left_lo >= edge or right_hi <= edge:
                continue
            left = self._shard_query(il, "primes", deadline, rctx,
                                     lo=left_lo, hi=edge)
            right = set(self._shard_query(ir, "primes", deadline, rctx,
                                          lo=edge, hi=right_hi))
            crossing = sum(1 for p in left if p + gap in right)
            total += crossing
            rctx.spliced += 1
            self._bump("spliced")
            self.metrics.event("router_spliced", quietable=True,
                               edge=edge, pair_kind=kind, pairs=crossing)
        return total

    def _nth_prime(self, k: int, deadline: float, rctx: _RouteCtx) -> int:
        cum = 0
        last = len(self.map) - 1
        for i in range(len(self.map)):
            if i == last:
                # the last shard extends past the map via its cold tier;
                # whatever k remains, it owns the answer
                return int(self._shard_query(i, "nth_prime", deadline,
                                             rctx, k=k - cum))
            total = self._shard_total(i, deadline, rctx)
            if cum + total >= k:
                return int(self._shard_query(i, "nth_prime", deadline,
                                             rctx, k=k - cum))
            cum += total
            rctx.answered_hi = max(rctx.answered_hi,
                                   self.map.shards[i].hi)
            rctx.count_so_far = cum
        raise AssertionError("unreachable: last shard handles any k")

    def _primes(self, lo: int, hi: int, deadline: float,
                rctx: _RouteCtx) -> np.ndarray:
        lo = max(lo, 2)
        if hi <= lo:
            return np.zeros(0, dtype=np.int64)
        if lo < self.map.lo:
            raise BadRequest(
                f"primes: lo={lo} below the fabric range "
                f"[{self.map.lo}, ...)"
            )
        # shard legs deliver int64 arrays (keep_arrays clients decode
        # the binary columns straight into them); v1 shards hand lists,
        # normalized here once — member order is ascending by shard
        parts: list[np.ndarray] = []
        count = 0
        for i, a, b in self.map.shards_in(lo, hi):
            vals = np.asarray(
                self._shard_query(i, "primes", deadline, rctx,
                                  lo=a, hi=b),
                dtype=np.int64,
            )
            parts.append(vals)
            count += int(vals.size)
            rctx.answered_hi = max(rctx.answered_hi, b)
            rctx.count_so_far = count
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype=np.int64))

    # --- control plane ---------------------------------------------------

    def health(self) -> dict:
        """Aggregate health: per-shard depth/brownout/covered_hi plus the
        fabric's contiguous covered range (covered_hi stops at the first
        shard that is unreachable or still behind its declared range)."""
        shards_out = []
        covered_hi = self.map.lo
        contiguous = True
        degraded = False
        now = trace.now_s()
        for i, sh in enumerate(self.map.shards):
            with self._down_lock:
                held_down = now < self._down_until.get(i, 0.0)
            ent: dict[str, Any] = {"shard": i, "lo": sh.lo, "hi": sh.hi,
                                   "addrs": list(sh.addrs)}
            if held_down:
                ent["status"] = "unavailable"
                ent["detail"] = "svc_shard_down window live"
            else:
                try:
                    h = self.sets[i].health()
                    ent["status"] = h.get("status", "ok")
                    ent["covered_hi"] = h.get("covered_hi")
                    ent["queue_depth"] = h.get("queue_depth")
                    ent["brownout"] = h.get("brownout")
                    ent["draining"] = h.get("draining")
                    gauges = registry()
                    gauges.gauge(f"router.shard{i}.queue_depth").set(
                        float(h.get("queue_depth") or 0)
                    )
                    gauges.gauge(f"router.shard{i}.covered_hi").set(
                        float(h.get("covered_hi") or 0)
                    )
                except ServiceError as e:
                    ent["status"] = "unavailable"
                    ent["detail"] = e.detail
            if ent["status"] == "unavailable":
                degraded = True
                contiguous = False
            elif contiguous:
                # the fabric's contiguous covered range stops at the
                # first shard whose index falls short of its slice; the
                # last shard's cold-grown coverage extends past the map
                sh_cov = int(ent.get("covered_hi") or sh.lo)
                is_last = i == len(self.map) - 1
                covered_hi = max(
                    covered_hi, sh_cov if is_last else min(sh_cov, sh.hi)
                )
                if sh_cov < sh.hi:
                    contiguous = False
            if ent.get("status") == "degraded":
                degraded = True
            shards_out.append(ent)
        return {
            "type": "health", "ok": True,
            "status": "degraded" if degraded else "ok",
            "role": "router",
            "shard_count": len(self.map),
            "range_lo": self.map.lo,
            "range_hi": self.map.hi,
            "covered_hi": covered_hi,
            "draining": self._draining,
            "shards": shards_out,
        }

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["shard_count"] = len(self.map)
        out["range_lo"] = self.map.lo
        out["range_hi"] = self.map.hi
        with self._totals_lock:
            out["totals_cached"] = len(self._totals)
        out["draining"] = self._draining
        out["probes"] = sum(rs.probes for rs in self.sets)
        out["failovers"] = sum(rs.failovers for rs in self.sets)
        # shard connections that came up v1-only — a nonzero
        # value on a supposedly all-v2 fleet is the downgrade signal
        out["wire_downgrades"] = sum(rs.downgrades for rs in self.sets)
        return out

    # --- network plumbing ------------------------------------------------

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                # hot RPC path: replies leave on send, not on the
                # peer's delayed ACK (same knob as the shard server)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            with self._conns_lock:
                self._conns.add(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="router-conn",
            )
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        # per-connection negotiated send version: a mutable
        # cell rather than a conn attribute — this thread owns the conn,
        # only the hello branch writes it
        state = {"wire_v": WIRE_V1}  # guard: none(owned by this
        # conn's serve thread; the hello branch is the only writer and
        # runs on the same thread as every reader)
        try:
            while not self._closing:
                try:
                    msg = recv_msg(conn)
                except (OSError, ValueError):
                    return
                if msg is None:
                    return
                self._dispatch(conn, send_lock, msg, state)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _reply(self, conn: socket.socket, send_lock: threading.Lock,
               payload: dict, cols: dict | None = None) -> None:
        frame = (encode_msg_v2(payload, cols) if cols
                 else encode_msg(payload))
        try:
            with send_lock:
                conn.sendall(frame)
        except OSError:
            pass

    def _dispatch(self, conn, send_lock, msg: dict, state: dict) -> None:
        mtype = msg.get("type")
        rid = msg.get("id")
        if mtype == "hello":
            # wire-version negotiation: same contract as the
            # shard server — highest mutual version, v1 JSON floor. A
            # wire_v2=False router answers 1, and its v2-capable caller
            # logs the wire_downgrade.
            try:
                peer = {int(v) for v in (msg.get("wire") or ())
                        if not isinstance(v, bool)}
            except (TypeError, ValueError):
                peer = set()
            mine = set(SUPPORTED_WIRE) if self.settings.wire_v2 \
                else {WIRE_V1}
            mutual = peer & mine
            state["wire_v"] = max(mutual) if mutual else WIRE_V1
            self._reply(conn, send_lock,
                        {"type": "hello", "id": rid, "ok": True,
                         "wire": state["wire_v"],
                         "versions": sorted(mine)})
            return
        if mtype == "health":
            h = self.health()
            h["id"] = rid
            self._reply(conn, send_lock, h)
            return
        if mtype == "stats":
            self._reply(conn, send_lock,
                        {"type": "stats", "id": rid, "ok": True,
                         "stats": self.stats()})
            return
        if mtype == "metrics":
            # live telemetry plane: the full registry
            # snapshot, answered inline so fleet_top keeps seeing it
            # even while the query plane is under pressure
            self._reply(conn, send_lock,
                        {"type": "metrics", "id": rid, "ok": True,
                         "role": "router",
                         "metrics": registry().snapshot()})
            return
        if mtype == "debug":
            # flight-recorder freeze: inline like metrics
            self._reply(conn, send_lock, {
                "type": "debug", "id": rid, "ok": True, "role": "router",
                "bundle": (self.recorder.snapshot("manual")
                           if self.recorder is not None else None),
            })
            return
        if mtype == "profile":
            # continuous-profiler pull: inline like debug.
            # svc_prof_gap chaos drops the K-th reply (puller times
            # out) and pauses the sampler one beat; the shared pull
            # counter lives under _stats_lock (per-conn threads).
            with self._stats_lock:
                self._prof_pulls += 1
                pulls = self._prof_pulls
            gap = bool(self.chaos.take_kinds(0, pulls, PROFILE_KINDS))
            snap = (self.profiler.snapshot()
                    if self.profiler is not None else None)
            self.metrics.event(
                "profile_pulled", quietable=True, role="router",
                samples=(snap or {}).get("samples"),
                stacks=len((snap or {}).get("stacks") or ()), gap=gap,
            )
            if gap:
                self._bump("profile_gaps")
                if self.profiler is not None:
                    self.profiler.pause(1)
                return
            self._bump("profile_pulls")
            self._reply(conn, send_lock, {
                "type": "profile", "id": rid, "ok": True,
                "role": "router", "profile": snap,
            })
            return
        if mtype == "exemplars":
            # kept-exemplar pull: the router's own ring —
            # each record already embeds its downstream shard exemplars
            ctx_f = msg.get("ctx")
            n_f = msg.get("n")
            self._reply(conn, send_lock, {
                "type": "exemplars", "id": rid, "ok": True,
                "role": "router",
                "exemplars": (self.exemplar.tail(
                    n=n_f if isinstance(n_f, int) else None,
                    ctx_prefix=ctx_f if isinstance(ctx_f, str) else None,
                ) if self.exemplar is not None else []),
            })
            return
        if mtype == "shutdown":
            self._reply(conn, send_lock,
                        {"type": "reply", "id": rid, "ok": True,
                         "draining": True})
            self.drain()
            return
        if mtype == "chaos":
            if not self.settings.wire_chaos:
                self.metrics.event("router_chaos_refused",
                                   spec=str(msg.get("spec", "")))
                self._reply(conn, send_lock, {
                    "type": "reply", "id": rid, "ok": False,
                    "error": "bad_request",
                    "detail": "wire chaos injection is disabled on this "
                              "router (start it with --allow-chaos)",
                })
                return
            try:
                n = self.inject_chaos(str(msg.get("spec", "")))
            except ValueError as e:
                self._reply(conn, send_lock,
                            {"type": "reply", "id": rid, "ok": False,
                             "error": "bad_request", "detail": str(e)})
                return
            self._reply(conn, send_lock,
                        {"type": "reply", "id": rid, "ok": True,
                         "injected": n})
            return
        if mtype != "query":
            self._reply(conn, send_lock, {
                "type": "reply", "id": rid, "ok": False,
                "error": "bad_request",
                "detail": f"unknown message type {mtype!r}",
            })
            return
        self._handle_query(conn, send_lock, msg, rid, state)

    def _handle_query(self, conn, send_lock, msg: dict, rid,
                      state: dict) -> None:
        with self._inflight_lock:
            self._inflight_n += 1
        try:
            self._handle_query_inner(conn, send_lock, msg, rid, state)
        finally:
            with self._inflight_lock:
                self._inflight_n -= 1
            self._maybe_drained()

    def _handle_query_inner(self, conn, send_lock, msg: dict, rid,
                            state: dict) -> None:
        op = str(msg.get("op", ""))
        t0 = trace.now_s()
        seq = self._next_seq()
        self._bump("requests")
        self._draw_chaos(seq)
        rctx = _RouteCtx()
        # adopt the client's trace ctx, or mint one so downstream child
        # contexts are well-formed even for unstamped (old) clients
        mctx = msg.get("ctx")
        rctx.ctx = (mctx if isinstance(mctx, str) and mctx
                    else f"{self._run_id}/{seq}.0")
        outcome = "ok"
        reply: dict = {"type": "reply", "id": rid, "ok": True, "op": op}
        try:
            if self._draining:
                raise Draining("router is draining; new queries are shed")
            raw = msg.get("deadline_s")
            if raw is not None and (
                not isinstance(raw, (int, float)) or isinstance(raw, bool)
                or raw <= 0 or not math.isfinite(raw)
            ):
                raise BadRequest(
                    f"deadline_s must be a positive number, got {raw!r}"
                )
            deadline = t0 + float(raw or self.settings.default_deadline_s)
            reply["value"] = self._execute(op, msg, deadline, rctx)
        except _Relay as e:
            down = e.reply
            outcome = str(down.get("error", "internal"))
            if outcome not in _RELAY_KINDS:
                outcome = "internal"
            self._bump("shard_errors")
            if outcome == "deadline_exceeded":
                # fold the shard's contiguous partial into the route's:
                # scatters run ascending, so the fabric-level prefix
                # [2, answered_hi) stays contiguous
                self._fold_partial(e, rctx)
                self._bump("deadline_exceeded")
                reply = {
                    "type": "reply", "id": rid, "ok": False, "op": op,
                    "error": "deadline_exceeded",
                    "detail": down.get("detail", ""),
                    "partial": self._partial(op, rctx),
                    "shard": e.shard,
                }
            else:
                # forwarded verbatim + shard tag (lane rides along on
                # an overloaded shed — lane-aware propagation)
                reply = {
                    "type": "reply", "id": rid, "ok": False, "op": op,
                    "error": outcome,
                    "detail": down.get("detail", ""),
                    "partial": down.get("partial"),
                    "shard": e.shard,
                }
                if "lane" in down:
                    reply["lane"] = down["lane"]
                if outcome in ("overloaded", "degraded", "draining"):
                    self._bump("shed_relayed")
        except ShardUnavailable as e:
            outcome = "unavailable"
            reply = {
                "type": "reply", "id": rid, "ok": False, "op": op,
                "error": "unavailable", "detail": str(e),
                "partial": None, "shard": e.shard,
                "shard_range": [e.lo, e.hi],
            }
            self._bump("shard_errors")
            self._bump("unavailable_replies")
            self.metrics.event("router_shard_down", shard=e.shard,
                               reason=e.reason)
            if self.recorder is not None:
                self.recorder.trigger("shard_down", shard=e.shard,
                                      reason=e.reason)
        except DeadlineExceeded as e:
            outcome = "deadline_exceeded"
            rctx.answered_hi = max(rctx.answered_hi, e.answered_hi)
            rctx.count_so_far = max(rctx.count_so_far, e.count_so_far)
            reply = {
                "type": "reply", "id": rid, "ok": False, "op": op,
                "error": "deadline_exceeded", "detail": str(e),
                "partial": self._partial(op, rctx),
            }
            self._bump("deadline_exceeded")
        except BadRequest as e:
            outcome = "bad_request"
            reply = {
                "type": "reply", "id": rid, "ok": False, "op": op,
                "error": "bad_request", "detail": str(e), "partial": None,
            }
            self._bump("bad_requests")
        except Draining as e:
            outcome = "draining"
            reply = {
                "type": "reply", "id": rid, "ok": False, "op": op,
                "error": "draining", "detail": str(e), "partial": None,
            }
            self._bump("draining_replies")
        except Exception as e:  # noqa: BLE001 — router must not die
            outcome = "internal"
            reply = {
                "type": "reply", "id": rid, "ok": False, "op": op,
                "error": "internal",
                "detail": f"{type(e).__name__}: {e}", "partial": None,
            }
            self._bump("internal_errors")
        t_end = trace.now_s()
        reply.setdefault("source", "router")
        reply["elapsed_ms"] = round((t_end - t0) * 1000, 3)
        if isinstance(msg.get("t_send"), (int, float)) \
                and not isinstance(msg.get("t_send"), bool):
            # echo receive/send stamps so a tracing CALLER (a client, or
            # a router-of-routers) can clock-align against this process
            reply["t_recv"] = round(t0, 6)
            reply["t_sent"] = round(t_end, 6)
        trace.add_span("rpc.route", t0, t_end - t0, op=op, outcome=outcome,
                       shards=len(rctx.shards), ctx=rctx.ctx)
        self.metrics.event(
            "router_request", quietable=True, op=op, outcome=outcome,
            shards=len(rctx.shards), ms=reply["elapsed_ms"],
        )
        # reply finalization: array/batch values go out as v2
        # columns on a negotiated connection — the shard legs already
        # delivered them as arrays (keep_arrays), so a routed primes
        # window is never JSON-encoded per element anywhere on its path
        cols = None
        val = reply.get("value")
        if isinstance(val, np.ndarray):
            if state["wire_v"] >= WIRE_V2:
                del reply["value"]
                # values column, not bitset words: the window spans
                # shards whose packings may differ, and the router has
                # no layout of its own to re-pack against
                reply.update({"vkind": "primes", "prepr": "values"})
                cols = {"p_vals": val.astype("<i8", copy=False)}
            else:
                reply["value"] = val.tolist()
        elif (op == "batch" and isinstance(val, list)
                and state["wire_v"] >= WIRE_V2):
            bo = BatchOutcomes.from_items(val)
            del reply["value"]
            extra, cols = bo.wire()
            reply.update(extra)
        self._reply(conn, send_lock, reply, cols=cols)
        # tail-sampled exemplar, AFTER the reply: a kept
        # route pulls the touched shards' exemplars for this trace
        # context (the ``exemplars`` wire op), so the downstream pull's
        # RPC cost never rides on the client's latency
        if self.exemplar is not None:
            self._bump("exemplars_seen")
            reason = self.exemplar.decide(outcome, reply["elapsed_ms"])
            if reason is not None:
                self._bump("exemplars_kept")
                downstream: list[dict] = []
                for si in sorted(rctx.shards):
                    if 0 <= si < len(self.sets):
                        self._bump("exemplar_pulls")
                        for rec in self.sets[si].exemplars(ctx=rctx.ctx):
                            rec["shard"] = si
                            downstream.append(rec)
                self.exemplar.keep({
                    "ctx": rctx.ctx,
                    "op": op,
                    "outcome": outcome,
                    "ms": reply["elapsed_ms"],
                    "shards": sorted(rctx.shards),
                    "reason": reason,
                    "spans": trace.exemplar_collect(rctx.ctx),
                    "downstream": downstream,
                })


def _req_int(msg: dict, field: str) -> int:
    v = msg.get(field)
    if not isinstance(v, int) or isinstance(v, bool):
        raise BadRequest(f"field {field!r} must be an integer, got {v!r}")
    return v
