"""The port's concurrency model: thread roles, the canonical lock order
and the blocking-call list of the event-loop rule. The port's copy of the
reference's ``sieve/analysis/model.py``, under ``sieve_torch.`` names.

This module is *data*, not machinery: :mod:`sieve_torch.analysis.checks`
consumes a :class:`Model`, and the default instance below describes the
port's service plane. Fixture tests build their own small Models.

``CANONICAL_LOCK_ORDER`` lists every lock of both packages, outermost
first: a thread may only acquire a lock whose index is greater than
that of every lock it already holds. The order is derived from the
acquisition edges the analyzer observes (``python -m
sieve_torch.tools.check_concurrency --dump`` prints them) and is
cross-checked at runtime by :mod:`sieve_torch.analysis.lockdebug` under
``SIEVE_LOCK_DEBUG=1``. A lock the port names must appear here, under
the reference's name where the reference has one; an acquisition edge
touching an unlisted lock is a finding.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Model:
    # allowed acquisition order, outermost first
    canonical_lock_order: tuple[str, ...] = ()
    # roles that run an event loop and must never block
    loop_roles: frozenset[str] = frozenset()
    # dotted external calls that block
    blocking_calls: frozenset[str] = frozenset()
    # resolved-target prefixes that block (module or Class. prefixes)
    blocking_prefixes: tuple[str, ...] = ()
    # bare attribute-call names that block regardless of receiver type
    blocking_attrs: frozenset[str] = frozenset({"wait"})
    # class names whose public methods seed the synthetic "app" role
    # (the application thread calling the public API)
    app_role_classes: frozenset[str] = frozenset()
    # extra (qualname, role) seeds
    extra_seeds: tuple[tuple[str, str], ...] = ()


CANONICAL_LOCK_ORDER: tuple[str, ...] = (
    # -- cluster / client coordination (outermost: these call into
    #    everything below while held only in stop/teardown paths)
    "_Cluster.lock",
    "_Cluster.tele_lock",
    # -- fleet observer: guards trend/EWMA state only; never held across
    #    a pool RPC or ring I/O
    "FleetObserver._lock",
    "ClientPool._lock",
    "ReplicaSet._lock",
    "_Replica.lock",
    # -- service plane outer tier: queue admission, refresh, dispatch
    "LedgerFollower._poll_lock",
    "SieveService._lane_cond",
    "SieveService._cold_lock",
    "SieveService._slo_lock",
    "SieveService._seq_lock",
    "SieveService._inflight_lock",
    "SieveService._conns_lock",
    "SieveService._stats_lock",
    # -- router tier
    "SieveRouter._totals_lock",
    "SieveRouter._down_lock",
    "SieveRouter._tele_lock",
    "SieveRouter._seq_lock",
    "SieveRouter._inflight_lock",
    "SieveRouter._conns_lock",
    "SieveRouter._stats_lock",
    # -- per-connection write path: tx (the wire) strictly outside
    #    lock (the queue)
    "_Conn.tx",
    "_Conn.lock",
    # -- cold backend: dispatch serialization, then breaker state
    "ColdBackend._lock",
    "ColdBackend._state_lock",
    # -- index tier
    "SieveIndex._stat_lock",
    "BitsetLRU._lock",
    # -- tiered segment store: entered from index demotion callbacks
    #    (fired after BitsetLRU._lock is released) and from the store's
    #    own compactor thread
    "TieredSegmentStore._lock",
    # -- exemplar sampler and snapshot ring: never nested with each other
    "ExemplarSampler._lock",
    "ExemplarSampler._io_cond",
    "SnapshotRing._lock",
    # -- client wire-event logger init
    "client._wire_logger_lock",
    # -- leaf infrastructure (innermost: never call out while held)
    "ChaosSchedule._lock",
    "StackProfiler._lock",
    "FlightRecorder._lock",
    "MetricsHistory._lock",
    "MetricsRegistry._lock",
    "Counter._lock",
    "Gauge._lock",
    "Histogram._lock",
    "metrics._SINKS_LOCK",
    "MemorySink._lock",
    "StreamSink._lock",
    "PrepPipeline._cond",
    "Tracer._lock",
    "seed._cache_lock",
    # -- the port's kernel libraries: each load() takes its lock on every
    #    launch, under whatever the launching thread holds (on the cold
    #    plane ColdBackend._lock), and holds nothing while it builds
    "build._lock",
    "cpu_native._lock",
    # lockdebug's own pair-set mutex: the sanitizer records while the
    # recorded lock is already held, so it is innermost by construction
    "_Recorder._mu",
)


#: Thread roles that run a selectors-based event loop: nothing
#: reachable from these may block (no waits, sleeps, ledger I/O, rpc
#: sends, backend dispatch, or a launch on the card).
LOOP_ROLES = frozenset({"svc-wire", "router-accept"})

BLOCKING_CALLS = frozenset({
    "time.sleep",
    "socket.create_connection",
    "subprocess.run",
    "subprocess.check_call",
    "subprocess.check_output",
    # waits for every queued launch on the card
    "torch.cuda.synchronize",
})

BLOCKING_PREFIXES = (
    # framed send/recv block on the socket (FrameDecoder/encode_msg are
    # pure CPU and deliberately not listed)
    "sieve_torch.rpc:send_msg",
    "sieve_torch.rpc:recv_msg",
    "sieve_torch.rpc:_recv_exact",
    "sieve_torch.checkpoint:",   # ledger I/O (fsync)
    # cold backend dispatch: listed per-method — describe() and the
    # _state_lock health probes are in-memory snapshots the wire loop
    # answers inline, so the class must NOT be blanket-blocking
    "sieve_torch.service.server:ColdBackend.count_range",
    "sieve_torch.service.server:ColdBackend.count_ranges",
    "sieve_torch.service.server:ColdBackend._mesh_locked",  # device probe
    "sieve_torch.service.server:ColdBackend._mesh_dispatch",  # batched launch
    "sieve_torch.service.server:ColdBackend.close",
    "sieve_torch.service.server:ColdBatcher.submit",  # waits on a flight
    # the device dispatch itself: the kernel library's build and load
    # (nvcc on a first use) and every launch, which copies tables to the
    # card and reads its result back
    "sieve_torch.kernels.build:",
    "sieve_torch.kernels.cuda_mark:",
    # tiered segment store: appends/loads/compaction do file I/O under a
    # cross-process flock. Listed per-method on purpose — stats()/health()
    # are in-memory snapshots the wire loop answers inline, so the whole
    # module must NOT be blanket-blocking.
    "sieve_torch.service.store:TieredSegmentStore.put_",
    "sieve_torch.service.store:TieredSegmentStore.load_",
    "sieve_torch.service.store:TieredSegmentStore.compact",
    "sieve_torch.service.store:TieredSegmentStore.maybe_refresh",
    "sieve_torch.service.store:TieredSegmentStore.import_ledger",
    "sieve_torch.service.store:TieredSegmentStore.close",
)

APP_ROLE_CLASSES = frozenset({
    "SieveService",
    "SieveRouter",
    "ServiceClient",
    "ClientPool",
    "ReplicaSet",
    "ColdBackend",
    "TieredSegmentStore",
})


def default_model() -> Model:
    return Model(
        canonical_lock_order=CANONICAL_LOCK_ORDER,
        loop_roles=LOOP_ROLES,
        blocking_calls=BLOCKING_CALLS,
        blocking_prefixes=BLOCKING_PREFIXES,
        app_role_classes=APP_ROLE_CLASSES,
    )


#: Known constructor-like helpers: call target -> class fullid, so the
#: scanner can type ``tr = trace.get_tracer()`` receivers.
RETURN_TYPES = {
    "sieve_torch.trace:get_tracer": "sieve_torch.trace:Tracer",
    "sieve_torch.metrics:registry": "sieve_torch.metrics:MetricsRegistry",
}
