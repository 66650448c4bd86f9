"""The canonical lock order: the port's copy of the reference's constant
(``sieve/analysis/model.py``), without the static analyzer's model.

``CANONICAL_LOCK_ORDER`` lists every lock of both packages, outermost
first: a thread may only acquire a lock whose index is greater than
that of every lock it already holds.
:func:`sieve_torch.analysis.lockdebug.check_static_consistency` reads
it. A lock the port names must appear here, under the reference's name.
"""

from __future__ import annotations

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
    # lockdebug's own pair-set mutex: the sanitizer records while the
    # recorded lock is already held, so it is innermost by construction
    "_Recorder._mu",
)
