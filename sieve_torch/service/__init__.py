"""The query service's data plane, the reference's ``sieve/service/``.

A counting run fills a checkpoint ledger; these modules turn the ledger
into a queryable store, all of it host numpy as in the reference:

* :mod:`sieve_torch.service.index`: :class:`SieveIndex`, a read-only
  segment-boundary index with O(log segments) prefix counts, ``nth`` and
  a vectorized ``count_upto_batch``, and :class:`BitsetLRU` of
  materialized chunks;
* :mod:`sieve_torch.service.store`: :class:`TieredSegmentStore`, the
  mmap'd, append-only, per-record-CRC'd store that LRU evictions demote
  into (tier 0 counts, tier 1 boundary words, tier 2 wheel-210 bitsets),
  shared by every process on a host;
* :mod:`sieve_torch.service.exemplar`: :class:`ExemplarSampler`, the
  completion-time retention of request span trees, and
  :func:`load_exemplars`.

* :mod:`sieve_torch.service.server`: :class:`SieveService`, the query
  server (bounded hot and cold lanes, deadlines, single-flight cold
  chunks batched by :class:`ColdBatcher` into one backend dispatch, a
  circuit breaker, :class:`LedgerFollower`, drain), whose cold plane runs
  on the card: the configured backend's worker (``cuda``: one fused
  kernel launch per chunk) or, with ``cold_backend="mesh"``, the word
  kernel on every card;
* :mod:`sieve_torch.service.client`: :class:`ServiceClient` (pipelining,
  ``hello`` negotiation of the v2 columnar wire), :class:`ClientPool` and
  the failover client :class:`ReplicaSet`.

The range-sharded fabric, all host code as in the reference (it loads no
torch; its shard servers' cold chunks run on the card):

* :mod:`sieve_torch.service.shards`: :class:`ShardMap`, the validated
  contiguous partition of the keyspace into :class:`Shard` ranges (the
  last shard's cold tier extends past the map's ``hi``);
* :mod:`sieve_torch.service.router`: :class:`SieveRouter`, which fronts
  the shards' replica sets with the single server's wire protocol:
  scatter-gather counts over cached full-shard totals, pair counts
  spliced at each edge, ``nth_prime`` over cumulative totals, typed
  :class:`ShardUnavailable` naming the shard, and :class:`RouterSettings`;
* :mod:`sieve_torch.service.observe`: :class:`FleetObserver`, which
  scrapes the router and every replica into a CRC'd :class:`SnapshotRing`
  (:func:`read_ring` reads it) under an EWMA and robust-z anomaly engine,
  with :class:`ObserverSettings`.
"""

from sieve_torch.service.client import (
    CallTimeout,
    ClientPool,
    ReplicaSet,
    ServiceClient,
    ServiceError,
)
from sieve_torch.service.exemplar import ExemplarSampler, load_exemplars
from sieve_torch.service.index import BitsetLRU, QueryCtx, SieveIndex
from sieve_torch.service.observe import (
    FleetObserver,
    ObserverSettings,
    SnapshotRing,
    read_ring,
)
from sieve_torch.service.router import (
    RouterSettings,
    ShardUnavailable,
    SieveRouter,
)
from sieve_torch.service.server import (
    BadRequest,
    ColdBatcher,
    DeadlineExceeded,
    Degraded,
    Draining,
    LedgerFollower,
    Overloaded,
    ServiceSettings,
    SieveService,
)
from sieve_torch.service.shards import Shard, ShardMap
from sieve_torch.service.store import StoreSettings, TieredSegmentStore

__all__ = [
    "BadRequest",
    "BitsetLRU",
    "CallTimeout",
    "ClientPool",
    "ColdBatcher",
    "DeadlineExceeded",
    "Degraded",
    "Draining",
    "ExemplarSampler",
    "FleetObserver",
    "LedgerFollower",
    "ObserverSettings",
    "Overloaded",
    "QueryCtx",
    "ReplicaSet",
    "RouterSettings",
    "ServiceClient",
    "ServiceError",
    "ServiceSettings",
    "Shard",
    "ShardMap",
    "ShardUnavailable",
    "SieveIndex",
    "SieveRouter",
    "SieveService",
    "SnapshotRing",
    "StoreSettings",
    "TieredSegmentStore",
    "load_exemplars",
    "read_ring",
]
