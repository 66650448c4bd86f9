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

The server, the client and the fabric come next and are not here yet.
"""

from sieve_torch.service.exemplar import ExemplarSampler, load_exemplars
from sieve_torch.service.index import BitsetLRU, QueryCtx, SieveIndex
from sieve_torch.service.store import StoreSettings, TieredSegmentStore

__all__ = [
    "BitsetLRU",
    "ExemplarSampler",
    "QueryCtx",
    "SieveIndex",
    "StoreSettings",
    "TieredSegmentStore",
    "load_exemplars",
]
