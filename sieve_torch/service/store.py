"""Tiered, mmap'd segment store: evictions become tiers, not garbage.

The reference's ``sieve/service/store.py``; the data files of the two
packages are byte-equal for the same sequence of puts.

The serving plane materializes chunk bitsets (and chunk prime-value
arrays) on demand and caches them in :class:`~sieve_torch.service.index.BitsetLRU`
— but before this module an eviction *discarded* the work and a restart
forgot everything. The store keeps every fact ever materialized in a
tiered, append-only, per-entry-checksummed file that N serving
processes on one host share read-only through the page cache:

  - **tier 0** — counts only (seeded from the checkpoint ledger):
    24 bytes of key + an 8-byte count, no payload
  - **tier 1** — tier 0 plus the 32-bit boundary words of the chunk's
    flag array (the cross-segment twin-splice currency)
  - **tier 2** — tier 1 plus the full prime set, wheel-compressed in
    value space at 48/210 residues (6 bytes per 210 integers — see
    :func:`sieve_torch.bitset.pack_wheel210`); enough to rebuild the exact
    flag array for any layout without sieving

On-disk layout under ``<root>/``:

  - ``segstore.json`` — the generation pointer ``{gen, data}``, swapped
    atomically (tempfile + ``os.replace`` + dir fsync, the
    :mod:`sieve_torch.checkpoint` durability idiom)
  - ``segstore_<gen>.dat`` — the append-only data file the pointer
    names: 48-byte record headers (magic, tier, key, count, boundary
    words, payload length, CRC32 over header+payload) + payload,
    8-byte aligned. Readers mmap it; a record is *immutable once
    appended*, so an entry survives any concurrent reader.
  - ``store.lock`` — ``flock`` serializing appends and the compaction
    swap across processes (every serving process may append demotions;
    only the elected writer compacts)

Crash/chaos honesty: a torn or garbled record fails its CRC and is
*skipped* — readers emit a counted ``store_torn_entry`` event, resync
on the record magic, and the chunk simply re-materializes later (the
``store_torn_write`` chaos kind injects exactly this). A truncated tail
(crash mid-append) reads as end-of-log; the writer trims it at open.

Generation follow: the background compactor rewrites live entries into
``segstore_<gen+1>.dat`` and atomically swaps the pointer; other
processes notice via the same ``(mtime_ns, size)`` fingerprint poll the
ledger live-follow uses and rescan. Appends from any process are
picked up by size growth within a generation.

Everything here may block on file I/O **except** :meth:`stats` /
:meth:`health`, which read in-memory counters only so the event loop
can answer ``stats``/``health`` inline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import mmap
import os
import struct
import tempfile
import threading
import time
import zlib

import numpy as np

from sieve_torch import env
from sieve_torch.analysis.lockdebug import named_lock
from sieve_torch.bitset import (
    Layout,
    boundary_words,
    pack_wheel210,
    unpack_wheel210,
)
from sieve_torch.checkpoint import ledger_fingerprint

try:
    import fcntl
except ImportError:  # non-posix: single-process best effort
    fcntl = None

# record header: magic u32 | tier u8 | small_mask u8 | pad u16 |
# lo u64 | hi u64 | count u64 | first_word u32 | last_word u32 |
# payload_len u32 | crc32 u32  == 48 bytes, followed by payload,
# zero-padded to 8-byte alignment. crc covers bytes [4:44) + payload.
_HEADER = struct.Struct("<IBB2xQQQIIII")
_HEADER_LEN = _HEADER.size
assert _HEADER_LEN == 48
_MAGIC = 0x53475631  # "SGV1" little-endian-ish tag
_ALIGN = 8

POINTER_NAME = "segstore.json"
LOCK_NAME = "store.lock"
_DATA_FMT = "segstore_%06d.dat"

TIER_COUNT = 0
TIER_BOUNDARY = 1
TIER_BITSET = 2


def _pad(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


@dataclasses.dataclass(frozen=True)
class StoreSettings:
    """Knobs for the tiered store, one env var each (all documented in
    the reference's README, "Tiered segment store")."""

    fsync: bool = False          # fsync every append (pointer swaps always)
    compact_s: float = 2.0       # compactor poll period; <= 0 disables
    compact_ratio: float = 0.5   # compact when dead/total exceeds this
    min_compact_bytes: int = 1 << 16  # ... and dead bytes exceed this
    t2_bytes: int = 0            # tier-2 payload cap; 0 = uncapped
    refresh_s: float = 0.25      # reader min interval between stat polls

    @classmethod
    def from_env(cls) -> "StoreSettings":
        return cls(
            fsync=env.env_flag("SIEVE_STORE_FSYNC", False),
            compact_s=env.env_float("SIEVE_STORE_COMPACT_S", 2.0),
            compact_ratio=env.env_float("SIEVE_STORE_COMPACT_RATIO", 0.5),
            min_compact_bytes=env.env_int(
                "SIEVE_STORE_MIN_COMPACT_BYTES", 1 << 16),
            t2_bytes=env.env_int("SIEVE_STORE_T2_BYTES", 0),
            refresh_s=env.env_float("SIEVE_STORE_REFRESH_S", 0.25),
        )


@dataclasses.dataclass
class _Entry:
    tier: int
    count: int
    first_word: int
    last_word: int
    small_mask: int
    rec_off: int       # offset of the record header in the data file
    rec_len: int       # padded record length
    payload_len: int


class TieredSegmentStore:
    """One directory of tiered segment facts, shared by N processes.

    ``writer=True`` marks the elected writer (proc 0 of a ``--procs``
    fleet, or the only process): it trims torn tails at open, imports
    ledger counts, and owns the background compactor. *Every* process —
    writer or reader — may append demotions; appends are serialized by
    the cross-process ``flock``.
    """

    def __init__(
        self,
        root: str | os.PathLike,
        *,
        writer: bool = False,
        settings: StoreSettings | None = None,
        chaos=None,
        events=None,
    ) -> None:
        self.root = os.fspath(root)
        self.writer = writer
        self.settings = settings or StoreSettings()
        self._chaos = chaos  # guard: none(ChaosSchedule is internally locked)
        self._events = events  # guard: none(set once at construction)
        os.makedirs(self.root, exist_ok=True)

        # one lock for all mutable store state; never held across the
        # events callback's metrics sinks is fine (leaf locks are
        # inside it in the canonical order), but never nests under
        # BitsetLRU._lock — demotion callbacks fire outside the LRU lock
        self._lock = named_lock("TieredSegmentStore._lock")
        self._entries: dict[tuple[int, int], _Entry] = {}  # guard: _lock
        self._gen = 0              # guard: _lock — generation pointer
        self._pointer_fp = None    # guard: _lock — pointer fingerprint
        self._data_path = ""       # guard: _lock
        self._data_fd = -1         # guard: _lock
        self._append_fd = -1       # guard: _lock
        self._mmap: mmap.mmap | None = None  # guard: _lock
        self._scan_off = 0         # guard: _lock — bytes parsed so far
        self._data_size = 0        # guard: _lock — bytes known on disk
        self._dead_bytes = 0       # guard: _lock — superseded/torn bytes
        self._t2_payload = 0       # guard: _lock — live tier-2 payload bytes
        self._last_refresh = 0.0   # guard: _lock
        self._writes = 0           # guard: _lock — chaos draw counter
        # counters surfaced by stats()/health() (in-memory only)
        self._hits = 0             # guard: _lock
        self._misses = 0           # guard: _lock
        self._demotions = 0        # guard: _lock
        self._demoted_bytes = 0    # guard: _lock
        self._torn = 0             # guard: _lock
        self._torn_writes = 0      # guard: _lock
        self._compactions = 0      # guard: _lock
        self._compact_errors = 0   # guard: _lock
        self._downgraded = 0       # guard: _lock

        lock_path = os.path.join(self.root, LOCK_NAME)
        self._lock_fd = os.open(lock_path, os.O_RDWR | os.O_CREAT, 0o644)  # guard: none(set in __init__, cleared once in close() after the compactor is joined)
        self._stop = threading.Event()
        self._compactor: threading.Thread | None = None  # guard: none(set
        # once in start() before the thread exists, joined in close())

        with self._lock:
            with self._flock():
                self._open_gen_locked(create=True)
                if self.writer:
                    self._trim_torn_tail_locked()
            self._scan_locked()

    # --- cross-process serialization ------------------------------------------

    @contextlib.contextmanager
    def _flock(self):
        if fcntl is None:
            yield
            return
        fcntl.flock(self._lock_fd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(self._lock_fd, fcntl.LOCK_UN)

    # --- generation pointer ----------------------------------------------------

    @property
    def _pointer_path(self) -> str:
        return os.path.join(self.root, POINTER_NAME)

    def _write_pointer_locked(self, gen: int, data_name: str) -> None:  # holds: _lock
        """Atomic pointer swap, the ledger's durability idiom."""
        doc = {"version": 1, "gen": gen, "data": data_name}
        fd, tmp = tempfile.mkstemp(
            prefix=".segstore.", suffix=".tmp", dir=self.root)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._pointer_path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        dfd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _open_gen_locked(self, create: bool = False) -> None:  # holds: _lock
        """(Re)open the data file the pointer names; resets the parse
        state — callers rescan."""
        ptr = self._pointer_path
        if not os.path.exists(ptr):
            if not create:
                raise FileNotFoundError(ptr)
            data_name = _DATA_FMT % 1
            with open(os.path.join(self.root, data_name), "ab"):
                pass
            self._write_pointer_locked(1, data_name)
        with open(ptr, encoding="utf-8") as f:
            doc = json.load(f)
        self._close_files_locked()
        self._gen = int(doc["gen"])
        self._data_path = os.path.join(self.root, str(doc["data"]))
        self._pointer_fp = ledger_fingerprint(ptr)
        self._data_fd = os.open(self._data_path, os.O_RDONLY)
        self._append_fd = os.open(
            self._data_path, os.O_WRONLY | os.O_APPEND)
        self._entries.clear()
        self._scan_off = 0
        self._data_size = 0
        self._dead_bytes = 0
        self._t2_payload = 0
        self._remap_locked()

    def _close_files_locked(self) -> None:  # holds: _lock
        if self._mmap is not None:
            with contextlib.suppress(BufferError):
                self._mmap.close()
            self._mmap = None
        for fd in (self._data_fd, self._append_fd):
            if fd >= 0:
                with contextlib.suppress(OSError):
                    os.close(fd)
        self._data_fd = self._append_fd = -1

    def _remap_locked(self) -> None:  # holds: _lock
        size = os.fstat(self._data_fd).st_size
        self._data_size = size
        if self._mmap is not None:
            with contextlib.suppress(BufferError):
                self._mmap.close()
            self._mmap = None
        if size:
            self._mmap = mmap.mmap(
                self._data_fd, size, access=mmap.ACCESS_READ)

    def _check_gen_locked(self) -> bool:  # holds: _lock
        """Follow a pointer swap (compaction in another process).
        Returns True when the generation changed (state was reset)."""
        fp = ledger_fingerprint(self._pointer_path)
        if fp == self._pointer_fp:
            return False
        self._open_gen_locked()
        return True

    # --- record scan -----------------------------------------------------------

    def _trim_torn_tail_locked(self) -> None:  # holds: _lock
        """Writer, at open, under flock: drop a crash-truncated tail so
        later appends start on a record boundary."""
        size = os.fstat(self._data_fd).st_size
        end = self._scan_extent_locked(size)
        if end < size:
            os.ftruncate(self._append_fd, end)

    def _scan_extent_locked(self, size: int) -> int:  # holds: _lock
        """Last byte offset that ends a structurally complete record."""
        self._remap_locked()
        off = 0
        mm = self._mmap
        while mm is not None and off + _HEADER_LEN <= size:
            magic, _t, _m, _lo, _hi, _c, _fw, _lw, plen, _crc = \
                _HEADER.unpack_from(mm, off)
            total = _pad(_HEADER_LEN + plen)
            if magic != _MAGIC or off + total > size:
                break
            off += total
        return off

    def _scan_locked(self) -> None:  # holds: _lock
        """Parse records from ``_scan_off`` to EOF, indexing entries and
        skipping torn ones (CRC failure -> ``store_torn_entry``)."""
        size = os.fstat(self._data_fd).st_size
        if size <= self._scan_off:
            return
        self._remap_locked()
        mm = self._mmap
        off = self._scan_off
        torn_events = []
        while mm is not None and off + _HEADER_LEN <= size:
            (magic, tier, small_mask, lo, hi, count, fw, lw, plen,
             crc) = _HEADER.unpack_from(mm, off)
            total = _pad(_HEADER_LEN + plen)
            if magic != _MAGIC or hi <= lo or off + total > size:
                if magic == _MAGIC and off + total > size:
                    break  # partial tail: wait for the rest
                # garbage header: resync on the next aligned magic
                torn_events.append(off)
                self._torn += 1
                nxt = off + _ALIGN
                while nxt + _HEADER_LEN <= size:
                    if _HEADER.unpack_from(mm, nxt)[0] == _MAGIC:
                        break
                    nxt += _ALIGN
                self._dead_bytes += nxt - off
                off = nxt
                continue
            payload = mm[off + _HEADER_LEN:off + _HEADER_LEN + plen]
            if zlib.crc32(mm[off + 4:off + 44] + payload) != crc:
                torn_events.append(off)
                self._torn += 1
                self._dead_bytes += total
                off += total
                continue
            self._index_locked(
                (lo, hi),
                _Entry(tier, count, fw, lw, small_mask, off, total, plen),
            )
            off += total
        self._scan_off = off
        for toff in torn_events:
            self._emit("store_torn_entry", quietable=True,
                       offset=toff, gen=self._gen)

    def _index_locked(self, key: tuple[int, int], entry: _Entry) -> None:  # holds: _lock
        old = self._entries.get(key)
        if old is not None:
            if old.tier > entry.tier:
                # never let a late low-tier append shadow richer data
                self._dead_bytes += entry.rec_len
                return
            self._dead_bytes += old.rec_len
            if old.tier == TIER_BITSET:
                self._t2_payload -= old.payload_len
        self._entries[key] = entry
        if entry.tier == TIER_BITSET:
            self._t2_payload += entry.payload_len

    # --- appends ---------------------------------------------------------------

    def _build_record(self, tier: int, lo: int, hi: int, count: int,
                      fw: int, lw: int, small_mask: int,
                      payload: bytes) -> bytes:
        hdr = _HEADER.pack(_MAGIC, tier, small_mask, lo, hi, count,
                           fw, lw, len(payload), 0)
        crc = zlib.crc32(hdr[4:44] + payload)
        hdr = _HEADER.pack(_MAGIC, tier, small_mask, lo, hi, count,
                           fw, lw, len(payload), crc)
        rec = hdr + payload
        return rec + b"\0" * (_pad(len(rec)) - len(rec))

    def _append_locked(self, key, tier, count,  # holds: _lock
                       fw: int, lw: int, small_mask: int,
                       payload: bytes) -> bool:
        """Append one record under the cross-process flock. Returns
        False when the record was deliberately torn by chaos."""
        rec = self._build_record(
            tier, key[0], key[1], count, fw, lw, small_mask, payload)
        self._writes += 1
        torn = bool(self._chaos is not None and self._chaos.take_kinds(
            0, self._writes, ("store_torn_write",)))
        if torn:
            # same length, garbled interior: the CRC fails but the
            # framing survives, so readers skip exactly this record.
            # [8:40) garbles lo/hi/count/first/last but leaves magic
            # and payload_len intact — torn records must never confuse
            # the scanner about where the NEXT record starts.
            body = bytearray(rec)
            for i in range(8, 40):
                body[i] ^= 0xA5
            rec = bytes(body)
        with self._flock():
            # a compaction may have swapped generations since our last
            # look — re-anchor before appending so nothing lands in a
            # dead file
            self._check_gen_locked()
            off = os.lseek(self._append_fd, 0, os.SEEK_END)
            os.write(self._append_fd, rec)
            if self.settings.fsync:
                os.fsync(self._append_fd)
        self._data_size = off + len(rec)
        if torn:
            self._torn_writes += 1
            self._torn += 1
            self._dead_bytes += len(rec)
            self._scan_off = max(self._scan_off, off + len(rec))
            self._emit("store_torn_entry", quietable=True,
                       offset=off, gen=self._gen)
            return False
        if self._scan_off == off:
            self._scan_off = off + len(rec)
            self._index_locked(key, _Entry(
                tier, count, fw, lw, small_mask, off, len(rec),
                len(payload)))
        # else: another process appended in between; the next scan
        # picks both records up in order
        return True

    # --- public write API ------------------------------------------------------

    def put_count(self, lo: int, hi: int, count: int) -> None:
        """Tier-0 fact (ledger import / count-only demotion)."""
        with self._lock:
            if (lo, hi) in self._entries:
                return
            self._append_locked((lo, hi), TIER_COUNT, count, 0, 0, 0, b"")

    def put_boundary(self, lo: int, hi: int, count: int,
                     first_word: int, last_word: int) -> bool:
        """Tier-1 fact: count plus the exact boundary flag
        words — what ``--persist-cold`` records per cold chunk so a
        restarted server can rebuild the chunk's full SegmentResult
        without re-marking it. Skipped when a boundary-or-richer entry
        already exists (never shadow richer data with a re-persist);
        returns False on a duplicate or a chaos-torn write."""
        with self._lock:
            cur = self._entries.get((lo, hi))
            if cur is not None and cur.tier >= TIER_BOUNDARY:
                return False
            return self._append_locked(
                (lo, hi), TIER_BOUNDARY, int(count),
                int(first_word), int(last_word), 0, b"")

    def put_flags(self, lo: int, hi: int, flags: np.ndarray,
                  layout: Layout) -> bool:
        """Demote a fully-sieved flag array into tier 2. The flag bits
        must be exact primality (post-sieve), not mid-sieve candidates —
        composite survivors off the 210-wheel cannot be encoded and
        raise in pack_wheel210. Returns False on a duplicate or a
        chaos-torn write."""
        values = layout.values_np(lo, np.flatnonzero(flags))
        fw, lw = boundary_words(flags)
        payload, small_mask = pack_wheel210(lo, hi, values)
        with self._lock:
            cur = self._entries.get((lo, hi))
            if cur is not None and cur.tier >= TIER_BITSET:
                return False  # already demoted (possibly by a peer)
            ok = self._append_locked(
                (lo, hi), TIER_BITSET, int(values.size), fw, lw,
                small_mask, payload)
            if ok:
                self._demotions += 1
                self._demoted_bytes += len(payload)
        if ok:
            self._emit("store_demoted", quietable=True, lo=lo, hi=hi,
                       bytes=len(payload), tier=TIER_BITSET)
        return ok

    def put_values(self, lo: int, hi: int, values: np.ndarray,
                   layout: Layout) -> bool:
        """Demote a prime-value array (the ``_pv`` cache) by rebuilding
        the layout flags so tier 1 boundary words stay truthful."""
        values = np.asarray(values, dtype=np.int64)
        nb = layout.nbits(lo, hi)
        flags = np.zeros(nb, dtype=bool)
        if nb and values.size:
            g0 = layout.gidx(layout.first_candidate(lo))
            flags[layout.gidx_np(values) - g0] = True
        return self.put_flags(lo, hi, flags, layout)

    def import_ledger(self, entries) -> int:
        """Seed tier 0 from ``(lo, hi, count)`` tuples (the checkpoint
        ledger's completed segments). Writer-only; idempotent."""
        added = 0
        with self._lock:
            for lo, hi, count in entries:
                if (lo, hi) in self._entries:
                    continue
                self._append_locked(
                    (int(lo), int(hi)), TIER_COUNT, int(count), 0, 0, 0, b"")
                added += 1
        return added

    # --- reads -----------------------------------------------------------------

    def _payload_locked(self, key, e) -> bytes | None:  # holds: _lock
        """Re-checksummed payload bytes for an indexed entry."""
        if self._mmap is None or e.rec_off + e.rec_len > len(self._mmap):
            self._remap_locked()
        mm = self._mmap
        if mm is None or e.rec_off + e.rec_len > len(mm):
            return None
        start = e.rec_off + _HEADER_LEN
        payload = mm[start:start + e.payload_len]
        crc = _HEADER.unpack_from(mm, e.rec_off)[9]
        if zlib.crc32(mm[e.rec_off + 4:e.rec_off + 44] + payload) != crc:
            # torn under us (disk corruption): behave like the scan —
            # skip, count, re-materialize upstream
            self._entries.pop(key, None)
            self._torn += 1
            self._dead_bytes += e.rec_len
            if e.tier == TIER_BITSET:
                self._t2_payload -= e.payload_len
            self._emit("store_torn_entry", quietable=True,
                       offset=e.rec_off, gen=self._gen)
            return None
        return payload

    def _maybe_refresh_locked(self, force: bool = False) -> bool:  # holds: _lock
        now = time.monotonic()
        if not force and now - self._last_refresh < self.settings.refresh_s:
            return False
        self._last_refresh = now
        changed = self._check_gen_locked()
        before = self._scan_off
        self._scan_locked()
        return changed or self._scan_off != before

    def maybe_refresh(self, force: bool = False) -> bool:
        """Follow peers: pointer swap (new generation) or same-gen
        append growth. Throttled by ``refresh_s`` unless forced."""
        with self._lock:
            return self._maybe_refresh_locked(force)

    def get_entry(self, lo: int, hi: int):
        """(tier, count, first_word, last_word) or None — no payload I/O."""
        with self._lock:
            e = self._entries.get((lo, hi))
            if e is None:
                return None
            return (e.tier, e.count, e.first_word, e.last_word)

    def load_values(self, lo: int, hi: int) -> np.ndarray | None:
        """Sorted prime values for a tier-2 entry, or None."""
        with self._lock:
            e = self._entries.get((lo, hi))
            if e is None or e.tier < TIER_BITSET:
                if self._maybe_refresh_locked():
                    e = self._entries.get((lo, hi))
            if e is None or e.tier < TIER_BITSET:
                self._misses += 1
                return None
            payload = self._payload_locked((lo, hi), e)
            if payload is None:
                self._misses += 1
                return None
            small_mask = e.small_mask
            self._hits += 1
        return unpack_wheel210(lo, hi, payload, small_mask)

    def load_flags(self, lo: int, hi: int,
                   layout: Layout) -> np.ndarray | None:
        """Rebuild the exact layout flag array for a tier-2 entry, or
        None (not stored / torn). The inverse of :meth:`put_flags`."""
        values = self.load_values(lo, hi)
        if values is None:
            return None
        nb = layout.nbits(lo, hi)
        flags = np.zeros(nb, dtype=bool)
        if nb and values.size:
            g0 = layout.gidx(layout.first_candidate(lo))
            pos = layout.gidx_np(values) - g0
            ok = (pos >= 0) & (pos < nb)
            # layout extras (2 for odds; 2,3,5 for wheel30) are not
            # candidates and were never stored from this layout, but a
            # foreign-packing value would alias a wrong bit — verify
            # the inverse map instead of trusting it
            ok &= layout.values_np(lo, np.clip(pos, 0, max(nb - 1, 0))) \
                == values
            flags[pos[ok]] = True
        return flags

    # --- compaction ------------------------------------------------------------

    def _needs_compact_locked(self) -> bool:  # holds: _lock
        s = self.settings
        if self._dead_bytes >= max(1, s.min_compact_bytes) and \
                self._dead_bytes > s.compact_ratio * max(1, self._data_size):
            return True
        return bool(s.t2_bytes and self._t2_payload > s.t2_bytes)

    def compact_once(self, force: bool = False) -> bool:
        """Rewrite live entries into ``segstore_<gen+1>.dat`` and swap
        the pointer atomically; under a tier-2 byte cap, the oldest
        tier-2 entries are downgraded to tier 1. Writer-only."""
        if not self.writer:
            return False
        with self._lock:
            with self._flock():
                self._check_gen_locked()
                self._scan_locked()
                if not force and not self._needs_compact_locked():
                    return False
                old_size, old_path = self._data_size, self._data_path
                gen = self._gen + 1
                data_name = _DATA_FMT % gen
                new_path = os.path.join(self.root, data_name)
                cap = self.settings.t2_bytes
                # oldest-first by record offset: append order is age
                items = sorted(
                    self._entries.items(), key=lambda kv: kv[1].rec_off)
                t2 = sum(e.payload_len for _, e in items
                         if e.tier == TIER_BITSET)
                downgraded = 0
                out: list[tuple[tuple[int, int], int, _Entry, bytes]] = []
                for key, e in items:
                    payload = b""
                    tier = e.tier
                    if e.tier == TIER_BITSET:
                        if cap and t2 > cap:
                            t2 -= e.payload_len
                            tier = TIER_BOUNDARY
                            downgraded += 1
                        else:
                            p = self._payload_locked(key, e)
                            if p is None:
                                continue  # torn: drop it entirely
                            payload = p
                    out.append((key, tier, e, payload))
                with open(new_path, "wb") as f:
                    off = 0
                    new_entries: dict[tuple[int, int], _Entry] = {}
                    for key, tier, e, payload in out:
                        rec = self._build_record(
                            tier, key[0], key[1], e.count, e.first_word,
                            e.last_word,
                            e.small_mask if tier == TIER_BITSET else 0,
                            payload)
                        f.write(rec)
                        new_entries[key] = _Entry(
                            tier, e.count, e.first_word, e.last_word,
                            e.small_mask if tier == TIER_BITSET else 0,
                            off, len(rec), len(payload))
                        off += len(rec)
                    f.flush()
                    os.fsync(f.fileno())
                self._write_pointer_locked(gen, data_name)
                self._close_files_locked()
                self._gen = gen
                self._data_path = new_path
                self._pointer_fp = ledger_fingerprint(self._pointer_path)
                self._data_fd = os.open(new_path, os.O_RDONLY)
                self._append_fd = os.open(
                    new_path, os.O_WRONLY | os.O_APPEND)
                self._entries = new_entries
                self._scan_off = off
                self._dead_bytes = 0
                self._t2_payload = sum(
                    e.payload_len for e in new_entries.values()
                    if e.tier == TIER_BITSET)
                self._remap_locked()
                with contextlib.suppress(OSError):
                    os.unlink(old_path)
                self._compactions += 1
                self._downgraded += downgraded
                live = len(new_entries)
                reclaimed = old_size - off
        self._emit("store_compacted", gen=gen, live=live,
                   reclaimed_bytes=reclaimed, downgraded=downgraded)
        return True

    def _compact_loop(self) -> None:
        while not self._stop.wait(self.settings.compact_s):
            try:
                self.compact_once()
            except Exception:
                with self._lock:
                    self._compact_errors += 1

    def start(self) -> None:
        """Spawn the background compactor (writer only; idempotent)."""
        if not self.writer or self.settings.compact_s <= 0:
            return
        if self._compactor is not None:
            return
        self._compactor = threading.Thread(
            target=self._compact_loop, name="store-compact", daemon=True)
        self._compactor.start()

    def close(self) -> None:
        self._stop.set()
        if self._compactor is not None:
            self._compactor.join(timeout=10.0)
            self._compactor = None
        with self._lock:
            self._close_files_locked()
        if self._lock_fd >= 0:
            with contextlib.suppress(OSError):
                os.close(self._lock_fd)
            self._lock_fd = -1

    def __enter__(self) -> "TieredSegmentStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # --- observability (in-memory only: safe from the event loop) -------------

    def stats(self) -> dict:
        with self._lock:
            tiers = {0: 0, 1: 0, 2: 0}
            for e in self._entries.values():
                tiers[e.tier] += 1
            lookups = self._hits + self._misses
            return {
                "gen": self._gen,
                "writer": self.writer,
                "entries": dict(tiers),
                "data_bytes": self._data_size,
                "dead_bytes": self._dead_bytes,
                "tier2_payload_bytes": self._t2_payload,
                "hits": self._hits,
                "misses": self._misses,
                "hit_ratio": round(self._hits / lookups, 4) if lookups
                else None,
                "demotions": self._demotions,
                "demoted_bytes": self._demoted_bytes,
                "torn": self._torn,
                "torn_writes": self._torn_writes,
                "compactions": self._compactions,
                "compact_errors": self._compact_errors,
                "downgraded": self._downgraded,
                "appends": self._writes,
            }

    def health(self) -> dict:
        with self._lock:
            return {
                "gen": self._gen,
                "writer": self.writer,
                "entries": len(self._entries),
                "hits": self._hits,
                "demotions": self._demotions,
                "torn": self._torn,
            }

    def export_counts(self) -> list[tuple[int, int, int, int]]:
        """Sorted ``(lo, hi, count, tier)`` for every live entry — the
        export half of the ledger import/export seam."""
        with self._lock:
            return sorted(
                (lo, hi, e.count, e.tier)
                for (lo, hi), e in self._entries.items()
            )

    def _emit(self, kind: str, quietable: bool = False, **fields) -> None:
        if self._events is None:
            return
        try:
            self._events(kind, quietable=quietable, **fields)
        except Exception:
            pass  # observability must never take the store down
