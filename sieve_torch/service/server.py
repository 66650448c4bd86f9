"""The query server: bounded admission, deadlines, coalescing, degradation.

The reference's ``sieve/service/server.py``, with its cold plane on the
port's workers: the loop plane is the configured backend's worker
(``make_worker``; on ``cuda`` that is ``CudaWorker``, one fused-kernel
launch per cold chunk) and ``cold_backend="mesh"`` is
:class:`~sieve_torch.backends.mesh_backend.MeshWorker`, the word kernel
over every card. Settings, reply fields, error kinds, events, counters,
lock names and ``SIEVE_SVC_*`` variables are the reference's, so a
client of either package talks to a server of the other.

One :class:`SieveService` owns four tiers:

* **index** — :class:`~sieve_torch.service.index.SieveIndex` over a
  ``Ledger.open_readonly`` snapshot; O(log segments) prefix counts plus
  an LRU of materialized bitsets. Hot queries never touch a backend.
* **admission** — two bounded lanes (hot: answerable from the index and
  caches; cold: may need a backend dispatch) in front of a small worker
  pool. A full lane (or an injected ``svc_shed``/``svc_flood``) returns a
  typed ``overloaded`` reply at once; every admitted request carries a
  deadline, and blowing it returns a typed ``deadline_exceeded`` with
  the partial prefix answered so far.
* **cold** — ranges past the index are chunked on a fixed grid; a
  :class:`ColdBatcher` thread drains every distinct chunk that queued
  requests registered and issues ONE backend dispatch for the sorted
  list through ``SieveWorker.process_segments``. Concurrent overlapping
  queries coalesce on single-flight slots, and results are cached so a
  repeated cold query becomes hot. A chaos-failed chunk
  (``svc_batch_partial``) degrades only its own waiters.
* **degradation** — a circuit breaker around the backend: a failure
  streak (or an injected ``backend_down``) opens it for a cooldown,
  cold queries fail fast with a typed ``degraded`` reply, and hot-index
  queries keep answering. A reply is exact or it is a typed error.

Around them: a :class:`LedgerFollower` swaps in a fresh index when the
ledger grows (``covered_hi`` is monotonic per process); ``--persist-cold``
writes cold results back into the ledger (``COLD_SEG_BASE + lo``);
SIGTERM or a ``shutdown`` message drains — queued work is answered, new
queries are shed as typed ``draining``.

The listener is a single-threaded ``selectors`` event loop: reads stream
through :class:`~sieve_torch.rpc.FrameDecoder`, any number of requests
pipeline on one connection (replies come back in completion order, by
``id``), each connection has a bounded write queue, and inline ops
(``health``/``stats``/``metrics``/``debug``/...) are front-inserted ahead
of queued query replies. The ``batch`` op answers M members in one frame
(hot members through one vectorized searchsorted row); ``hello``
negotiates the v2 columnar wire.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
import queue
import selectors
import socket
import threading
import time
from typing import TYPE_CHECKING, Any

import numpy as np

from sieve_torch import env, trace
from sieve_torch.analysis.lockdebug import named_condition, named_lock
from sieve_torch.backends import make_worker
from sieve_torch.chaos import (
    PROFILE_KINDS,
    SERVICE_REQUEST_KINDS,
    ChaosCrash,
    ChaosSchedule,
    parse_chaos,
)
from sieve_torch.debug import FlightRecorder
from sieve_torch.profile import StackProfiler
from sieve_torch.checkpoint import (
    COLD_SEG_BASE,
    Ledger,
    LedgerMismatch,
    ledger_fingerprint,
)
from sieve_torch.bitset import get_layout
from sieve_torch.enumerate import MAX_HI, primes_in_range
from sieve_torch.metrics import MetricsHistory, MetricsLogger, registry, sample_interval_s
from sieve_torch.service.exemplar import EXEMPLAR_SPAN_RING, ExemplarSampler
from sieve_torch.service.store import TIER_BOUNDARY, StoreSettings, TieredSegmentStore
from sieve_torch.worker import SegmentResult
from sieve_torch.rpc import (
    SUPPORTED_WIRE,
    WIRE_V1,
    WIRE_V2,
    BatchOutcomes,
    FrameDecoder,
    batch_cols_to_items,
    encode_msg,
    encode_msg_v2,
    parse_addr,
    primes_to_cols,
)
from sieve_torch.seed import seed_primes
from sieve_torch.service.index import QueryCtx, SieveIndex

if TYPE_CHECKING:
    from sieve_torch.config import SieveConfig


# --- typed faults ------------------------------------------------------------
# Every non-exact outcome is one of these; the handler maps them 1:1 onto
# typed error replies. Anything else escaping a handler is "internal".


class Overloaded(Exception):
    """Admission refused: queue full or svc_shed injected."""


class DeadlineExceeded(Exception):
    def __init__(self, answered_hi: int, count_so_far: int):
        super().__init__(f"deadline exceeded at {answered_hi}")
        self.answered_hi = answered_hi
        self.count_so_far = count_so_far


class Degraded(Exception):
    """Cold tier unavailable (breaker open / backend_down injected)."""


class BadRequest(Exception):
    pass


class Draining(Exception):
    """Server is draining (SIGTERM / shutdown): new queries are shed."""


class _Demoted(Exception):
    """Internal lane signal, never wire-visible: a hot-lane
    request discovered chunks needing a backend dispatch mid-execution.
    The handler re-enqueues the whole request on the cold lane instead
    of holding a hot worker through the dispatch — the registered
    flights are already submitted to the batcher, so the cold re-run
    joins them as a follower (or finds the results cached)."""

    def __init__(self, chunks: int):
        super().__init__(f"demoted to cold lane ({chunks} cold chunk(s))")
        self.chunks = chunks


_ERROR_KIND = {
    Overloaded: "overloaded",
    DeadlineExceeded: "deadline_exceeded",
    Degraded: "degraded",
    BadRequest: "bad_request",
    Draining: "draining",
}


# validated knob readers live in sieve_torch/env.py so every
# plane shares one parse-failure contract; the local names survive
# because the service plane reads them pervasively
_env_int = env.env_int
_env_float = env.env_float


def _env_bool(name: str, default: str) -> bool:
    return env.env_str(name, default) not in ("0", "", "false")


# per-op latency SLOs: SIEVE_SVC_SLO_MS_PI=5 reads as
# {"pi": 5.0}; the op name is the env suffix, lowercased
_SLO_ENV_PREFIX = "SIEVE_SVC_SLO_MS_"


def _slo_from_env() -> dict[str, float] | None:
    out: dict[str, float] = {}
    for name, raw in env.env_items():
        if not name.startswith(_SLO_ENV_PREFIX) or name == _SLO_ENV_PREFIX:
            continue
        try:
            out[name[len(_SLO_ENV_PREFIX):].lower()] = float(raw)
        except ValueError:
            raise ValueError(
                f"env {name}={raw!r}: expected a number (milliseconds)"
            ) from None
    return out or None


@dataclasses.dataclass
class ServiceSettings:
    """Service knobs; every default has a ``SIEVE_SVC_*`` env override."""

    queue_limit: int = 64
    workers: int = 4
    default_deadline_s: float = 30.0
    lru_segments: int = 32
    cold_chunk: int = 1 << 22
    cold_cache_entries: int = 4096
    max_primes: int = 200_000
    max_pair_span: int = 10**8
    breaker_fails: int = 3
    breaker_cooldown_s: float = 5.0
    # live follow: ledger poll period (0 disables the follower entirely)
    refresh_s: float = 2.0
    # graceful drain: hard exit budget once draining starts
    drain_s: float = 5.0
    # wire-injectable chaos (the "chaos" message): default OFF — any
    # client could otherwise fault-inject a production server. The CLI
    # spells this --allow-chaos; --chaos-config schedules still apply.
    wire_chaos: bool = False
    # test/chaos knob: extra latency per cold *dispatch* (not per chunk:
    # a batch of N chunks pays it once — exactly the economics batching
    # buys), to simulate a saturated backend deterministically
    cold_delay_s: float = 0.0
    # batched cold plane: write cold results back into the
    # ledger (this server becomes the checkpoint dir's designated
    # writer), and cap how many chunks one backend dispatch may carry
    persist_cold: bool = False
    batch_max_chunks: int = 128
    # priority lanes: per-lane queue limits (None inherits
    # queue_limit), dedicated hot workers (capped at workers-1 so the
    # cold plane always keeps at least one worker when workers > 1),
    # and the age at which a queued cold item beats fresh hot work
    hot_queue_limit: int | None = None
    cold_queue_limit: int | None = None
    hot_workers: int = 1
    cold_age_s: float = 1.0
    # range sharding: anchor this server's served range at a
    # shard lower bound instead of 2. Counts become "primes in
    # [range_lo, v)", nth_prime becomes "k-th prime >= range_lo", and
    # queries below range_lo are typed bad_request naming the range —
    # global-semantics composition is the router's job, never a shard's.
    range_lo: int = 2
    # fleet telemetry: ship the bounded span ring piggybacked
    # on terminal replies that ask for it (``telemetry: true`` on the
    # query — the router's merge input). OFF by default: an embedded
    # in-process server shares the host's tracer, and draining it would
    # steal the host's own spans.
    telemetry_ship: bool = False
    # piggyback batching: only attach the ring once this many events are
    # pending (the ``telemetry`` wire op flushes the remainder — the
    # router pulls it when its trace closes). Shipping on EVERY reply
    # would put a serialize on every hot-path request; batching keeps
    # the traced p95 within a few percent of the untraced one. The
    # default is half the default ring: ships stay rare enough that a
    # p95 window sees at most one, but the ring never overflows between
    # ships on a steady request stream.
    telemetry_batch: int = 2048
    # per-op latency SLOs: op -> target ms (None = no SLOs). A rolling
    # window of the last slo_window terminal latencies per op; the op
    # "burns" while its window p95 exceeds the target.
    slo_ms: dict[str, float] | None = None
    slo_window: int = 256
    # flight recorder: continuous black-box capture (bounded
    # deques — cheap enough to be on by default). debug_dir is where
    # edge triggers (SLO burn, breaker open, crash) freeze timestamped
    # postmortem bundles (None = inline-only, served by the ``debug``
    # wire op); triggers throttle to one bundle per kind per cooldown.
    # metrics_sample_s is the MetricsHistory trend-sampler tick
    # (0 disables the sampler; the env spelling is the metrics-level
    # SIEVE_METRICS_SAMPLE_S, shared with the cluster plane).
    recorder: bool = True
    debug_dir: str | None = None
    debug_cooldown_s: float = 30.0
    metrics_sample_s: float = 1.0
    # wire plane: cap on members per ``batch`` wire op (one
    # RPC carrying M point queries), and the per-connection write-queue
    # ceiling — a consumer that stops reading its replies is closed as
    # a slow consumer once this many encoded bytes are parked, so one
    # stuck socket can never balloon the event loop's memory.
    batch_queries: int = 1024
    write_queue_bytes: int = 8 << 20
    # binary wire v2: answer ``hello`` negotiation with the
    # columnar frame capability. False pins every connection to v1 JSON
    # — the mixed-fleet simulation knob and the emergency off-switch;
    # clients detect the downgrade and log one ``wire_downgrade`` event.
    wire_v2: bool = True
    # multi-process serving: procs is the fleet size the CLI
    # supervisor spawns (1 = classic single process; the env spelling is
    # SIEVE_SVC_PROCS); proc_index is THIS process's slot in that fleet
    # (set by the supervisor, never from env) — index 0 is the elected
    # writer owning persist-cold and store compaction, every other index
    # runs read-only against the shared store/ledger. reuse_port binds
    # the listener with SO_REUSEPORT so N processes share one port.
    procs: int = 1
    proc_index: int = 0
    reuse_port: bool = False
    # tiered segment store: on by default whenever the config
    # has a checkpoint_dir; SIEVE_STORE=0 is the off-switch. The store's
    # own knobs (SIEVE_STORE_FSYNC / _COMPACT_S / _COMPACT_RATIO /
    # _MIN_COMPACT_BYTES / _T2_BYTES / _REFRESH_S) are read by
    # sieve.service.store.StoreSettings.from_env.
    store: bool = True
    # mesh-backed cold plane: "mesh" dispatches each cold
    # drain slice as ONE MeshWorker dispatch spanning every card (the
    # word kernel, sieve_torch/backends/mesh_backend.py); "loop" is the
    # single-worker path. Mesh init or launch failure falls back to the
    # loop worker — typed (event + counter), never a wrong answer.
    cold_backend: str = "loop"
    # tail-sampled exemplar tracing: when on, every request's
    # ctx-carrying spans land in the tracer's exemplar ring, and at
    # completion a sampler decides retention — keep the span tree if the
    # request ended typed-error/shed/degraded/demoted, or its latency
    # exceeded the self-tracked rolling p95 x exemplar_slack (armed only
    # after exemplar_warmup observations), plus a deterministic
    # 1-in-exemplar_baseline healthy baseline. Kept trees go to a
    # bounded in-memory ring (served by the ``exemplars`` wire op) and,
    # under debug_dir, a size-capped rolling exemplars.jsonl.
    exemplars: bool = True
    exemplar_slack: float = 2.0
    exemplar_baseline: int = 100
    exemplar_window: int = 256
    exemplar_warmup: int = 30
    exemplar_ring: int = 256
    exemplar_file_bytes: int = 4 << 20
    # always-on continuous profiler: a daemon thread samples
    # sys._current_frames() at prof_hz, folding stacks into a bounded
    # collapsed-stack table (prof_stacks entries, drop-coldest) tagged
    # with thread role and active span. Served by the ``profile`` wire
    # op, snapshotted into every flight-recorder bundle. prof_hz=0
    # disables; prof_idle=True also keeps samples whose leaf is a
    # known parked wait (off by default so shares reflect real work).
    prof_hz: float = 19.0
    prof_stacks: int = 512
    prof_idle: bool = False

    def validate(self) -> "ServiceSettings":
        """Typed startup validation: every rejection names the setting
        (and, via ``from_env``, parse failures name the env variable) —
        a bad knob must fail at startup, never as undefined runtime
        behavior in the admission plane."""
        for name in ("queue_limit", "workers", "batch_max_chunks",
                     "lru_segments", "cold_chunk", "cold_cache_entries",
                     "max_primes", "max_pair_span", "breaker_fails",
                     "batch_queries", "write_queue_bytes",
                     "exemplar_baseline", "exemplar_window",
                     "exemplar_ring", "exemplar_file_bytes",
                     "prof_stacks"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                raise ValueError(
                    f"service settings: {name}={v!r} must be a positive "
                    "integer"
                )
        for name in ("hot_queue_limit", "cold_queue_limit"):
            v = getattr(self, name)
            if v is not None and (not isinstance(v, int)
                                  or isinstance(v, bool) or v <= 0):
                raise ValueError(
                    f"service settings: {name}={v!r} must be a positive "
                    "integer (or None to inherit queue_limit)"
                )
        if (not isinstance(self.hot_workers, int)
                or isinstance(self.hot_workers, bool)
                or self.hot_workers < 0):
            raise ValueError(
                f"service settings: hot_workers={self.hot_workers!r} "
                "must be a non-negative integer"
            )
        for name in ("refresh_s", "drain_s", "cold_delay_s", "cold_age_s",
                     "breaker_cooldown_s", "debug_cooldown_s",
                     "metrics_sample_s", "prof_hz"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v < 0 or not math.isfinite(v):
                raise ValueError(
                    f"service settings: {name}={v!r} must be a "
                    "non-negative number"
                )
        if (not isinstance(self.default_deadline_s, (int, float))
                or isinstance(self.default_deadline_s, bool)
                or self.default_deadline_s <= 0
                or not math.isfinite(self.default_deadline_s)):
            raise ValueError(
                "service settings: default_deadline_s="
                f"{self.default_deadline_s!r} must be a positive number"
            )
        if (not isinstance(self.range_lo, int)
                or isinstance(self.range_lo, bool) or self.range_lo < 2):
            raise ValueError(
                f"service settings: range_lo={self.range_lo!r} must be an "
                "integer >= 2"
            )
        if (not isinstance(self.procs, int) or isinstance(self.procs, bool)
                or self.procs < 1):
            raise ValueError(
                f"service settings: procs={self.procs!r} must be a "
                "positive integer"
            )
        if (not isinstance(self.proc_index, int)
                or isinstance(self.proc_index, bool)
                or not 0 <= self.proc_index < max(self.procs, 1)):
            raise ValueError(
                f"service settings: proc_index={self.proc_index!r} must "
                f"be in [0, procs={self.procs})"
            )
        if (not isinstance(self.slo_window, int)
                or isinstance(self.slo_window, bool) or self.slo_window <= 0):
            raise ValueError(
                f"service settings: slo_window={self.slo_window!r} must be "
                "a positive integer"
            )
        if (not isinstance(self.telemetry_batch, int)
                or isinstance(self.telemetry_batch, bool)
                or self.telemetry_batch < 1):
            raise ValueError(
                f"service settings: telemetry_batch={self.telemetry_batch!r} "
                "must be a positive integer"
            )
        if (not isinstance(self.exemplar_warmup, int)
                or isinstance(self.exemplar_warmup, bool)
                or self.exemplar_warmup < 0):
            raise ValueError(
                f"service settings: exemplar_warmup="
                f"{self.exemplar_warmup!r} must be a non-negative integer"
            )
        if (not isinstance(self.exemplar_slack, (int, float))
                or isinstance(self.exemplar_slack, bool)
                or self.exemplar_slack < 1.0
                or not math.isfinite(self.exemplar_slack)):
            raise ValueError(
                f"service settings: exemplar_slack="
                f"{self.exemplar_slack!r} must be a number >= 1 (the "
                "rolling-p95 multiplier)"
            )
        if self.debug_dir is not None and (
            not isinstance(self.debug_dir, str) or not self.debug_dir
        ):
            raise ValueError(
                f"service settings: debug_dir={self.debug_dir!r} must be a "
                "non-empty path (or None)"
            )
        if self.cold_backend not in ("loop", "mesh"):
            raise ValueError(
                f"service settings: cold_backend={self.cold_backend!r} "
                "must be 'loop' or 'mesh'"
            )
        if self.slo_ms is not None:
            if not isinstance(self.slo_ms, dict):
                raise ValueError(
                    f"service settings: slo_ms={self.slo_ms!r} must be a "
                    "dict of op -> target ms (or None)"
                )
            for op, ms in self.slo_ms.items():
                if (not isinstance(op, str) or not op
                        or not isinstance(ms, (int, float))
                        or isinstance(ms, bool) or ms <= 0
                        or not math.isfinite(ms)):
                    raise ValueError(
                        f"service settings: slo_ms[{op!r}]={ms!r} must map "
                        "an op name to a positive number of milliseconds"
                    )
        return self

    @classmethod
    def from_env(cls, **overrides: Any) -> "ServiceSettings":
        s = cls(
            queue_limit=_env_int("SIEVE_SVC_QUEUE", cls.queue_limit),
            workers=_env_int("SIEVE_SVC_WORKERS", cls.workers),
            default_deadline_s=_env_float(
                "SIEVE_SVC_DEADLINE_S", cls.default_deadline_s
            ),
            lru_segments=_env_int("SIEVE_SVC_LRU", cls.lru_segments),
            cold_chunk=_env_int("SIEVE_SVC_COLD_CHUNK", cls.cold_chunk),
            cold_cache_entries=_env_int(
                "SIEVE_SVC_COLD_CACHE", cls.cold_cache_entries
            ),
            max_primes=_env_int("SIEVE_SVC_MAX_PRIMES", cls.max_primes),
            max_pair_span=_env_int(
                "SIEVE_SVC_MAX_PAIR_SPAN", cls.max_pair_span
            ),
            breaker_fails=_env_int("SIEVE_SVC_BREAKER_FAILS", cls.breaker_fails),
            breaker_cooldown_s=_env_float(
                "SIEVE_SVC_BREAKER_COOLDOWN_S", cls.breaker_cooldown_s
            ),
            refresh_s=_env_float("SIEVE_SVC_REFRESH_S", cls.refresh_s),
            drain_s=_env_float("SIEVE_SVC_DRAIN_S", cls.drain_s),
            wire_chaos=_env_bool("SIEVE_SVC_WIRE_CHAOS", "0"),
            wire_v2=_env_bool("SIEVE_SVC_WIRE_V2", "1"),
            cold_delay_s=_env_float("SIEVE_SVC_COLD_DELAY_S", cls.cold_delay_s),
            persist_cold=_env_bool("SIEVE_SVC_PERSIST_COLD", "0"),
            batch_max_chunks=_env_int(
                "SIEVE_SVC_BATCH_MAX", cls.batch_max_chunks
            ),
            hot_queue_limit=_env_int(
                "SIEVE_SVC_HOT_QUEUE", cls.hot_queue_limit
            ),
            cold_queue_limit=_env_int(
                "SIEVE_SVC_COLD_QUEUE", cls.cold_queue_limit
            ),
            hot_workers=_env_int("SIEVE_SVC_HOT_WORKERS", cls.hot_workers),
            cold_age_s=_env_float("SIEVE_SVC_COLD_AGE_S", cls.cold_age_s),
            range_lo=_env_int("SIEVE_SVC_RANGE_LO", cls.range_lo),
            telemetry_ship=_env_bool("SIEVE_SVC_TELEMETRY", "0"),
            telemetry_batch=_env_int(
                "SIEVE_SVC_TELEMETRY_BATCH", cls.telemetry_batch
            ),
            slo_ms=_slo_from_env(),
            slo_window=_env_int("SIEVE_SVC_SLO_WINDOW", cls.slo_window),
            recorder=_env_bool("SIEVE_SVC_RECORDER", "1"),
            debug_dir=env.env_str("SIEVE_SVC_DEBUG_DIR") or None,
            debug_cooldown_s=_env_float(
                "SIEVE_SVC_DEBUG_COOLDOWN_S", cls.debug_cooldown_s
            ),
            metrics_sample_s=sample_interval_s(),
            batch_queries=_env_int(
                "SIEVE_SVC_BATCH_QUERIES", cls.batch_queries
            ),
            write_queue_bytes=_env_int(
                "SIEVE_SVC_WRITE_QUEUE", cls.write_queue_bytes
            ),
            procs=_env_int("SIEVE_SVC_PROCS", cls.procs),
            reuse_port=_env_bool("SIEVE_SVC_REUSE_PORT", "0"),
            store=_env_bool("SIEVE_STORE", "1"),
            cold_backend=(
                env.env_str("SIEVE_SVC_COLD_BACKEND") or cls.cold_backend
            ),
            exemplars=_env_bool("SIEVE_SVC_EXEMPLARS", "1"),
            exemplar_slack=_env_float(
                "SIEVE_SVC_EXEMPLAR_SLACK", cls.exemplar_slack
            ),
            exemplar_baseline=_env_int(
                "SIEVE_SVC_EXEMPLAR_BASELINE", cls.exemplar_baseline
            ),
            exemplar_window=_env_int(
                "SIEVE_SVC_EXEMPLAR_WINDOW", cls.exemplar_window
            ),
            exemplar_warmup=_env_int(
                "SIEVE_SVC_EXEMPLAR_WARMUP", cls.exemplar_warmup
            ),
            exemplar_ring=_env_int(
                "SIEVE_SVC_EXEMPLAR_RING", cls.exemplar_ring
            ),
            exemplar_file_bytes=_env_int(
                "SIEVE_SVC_EXEMPLAR_FILE_BYTES", cls.exemplar_file_bytes
            ),
            prof_hz=_env_float("SIEVE_PROF_HZ", cls.prof_hz),
            prof_stacks=_env_int("SIEVE_PROF_STACKS", cls.prof_stacks),
            prof_idle=_env_bool("SIEVE_PROF_IDLE", "0"),
        )
        return dataclasses.replace(s, **overrides)


def _pin_device(config: "SieveConfig") -> "SieveConfig":
    """``config`` with a bare ``cuda`` device pinned to the constructing
    thread's current card. The workers are built lazily, on whichever
    handler or batcher thread first needs them, and a bare ``cuda`` there
    would name THAT thread's current device; pinning here makes every
    tensor and launch of the cold plane land on the card the server was
    started on."""
    import torch

    dev = torch.device(config.device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return dataclasses.replace(
            config, device=f"cuda:{torch.cuda.current_device()}"
        )
    return config


class ColdBackend:
    """Circuit-broken wrapper around the configured SieveWorker backend.

    Computes exact prime counts for cold chunks. Consecutive failures
    (``breaker_fails``) open the breaker for ``breaker_cooldown_s``;
    while open — or while an injected ``backend_down`` window is live —
    every call fails fast with :class:`Degraded` so the worker pool is
    never parked on a dead backend. One lock serializes the backend: it
    models a single saturated compute resource and keeps the device
    backends' host-side chains (not thread-safe) correct.
    """

    def __init__(self, config: "SieveConfig", settings: ServiceSettings,
                 on_transition=None, chaos=None, events=None, bump=None):
        self.config = _pin_device(config)
        self.settings = settings
        self._worker = None  # guard: _lock — lazy; a cold-only
        # server may never need it
        self._lock = named_lock("ColdBackend._lock")
        self._state_lock = named_lock("ColdBackend._state_lock")
        self._fail_streak = 0  # guard: _state_lock
        self._down_until = 0.0  # guard: _state_lock
        self._down_reason = ""  # guard: _state_lock
        self._degraded = False  # guard: _state_lock
        self._on_transition = on_transition or (lambda entering, reason: None)
        # mesh cold plane: lazy MeshWorker + typed fallback
        # bookkeeping. A failed mesh INIT is permanent for this process
        # (config/host problem — retrying per drain would pay the failed
        # device probe on every dispatch); a failed LAUNCH falls back
        # per-batch and the next drain tries the mesh again.
        self._mesh_worker = None  # guard: none(written under _lock only;
        # set-once None->worker, lock-free describe() reads are racy-ok)
        self._mesh_failed = None  # guard: none(written under _lock only;
        # set-once None->reason, lock-free describe() reads are racy-ok)
        # observability counters: written only under _lock (count_ranges
        # is the single writer); describe() snapshots them lock-free so
        # stats/health never block behind a long cold dispatch
        self.mesh_launches = 0  # guard: none(written under _lock only;
        # lock-free reads are racy-ok monotonic snapshots)
        self.mesh_fallbacks = 0  # guard: none(written under _lock only;
        # lock-free reads are racy-ok monotonic snapshots)
        self.last_fanout = 0  # guard: none(written under _lock only;
        # lock-free reads are racy-ok snapshots)
        self._chaos = chaos  # injected schedule (svc_mesh_fail draws)
        self._event = events or (lambda kind, **fields: None)
        self._bump = bump or (lambda key, n=1: None)

    def force_down(self, secs: float, reason: str) -> None:
        """Chaos/backend_down: report down for ``secs`` from now."""
        with self._state_lock:
            self._down_until = max(self._down_until, trace.now_s() + secs)
            self._down_reason = reason
        self._update_health()

    def is_down(self) -> tuple[bool, str]:
        with self._state_lock:
            if trace.now_s() < self._down_until:
                return True, self._down_reason
        return False, ""

    @property
    def degraded(self) -> bool:
        self._update_health()
        with self._state_lock:
            return self._degraded

    def _update_health(self) -> None:
        with self._state_lock:
            now_down = trace.now_s() < self._down_until
            if now_down != self._degraded:
                self._degraded = now_down
                reason = self._down_reason if now_down else "recovered"
                transition = (now_down, reason)
            else:
                transition = None
        if transition is not None:
            self._on_transition(*transition)

    def count_range(self, lo: int, hi: int) -> int:
        """Exact primes in [lo, hi) via the backend, or raise Degraded."""
        return int(self.count_ranges([(lo, hi)])[0].count)

    def describe(self) -> dict:
        """Cold-plane identity for stats/health/fleet_top:
        the effective backend class, mesh device count, and the last
        drain's chunk fanout — a misconfigured mesh replica (0 devices,
        'loop (mesh failed)') is visible at a glance. Lock-free: these
        are racy-ok snapshots of counters written under _lock."""
        worker = self._mesh_worker
        if worker is not None:
            klass, devices = "mesh", worker.devices
        elif self._mesh_failed is not None:
            klass, devices = "loop (mesh failed)", 0
        else:
            klass, devices = self.settings.cold_backend, 0
        return {
            "cold_backend": klass,
            "mesh_devices": devices,
            "mesh_fanout": self.last_fanout,
        }

    def _mesh_locked(self):
        """Lazily build the MeshWorker. A failed init falls back typed
        (event + counter) ONCE and is then permanent for this process —
        it's a config/host problem, and retrying would pay the failed
        device probe on every drain. Caller holds ``_lock``."""
        if self._mesh_worker is not None:
            return self._mesh_worker
        if self._mesh_failed is not None:
            return None
        try:
            from sieve_torch.backends.mesh_backend import MeshWorker

            self._mesh_worker = MeshWorker(self.config)
        except Exception as e:
            self._mesh_failed = f"mesh init failed: {e}"
            self.mesh_fallbacks += 1
            self._bump("mesh_fallbacks")
            self._event(
                "service_mesh_fallback", reason=self._mesh_failed, chunks=0
            )
            return None
        return self._mesh_worker

    def _mesh_dispatch(self, mesh, chunks, seeds, seg_ids):
        """ONE mesh dispatch for the drain slice. Returns None
        on launch failure — the caller recomputes the same batch on the
        loop worker, so waiters always get exact answers and the
        degradation is typed (``service_mesh_fallback`` + counter), never
        a wrong answer or a crash. Caller holds ``_lock``."""
        self.mesh_launches += 1
        launch = self.mesh_launches
        t0 = trace.now_s()
        try:
            with trace.span(
                "query.cold_mesh", chunks=len(chunks),
                devices=mesh.devices, launch=launch,
            ):
                if self._chaos is not None and self._chaos.take_kinds(
                    0, launch, ("svc_mesh_fail",)
                ):
                    raise RuntimeError(
                        f"chaos svc_mesh_fail: mesh cold dispatch {launch}"
                    )
                results = mesh.process_segments(
                    chunks, seeds, seg_ids=seg_ids
                )
        except Exception as e:
            self.mesh_fallbacks += 1
            self._bump("mesh_fallbacks")
            self._event(
                "service_mesh_fallback",
                reason=f"mesh launch failed: {e}", chunks=len(chunks),
            )
            return None
        self.last_fanout = len(chunks)
        self._bump("mesh_launches")
        self._event(
            "service_mesh_dispatch", quietable=True, chunks=len(chunks),
            devices=mesh.devices, launch=launch,
            ms=round((trace.now_s() - t0) * 1e3, 3),
        )
        return results

    def count_ranges(self, chunks: list[tuple[int, int]]):
        """One backend dispatch for a sorted list of disjoint chunks
       : returns a :class:`~sieve_torch.worker.SegmentResult` per
        chunk (seg_id ``COLD_SEG_BASE + lo`` — the ledger write-back
        key), or raises :class:`Degraded` for the whole batch. The
        ``cold_delay_s`` saturation knob is paid once per dispatch, not
        per chunk — the economics the batch plane exists to buy. One
        failure is ONE breaker strike regardless of batch size."""
        down, reason = self.is_down()
        if down:
            raise Degraded(f"cold backend down: {reason}")
        if self.settings.cold_delay_s > 0:
            # simulated saturation (deterministic chaos/smoke scenarios)
            time.sleep(self.settings.cold_delay_s)
        # one seed set covering the largest hi serves every chunk (a
        # superset of seeds is always safe for a smaller segment)
        seeds = seed_primes(math.isqrt(max(hi for _, hi in chunks) - 1))
        seg_ids = [COLD_SEG_BASE + lo for lo, _ in chunks]
        try:
            with self._lock:
                if self._worker is None:
                    self._worker = make_worker(self.config)
                with trace.span(
                    "query.cold", lo=chunks[0][0], hi=chunks[-1][1],
                    chunks=len(chunks),
                ):
                    results = None
                    if self.settings.cold_backend == "mesh":
                        mesh = self._mesh_locked()
                        if mesh is not None:
                            # None -> typed fallback: the loop path below
                            # recomputes the same batch bit-exactly
                            results = self._mesh_dispatch(
                                mesh, chunks, seeds, seg_ids
                            )
                    if results is None:
                        batch = getattr(
                            self._worker, "process_segments", None
                        )
                        if batch is None:
                            # minimal worker stubs (tests) expose only the
                            # single-segment seam; loop it
                            results = [
                                self._worker.process_segment(
                                    lo, hi, seeds, seg_id=sid
                                )
                                for (lo, hi), sid in zip(chunks, seg_ids)
                            ]
                        else:
                            results = batch(chunks, seeds, seg_ids=seg_ids)
            for res in results:
                if not res.is_sane():
                    raise RuntimeError(
                        f"insane result for chunk [{res.lo}, {res.hi})"
                    )
        except Degraded:
            raise
        except Exception as e:
            with self._state_lock:
                self._fail_streak += 1
                tripped = self._fail_streak >= self.settings.breaker_fails
                if tripped:
                    self._down_until = max(
                        self._down_until,
                        trace.now_s() + self.settings.breaker_cooldown_s,
                    )
                    self._down_reason = f"breaker open ({e})"
                    self._fail_streak = 0
            self._update_health()
            raise Degraded(f"cold backend error: {e}") from e
        with self._state_lock:
            self._fail_streak = 0
        return results

    def close(self) -> None:
        with self._lock:
            if self._worker is not None:
                self._worker.close()
                self._worker = None
            if self._mesh_worker is not None:
                self._mesh_worker.close()
                self._mesh_worker = None


class _Flight:
    """Single-flight slot: waiters block until the batcher resolves the
    chunk with a full SegmentResult (or an error)."""

    __slots__ = ("event", "result", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.result = None  # SegmentResult once resolved ok
        self.error: Exception | None = None


class ColdBatcher:
    """The queue-drain batching point of the cold plane.

    Request handlers never call the backend directly any more: they
    register a :class:`_Flight` per missing chunk, submit the keys here,
    and wait. One daemon thread blocks for the first key, then drains
    everything else that queued-up requests have registered in the
    meantime, dedups (single-flight registration already guarantees one
    key per chunk), sorts onto the grid, and issues ONE backend dispatch
    for the whole list via :meth:`ColdBackend.count_ranges` — so M
    concurrent cold queries over K distinct chunks cost at most
    ``ceil(K / batch_max_chunks)`` dispatches. Completed results are
    cached, optionally written back to the ledger
    (:meth:`SieveService._persist_results`), and handed to every waiter.

    ``svc_batch_partial`` chaos keys on :attr:`batches` — the dispatch
    counter, this plane's own "segment" number (like the follower's
    refresh attempts) — and fails one chunk *before* it reaches the
    backend: its waiters get a typed ``degraded`` reply while the rest
    of the batch still answers exact.

    ``_drain_once`` is the whole state machine and is callable directly
    (tests drive it synchronously); the thread only adds the blocking
    loop.
    """

    def __init__(self, service: "SieveService"):
        self.svc = service
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._thread: threading.Thread | None = None
        self.batches = 0  # guard: none(single writer: svc-batcher —
        # the svc_batch_partial dispatch-counter key; tests drive
        # _drain_once synchronously)

    def start(self) -> "ColdBatcher":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="svc-batcher"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5)

    def submit(self, keys: list[tuple[int, int]]) -> None:
        """Enqueue registered-leader chunk keys as ONE item — a request's
        whole chunk list is never split across drains."""
        self._q.put(list(keys))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._drain_once(item) == "stop":
                return

    def _drain_once(self, first: list[tuple[int, int]]) -> str:
        """Collect every key list queued behind ``first``, then dispatch
        the sorted distinct set in ``batch_max_chunks``-bounded slices."""
        keys = set(first)
        stop = False
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                stop = True  # finish the batch in hand, then exit
            else:
                keys.update(item)
        batch = sorted(keys)
        cap = max(1, self.svc.settings.batch_max_chunks)
        for i in range(0, len(batch), cap):
            self._dispatch(batch[i:i + cap])
        return "stop" if stop else "ok"

    def _dispatch(self, batch: list[tuple[int, int]]) -> None:
        svc = self.svc
        self.batches += 1
        t0 = trace.now_s()
        failed: set[int] = set()
        for d in svc.chaos.take_kinds(0, self.batches,
                                      ("svc_batch_partial",)):
            failed.add(int(d["param"] or 0))
        good: list[tuple[int, int]] = []
        for i, key in enumerate(batch):
            if i in failed:
                # per-chunk degradation: only THIS chunk's waiters see a
                # typed degraded reply; the rest of the batch proceeds
                self._resolve(key, None, Degraded(
                    f"chaos svc_batch_partial: chunk [{key[0]}, {key[1]}) "
                    f"failed in batch {self.batches}"
                ))
            else:
                good.append(key)
        n_failed = len(batch) - len(good)
        # tier-1 restart-hot: a chunk whose boundary entry a
        # previous incarnation persisted through the store answers from
        # disk — no re-marking across restarts. Only boundary-or-richer
        # tiers qualify (counts alone can't rebuild a SegmentResult).
        if good:
            hits: list[tuple[tuple[int, int], SegmentResult]] = []
            misses: list[tuple[int, int]] = []
            for key in good:
                res = svc._store_cold_result(key)
                if res is None:
                    misses.append(key)
                else:
                    hits.append((key, res))
            if hits:
                svc._bump("cold_store_hits", len(hits))
                with svc._cold_lock:
                    for _key, res in hits:
                        svc._cold_cache[(res.lo, res.hi)] = res
                        svc._cold_cache.move_to_end((res.lo, res.hi))
                    while (len(svc._cold_cache)
                           > svc.settings.cold_cache_entries):
                        svc._cold_cache.popitem(last=False)
                for key, res in hits:
                    self._resolve(key, res, None)
            good = misses
        persisted = 0
        if good:
            svc._bump("cold_dispatches")
            svc._bump("cold_batched_chunks", len(good))
            svc._bump("cold_computes", len(good))
            try:
                with trace.span("query.cold_batch", chunks=len(good),
                                lo=good[0][0], hi=good[-1][1]):
                    results = svc.cold.count_ranges(good)
            except Exception as e:  # Degraded or internal: whole dispatch
                for key in good:
                    self._resolve(key, None, e)
            else:
                persisted = svc._persist_results(results)
                with svc._cold_lock:
                    for res in results:
                        svc._cold_cache[(res.lo, res.hi)] = res
                        svc._cold_cache.move_to_end((res.lo, res.hi))
                    while (len(svc._cold_cache)
                           > svc.settings.cold_cache_entries):
                        svc._cold_cache.popitem(last=False)
                for key, res in zip(good, results):
                    self._resolve(key, res, None)
        ms = round((trace.now_s() - t0) * 1000, 3)
        registry().histogram("service.batch_chunks").observe(len(good))
        svc.metrics.event(
            "service_batched", quietable=True, chunks=len(good),
            lo=batch[0][0], hi=batch[-1][1], ms=ms,
            persisted=persisted, failed=n_failed,
        )

    def _resolve(self, key, result, error) -> None:
        svc = self.svc
        with svc._cold_lock:
            flight = svc._inflight.pop(key, None)
        if flight is None:
            return  # cancelled/raced away; the result is still cached
        flight.result = result
        flight.error = error
        flight.event.set()


class LedgerFollower:
    """Live-follow the ledger a concurrent coordinator is extending.

    A daemon thread stats the ledger file every ``refresh_s``; when the
    fingerprint (mtime + size) moves it re-opens read-only, verifies the
    checksum, builds a fresh :class:`SieveIndex` that *inherits the old
    BitsetLRU*, and swaps it in with one reference assignment — readers
    that captured the previous index finish on it untouched. Invariants:

    * ``covered_hi`` is monotonic per process: a snapshot that would
      shrink coverage (the coordinator's quarantine window, a rewritten
      or foreign ledger) is a skipped refresh, never a swap.
    * a corrupt / mid-quarantine / vanished read is a skipped refresh
      with a ``service_refresh_failed`` event — never a crash; the stale
      fingerprint is dropped so the very next poll retries.
    * each swap emits ``service_refreshed`` + the ``cluster.covered_hi``
      gauge and a ``service.refresh`` trace span.

    ``poll_once`` is the whole state machine and is callable directly
    (tests drive it synchronously); the thread only adds the timer.
    """

    def __init__(self, service: "SieveService", refresh_s: float):
        self.service = service
        self.refresh_s = refresh_s
        self._path = service.ledger_path
        assert self._path is not None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._poll_lock = named_lock("LedgerFollower._poll_lock")
        self._last_fp = ledger_fingerprint(self._path)
        self._last_checksum = (
            service.ledger.checksum if service.ledger is not None else None
        )
        self.attempts = 0  # guard: none(single writer: svc-follower —
        # refresh *attempts*, the svc_refresh_corrupt key)

    def start(self) -> "LedgerFollower":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="svc-follower"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.refresh_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the follower never dies
                self._failed(trace.now_s(), f"unexpected: {e!r}")

    def poll_once(self) -> str:
        """One poll step; returns "unchanged" / "swapped" / "failed"."""
        with self._poll_lock:
            return self._poll_locked()

    def _poll_locked(self) -> str:
        svc = self.service
        # Non-writer processes learn about new store generations (post-
        # compaction pointer swaps) and freshly appended peer demotions
        # here, on the same cadence as ledger follows.  Independent of
        # the ledger fingerprint: peer appends don't touch the ledger.
        if svc.store is not None:
            try:
                svc.store.maybe_refresh()
            except Exception:  # noqa: BLE001 — the follower never dies
                pass
        fp = ledger_fingerprint(self._path)
        if fp == self._last_fp:
            return "unchanged"
        self.attempts += 1
        t0 = trace.now_s()
        if svc.chaos.take_kinds(0, self.attempts, ("svc_refresh_corrupt",)):
            self._failed(t0, "chaos svc_refresh_corrupt injected")
            return "failed"
        try:
            led = svc._open_snapshot()
        except (LedgerMismatch, OSError, ValueError) as e:
            self._failed(t0, f"{type(e).__name__}: {e}")
            return "failed"
        if led.checksum == self._last_checksum:
            self._last_fp = fp  # atomic rewrite of identical content
            return "unchanged"
        old = svc.index
        new = SieveIndex(
            svc.config.packing, led.completed(),
            svc.settings.lru_segments, lru=old.lru, base=old.base,
            store=old.store,
        )
        if new.covered_hi < old.covered_hi:
            self._failed(
                t0,
                f"covered_hi would regress {old.covered_hi} -> "
                f"{new.covered_hi} (mid-quarantine or rewritten ledger); "
                "keeping the previous snapshot",
            )
            return "failed"
        # THE swap: one reference assignment. In-flight queries hold the
        # old index (captured at admission) and finish on it; new
        # requests see the new one. Never mutate an index in place.
        svc.index = new
        svc.ledger = led
        svc._snapshot_ts = trace.now_s()
        svc._refreshes += 1
        self._last_fp = fp
        self._last_checksum = led.checksum
        registry().gauge("cluster.covered_hi").set(float(new.covered_hi))
        svc.metrics.event(
            "service_refreshed",
            covered_hi=new.covered_hi,
            prev_covered_hi=old.covered_hi,
            segments=len(new.segments),
            refreshes=svc._refreshes,
        )
        trace.add_span(
            "service.refresh", t0, trace.now_s() - t0,
            outcome="swapped", covered_hi=new.covered_hi,
            prev_covered_hi=old.covered_hi,
        )
        return "swapped"

    def _failed(self, t0: float, reason: str) -> None:
        svc = self.service
        svc._refresh_failed += 1
        self._last_fp = None  # retry on the very next poll
        svc.metrics.event("service_refresh_failed", reason=reason)
        registry().counter("service.refresh_failed").inc()
        trace.add_span(
            "service.refresh", t0, trace.now_s() - t0,
            outcome="failed", reason=reason,
        )


_STATS = (
    "requests",
    "index_hits",
    "cold_computes",
    "cold_cache_hits",
    "cold_dispatches",
    "cold_batched_chunks",
    "cold_persisted",
    "cold_store_hits",
    "mesh_launches",
    "mesh_fallbacks",
    "coalesced",
    "shed",
    "hot_admitted",
    "cold_admitted",
    "demoted",
    "lane_shed_hot",
    "lane_shed_cold",
    "deadline_exceeded",
    "degraded_replies",
    "draining_replies",
    "bad_requests",
    "internal_errors",
    "telemetry_replies",
    "trace_drops",
    "batch_requests",
    "batch_members",
    "slow_consumer_closed",
    "wire_v2_conns",
    "exemplars_seen",
    "exemplars_kept",
    "profile_pulls",
    "profile_gaps",
)


# --- wire event loop ----------------------------------------------

# event-loop tick for throttled (svc_slow_frame) connections: a dribbled
# write queue drains in bytes-per-tick slices at this cadence while every
# other connection keeps full-speed service
_TICK_S = 0.005


class _Conn:
    """Per-connection state owned by the wire event loop.

    The loop thread does all reads; reply frames are appended under
    ``lock`` and either flushed directly by the replying thread (idle
    queue, ``tx`` serializes the socket) or left for the woken loop.
    ``head_off`` tracks how much of the queue's head frame has hit the
    socket, so a front-inserted inline reply (health/stats/metrics/
    debug) can jump the queue without ever interleaving into a
    partially-sent frame.
    """

    __slots__ = ("sock", "decoder", "wq", "head_off", "wq_bytes", "lock",
                 "tx", "sending", "closed", "kill", "throttle_bps",
                 "next_t", "mask", "wire_v")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.decoder = FrameDecoder()
        self.wq: collections.deque[bytes] = collections.deque()
        self.head_off = 0  # guard: lock
        self.wq_bytes = 0  # guard: lock
        self.lock = named_lock("_Conn.lock")
        # serializes actual socket sends: the loop's flush, throttled
        # ticks, and a worker's opportunistic direct send never
        # interleave bytes on the wire
        self.tx = named_lock("_Conn.tx")
        # True while a send of the head frame is in flight — head_off
        # only records progress AFTER send() returns, so a front-insert
        # must also treat an invisible whole-frame send as "the head is
        # spoken for" or the sender's popleft destroys the wrong frame
        self.sending = False  # guard: lock
        self.closed = False  # guard: lock
        # set by writers that cannot touch the selector (slow-consumer
        # overflow): the loop reaps killed conns on its next wakeup
        self.kill = False  # guard: lock
        # svc_slow_frame chaos: reply bytes per _TICK_S (0 = full speed)
        self.throttle_bps = 0.0  # guard: none(written only by the
        # wire thread; locked worker reads see a current-or-older
        # budget, both safe)
        self.next_t = 0.0
        self.mask = 0  # selector interest currently registered
        # negotiated wire version for frames WE send on this conn
        #. Starts at the v1 JSON floor; the hello handshake
        # raises it before the client pipelines its first v2-era query.
        self.wire_v = WIRE_V1  # guard: none(written once by the wire
        # thread on hello, strictly before any reply that could observe
        # it is enqueued; workers only ever read)

    def pending(self) -> bool:
        with self.lock:
            return bool(self.wq)


class SieveService:
    """The persistent query server. See the module docstring for tiers."""

    def __init__(
        self,
        config: "SieveConfig",
        settings: ServiceSettings | None = None,
        addr: str | None = None,
    ):
        self.config = config
        self.settings = (settings or ServiceSettings.from_env()).validate()
        self._addr_req = addr or "127.0.0.1:0"
        self.metrics = MetricsLogger(config)
        entries = {}
        self.ledger = None  # guard: none(reference swap by
        # svc-follower; readers take one snapshot per message)
        if config.checkpoint_dir:
            self.ledger = self._open_snapshot()
            entries = self.ledger.completed()
        self.chaos = ChaosSchedule(config.chaos_directives())
        # tiered segment store: mmap'd tiers under the
        # checkpoint dir, shared by every --procs sibling through the
        # page cache. proc 0 is the elected writer (tier-0 ledger
        # import + background compaction); every process appends
        # demotions and follows generations. SIEVE_STORE=0 disables.
        self.store: TieredSegmentStore | None = None  # guard: none(set
        # once at construction; readers null-check)
        if config.checkpoint_dir and self.settings.store:
            self.store = TieredSegmentStore(
                os.path.join(config.checkpoint_dir, "store"),
                writer=(self.settings.proc_index == 0),
                settings=StoreSettings.from_env(),
                chaos=self.chaos,
                events=self.metrics.event,
            )
            if self.store.writer and self.ledger is not None:
                self.store.import_ledger(self.ledger.store_tier0_entries())
        # range sharding: the index anchors its contiguous
        # prefix at range_lo, so this server natively speaks shard-local
        # semantics (counts from range_lo, nth >= range_lo)
        self.base = self.settings.range_lo
        self.index = SieveIndex(  # guard: none(follower reference
            # swap; readers take one snapshot per message)
            config.packing, entries, self.settings.lru_segments,
            base=self.base, store=self.store,
        )
        registry().gauge("cluster.covered_hi").set(
            float(self.index.covered_hi)
        )
        self._snapshot_ts = trace.now_s()  # guard: none(single
        # writer: svc-follower; float reads are GIL-atomic)
        self._refreshes = 0  # guard: none(single writer: svc-follower)
        self._refresh_failed = 0  # guard: none(single writer:
        # svc-follower)
        self.follower: LedgerFollower | None = None  # guard: none(set
        # once in start(); readers null-check)
        self.cold = ColdBackend(
            config, self.settings, self._on_degraded,
            chaos=self.chaos, events=self.metrics.event, bump=self._bump,
        )
        self._cold_lock = named_lock("SieveService._cold_lock")
        # LRU of chunk results, most-recent at the end: O(1) hit
        # (move_to_end) and O(1) eviction (popitem(last=False)) — the
        # dict+list pair this replaces paid O(n) per eviction
        self._cold_cache: "collections.OrderedDict" = (  # guard: _cold_lock
            collections.OrderedDict())
        self._inflight: dict[tuple[int, int], _Flight] = {}  # guard: _cold_lock
        self.batcher = ColdBatcher(self)
        # --persist-cold: this server owns the checkpoint dir's ledger
        # as a writer; only the batcher thread ever records into it
        self._writer: Ledger | None = None
        # writer election: in a --procs fleet only proc 0
        # may own the ledger as a writer — readers keep persist_cold
        # semantics through the shared store + ledger follow instead
        if self.settings.persist_cold and config.checkpoint_dir \
                and self.settings.proc_index == 0:
            self._writer = Ledger.open(config)
        # priority lanes: two bounded deques under one
        # condition. Dedicated hot workers only ever pull "hot"; shared
        # workers prefer hot unless the cold head has aged past
        # cold_age_s (cold is delayed, never starved). workers == 1
        # degenerates to a single shared hot-preferring worker — a
        # reservation would otherwise starve the cold lane outright.
        s = self.settings
        self._hot_limit = (s.hot_queue_limit if s.hot_queue_limit is not None
                           else s.queue_limit)
        self._cold_limit = (s.cold_queue_limit
                            if s.cold_queue_limit is not None
                            else s.queue_limit)
        self._dedicated_hot = (min(s.hot_workers, s.workers - 1)
                               if s.workers > 1 else 0)
        self._lanes: dict[str, collections.deque] = {
            "hot": collections.deque(), "cold": collections.deque(),
        }
        self._lane_cond = named_condition("SieveService._lane_cond")
        self._stopping = False  # guard: _lane_cond
        self._seq = 0  # guard: _seq_lock
        self._seq_lock = named_lock("SieveService._seq_lock")
        self._stats = {k: 0 for k in _STATS}  # guard: _stats_lock
        self._stats_lock = named_lock("SieveService._stats_lock")
        self._threads: list[threading.Thread] = []
        self._conns: set[_Conn] = set()  # guard: _conns_lock
        self._conns_lock = named_lock("SieveService._conns_lock")
        self._listener: socket.socket | None = None  # guard: none(set
        # once in start() before the loop thread exists; drain/stop
        # only call shutdown(), never rebind)
        self._bound_addr: str | None = None
        self._closing = False  # guard: none(monotonic stop flag;
        # bool reads are GIL-atomic)
        # wire event loop: self-wake pipe so worker threads
        # (and drain/stop) can nudge the selector out of its wait
        self._wake_r: socket.socket | None = None  # guard: none(set
        # once in start() before the loop thread exists)
        self._wake_w: socket.socket | None = None  # guard: none(set
        # once in start() before the loop thread exists)
        # graceful drain: _inflight_n counts admitted-but-not-
        # replied queries; drain_event fires when draining starts, and
        # _drained once the last in-flight reply is out
        self._draining = False  # guard: none(monotonic drain flag;
        # a racy reader sheds at most one extra request)
        self._inflight_n = 0  # guard: _inflight_lock
        self._inflight_lock = named_lock("SieveService._inflight_lock")
        self.drain_event = threading.Event()
        self._drained = threading.Event()
        # replica_down chaos: while live, every connection is dropped
        # without a reply — a dead replica from the client's side
        self._replica_down_until = 0.0  # guard: none(wire-thread
        # only: the chaos admit path writes and _read_ready reads,
        # both on svc-wire)
        # per-op SLO tracking: rolling latency windows and
        # the set of ops currently burning (p95 over target) — the burn
        # *transition* is the event, the gauge is the live level
        self._slo_lock = named_lock("SieveService._slo_lock")
        self._slo_windows: dict[str, collections.deque] = {}  # guard: _slo_lock
        self._slo_burning: set[str] = set()  # guard: _slo_lock
        # telemetry shipping: armed in start() when telemetry_ship is on
        self._telemetry_on = False  # guard: none(armed once in
        # start(); bool reads are GIL-atomic)
        # flight recorder: trend sampler + black-box capture,
        # armed in start(); edge triggers (SLO burn, breaker open,
        # crash) freeze bundles under settings.debug_dir
        # continuous profiler: low-rate stack sampler feeding
        # the ``profile`` wire op and every recorder bundle; built before
        # the recorder so bundles can embed its snapshot
        self.profiler: StackProfiler | None = None
        if self.settings.prof_hz > 0:
            self.profiler = StackProfiler(
                "service",
                hz=self.settings.prof_hz,
                max_stacks=self.settings.prof_stacks,
                include_idle=self.settings.prof_idle,
            )
        self._prof_pulls = 0  # guard: none(wire-thread only: the
        # profile op is dispatched inline on svc-wire)
        self.history: MetricsHistory | None = None
        self.recorder: FlightRecorder | None = None
        if self.settings.recorder:
            self.history = MetricsHistory(
                sample_s=self.settings.metrics_sample_s
            )
            self.recorder = FlightRecorder(
                "service",
                debug_dir=self.settings.debug_dir,
                history=self.history,
                config=config,
                logger=self.metrics,
                cooldown_s=self.settings.debug_cooldown_s,
                profiler=self.profiler,
            )
        # tail-sampled exemplars: completion-time retention of
        # span trees — errors/demotions always, the slow tail past the
        # sampler's own rolling p95 x slack, and a 1-in-N healthy
        # baseline. Served inline by the ``exemplars`` wire op; persisted
        # to a rolling exemplars.jsonl when debug_dir is set.
        self.exemplar: ExemplarSampler | None = None
        if self.settings.exemplars:
            self.exemplar = ExemplarSampler(
                "service",
                slack=self.settings.exemplar_slack,
                baseline=self.settings.exemplar_baseline,
                window=self.settings.exemplar_window,
                warmup=self.settings.exemplar_warmup,
                ring=self.settings.exemplar_ring,
                file_bytes=self.settings.exemplar_file_bytes,
                debug_dir=self.settings.debug_dir,
                logger=self.metrics,
            )

    # --- lifecycle -------------------------------------------------------

    @property
    def addr(self) -> str:
        # cached at bind time: drain() closes the listener but the bound
        # address must stay queryable while connections finish
        assert self._bound_addr is not None, "service not started"
        return self._bound_addr

    @property
    def ledger_path(self):
        if not self.config.checkpoint_dir:
            return None
        from pathlib import Path

        from sieve_torch.checkpoint import LEDGER_NAME

        return Path(self.config.checkpoint_dir) / LEDGER_NAME

    def _open_snapshot(self) -> Ledger:
        """Read-only ledger open + the v1-compat warning event: a
        checksum-less version-1 file loads, but never silently."""
        led = Ledger.open_readonly(self.config)
        if led.unverified:
            self.metrics.event("ledger_unverified", path=str(led.path))
        return led

    def start(self) -> "SieveService":
        host, port = parse_addr(self._addr_req)
        # SO_REUSEPORT: N sibling processes bind the same
        # port and the kernel load-balances connections across them
        self._listener = socket.create_server(
            (host, port), reuse_port=self.settings.reuse_port)
        self._listener.listen(64)
        bhost, bport = self._listener.getsockname()[:2]
        self._bound_addr = f"{bhost}:{bport}"
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        t = threading.Thread(target=self._wire_loop, daemon=True,
                             name="svc-wire")
        t.start()
        self._threads.append(t)
        for i in range(self.settings.workers):
            dedicated = i < self._dedicated_hot
            w = threading.Thread(
                target=self._worker_loop, args=(dedicated,), daemon=True,
                name=f"svc-worker-{'hot-' if dedicated else ''}{i}",
            )
            w.start()
            self._threads.append(w)
        self.batcher.start()
        if self.store is not None:
            self.store.start()  # writer: background compactor
        if self.config.checkpoint_dir and self.settings.refresh_s > 0:
            self.follower = LedgerFollower(
                self, self.settings.refresh_s
            ).start()
        if self.settings.telemetry_ship:
            # same ship ring as a cluster worker: bounded drop-oldest
            # capture, drained onto terminal replies that ask for it
            from sieve_torch.worker import telemetry_ring_size

            ring = telemetry_ring_size()
            if ring > 0:
                tr = trace.get_tracer()
                tr.set_event_limit(ring)
                tr.enable(clear=False)
                self._telemetry_on = True
        if self.recorder is not None:
            self.history.start()
            self.recorder.install()
        if self.profiler is not None:
            self.profiler.start()
        if self.exemplar is not None:
            # arm the process tracer's exemplar span ring (independent of
            # full event capture — ``trace.enable`` stays off)
            trace.get_tracer().exemplar_enable(EXEMPLAR_SPAN_RING)
        return self

    def drain(self) -> None:
        """Flip to draining: stop accepting, answer queued work, shed new
        queries as typed ``draining``. Idempotent; SIGTERM, the wire
        ``shutdown`` message, and the ``svc_drain`` chaos kind all land
        here."""
        if self._draining:
            return
        self._draining = True
        if self._listener is not None:
            # shutdown only — connects are refused immediately, but the
            # fd stays open until the event loop unregisters it from the
            # selector (closing here would free the fd while its selector
            # registration is live; an accepted connection reusing the
            # number would then collide on register)
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._wake()
        hot, cold = self._lane_depths()
        with self._inflight_lock:
            inflight = self._inflight_n
        self.metrics.event("service_drain", queued=hot + cold,
                           inflight=inflight)
        registry().gauge("service.draining").set(1.0)
        self.drain_event.set()
        self._maybe_drained()

    def wait_drained(self, timeout: float | None = None) -> bool:
        """Block until every admitted query has been answered (True), or
        the timeout expired with work still in flight (False)."""
        return self._drained.wait(timeout)

    def _maybe_drained(self) -> None:
        with self._inflight_lock:
            done = self._draining and self._inflight_n == 0
        if done:
            self._drained.set()

    def stop(self) -> None:
        self._closing = True
        if self.follower is not None:
            self.follower.stop()
        if self._listener is not None:
            # shutdown only; the event loop owns the close (see drain)
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._wake()
        with self._lane_cond:
            self._stopping = True
            self._lane_cond.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        # the loop's exit path closes every conn; cover a wedged loop too
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.sock.close()
            except OSError:
                pass
        self.batcher.stop()
        self.cold.close()
        if self.store is not None:
            self.store.close()
        if self.exemplar is not None:
            self.exemplar.close()
        if self.profiler is not None:
            self.profiler.stop()
        if self.recorder is not None:
            self.recorder.uninstall()
            self.history.stop()
        self._drained.set()

    def __enter__(self) -> "SieveService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- bookkeeping -----------------------------------------------------

    def _bump(self, name: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[name] += n
        registry().counter(f"service.{name}").inc(n)

    # --- SLO tracking ------------------------------------------

    def _observe_slo(self, op: str, elapsed_ms: float) -> None:
        """Fold one terminal latency into the op's rolling window. The
        ``service.slo_burn`` gauge carries the worst burn ratio across
        ops (p95/target; >1 means out of SLO); the ``service_slo_burn``
        event fires on the transition INTO burn, not per request."""
        slo = self.settings.slo_ms
        if not slo:
            return
        target = slo.get(op)
        if target is None:
            return
        with self._slo_lock:
            win = self._slo_windows.get(op)
            if win is None:
                win = self._slo_windows[op] = collections.deque(
                    maxlen=self.settings.slo_window
                )
            win.append(elapsed_ms)
            vals = sorted(win)
            p95 = vals[max(0, math.ceil(0.95 * len(vals)) - 1)]
            burn = p95 / target
            newly = burn > 1.0 and op not in self._slo_burning
            if burn > 1.0:
                self._slo_burning.add(op)
            else:
                self._slo_burning.discard(op)
            worst = max(
                (self._win_burn_locked(o) for o in self._slo_windows),
                default=0.0,
            )
        reg = registry()
        reg.gauge(f"service.slo_burn.{op}").set(round(burn, 4))
        reg.gauge("service.slo_burn").set(round(worst, 4))
        if newly:
            self.metrics.event(
                "service_slo_burn", op=op, p95_ms=round(p95, 3),
                slo_ms=target, window=len(vals),
            )
            if self.recorder is not None:
                self.recorder.trigger(
                    "slo_burn", op=op, p95_ms=round(p95, 3), slo_ms=target,
                )

    def _win_burn_locked(self, op: str) -> float:  # holds: _slo_lock
        win = self._slo_windows.get(op)
        target = (self.settings.slo_ms or {}).get(op)
        if not win or not target:
            return 0.0
        vals = sorted(win)
        return vals[max(0, math.ceil(0.95 * len(vals)) - 1)] / target

    def slo_snapshot(self) -> dict:
        """Per-op SLO state for stats/fleet_top. An op with zero
        observations reports ``p95_ms: None`` — a cold server has no
        percentile, and null must never masquerade as a 0 ms p95."""
        slo = self.settings.slo_ms or {}
        out: dict[str, dict] = {}
        with self._slo_lock:
            for op, target in sorted(slo.items()):
                win = self._slo_windows.get(op)
                vals = sorted(win) if win else []
                p95 = (vals[max(0, math.ceil(0.95 * len(vals)) - 1)]
                       if vals else None)
                out[op] = {
                    "slo_ms": target,
                    "p95_ms": round(p95, 3) if p95 is not None else None,
                    "n": len(vals),
                    "burn": round(p95 / target, 4) if p95 is not None
                    else None,
                    "burning": op in self._slo_burning,
                }
        return out

    # --- lanes -------------------------------------------------

    def _lane_depths(self) -> tuple[int, int]:
        with self._lane_cond:
            return len(self._lanes["hot"]), len(self._lanes["cold"])

    def _brownout_locked(self) -> bool:
        # brownout: the hot lane is backlogged past half its limit —
        # sustained overload where the cold lane must shed first so hot
        # answers stay exact
        return len(self._lanes["hot"]) >= max(1, self._hot_limit // 2)

    def brownout(self) -> bool:
        with self._lane_cond:
            return self._brownout_locked()

    def _lane_limit_locked(self, lane: str) -> int:
        if lane == "hot":
            return self._hot_limit
        if self._brownout_locked():
            return max(1, self._cold_limit // 2)
        return self._cold_limit

    def _set_depth_gauges(self, hot: int, cold: int) -> None:
        reg = registry()
        reg.gauge("service.queue_depth").set(float(hot + cold))
        reg.gauge("service.queue_depth.hot").set(float(hot))
        reg.gauge("service.queue_depth.cold").set(float(cold))

    def _lane_put(self, lane: str, item: tuple) -> bool:
        """Bounded per-lane admission; False means the caller must shed
        typed ``overloaded`` (the cold limit halves under brownout)."""
        with self._lane_cond:
            if self._stopping:
                return False
            q = self._lanes[lane]
            if len(q) >= self._lane_limit_locked(lane):
                return False
            q.append(item)
            hot = len(self._lanes["hot"])
            cold = len(self._lanes["cold"])
            self._lane_cond.notify_all()
        self._set_depth_gauges(hot, cold)
        return True

    def _next_item(self, dedicated: bool):
        """Pull the next request for one worker. Dedicated workers serve
        only the hot lane (the reservation that keeps ColdBatcher floods
        out of the whole pool); shared workers prefer hot unless the
        cold head has waited >= cold_age_s — an aged cold item beats
        fresh hot work, so cold is delayed, never starved."""
        with self._lane_cond:
            while True:
                hot = self._lanes["hot"]
                cold = self._lanes["cold"]
                item = None
                if dedicated:
                    if hot:
                        item = hot.popleft()
                elif hot and cold:
                    aged = (trace.now_s() - cold[0][2]
                            >= self.settings.cold_age_s)
                    item = cold.popleft() if aged else hot.popleft()
                elif hot:
                    item = hot.popleft()
                elif cold:
                    item = cold.popleft()
                if item is not None:
                    h, c = len(hot), len(cold)
                    self._set_depth_gauges(h, c)
                    return item
                if self._stopping:
                    return None
                # timed wait: an aging cold head must be re-examined even
                # if no new put ever notifies
                self._lane_cond.wait(0.05)

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out.update(self.index.stats())
        hot, cold = self._lane_depths()
        out["queue_depth"] = hot + cold
        out["queue_depth_hot"] = hot
        out["queue_depth_cold"] = cold
        out["brownout"] = self.brownout()
        out["hot_workers_dedicated"] = self._dedicated_hot
        out["degraded"] = self.cold.degraded
        out["refreshes"] = self._refreshes
        out["refresh_failed"] = self._refresh_failed
        out["refresh_attempts"] = (
            self.follower.attempts if self.follower is not None else 0
        )
        out["snapshot_age_s"] = round(trace.now_s() - self._snapshot_ts, 3)
        out["draining"] = self._draining
        out["persist_cold"] = self._writer is not None
        # cold-plane identity: effective backend class, mesh
        # device count, last drain's chunk fanout — lock-free snapshot
        out.update(self.cold.describe())
        out["range_lo"] = self.base
        out["procs"] = self.settings.procs
        out["proc_index"] = self.settings.proc_index
        # store.stats() is in-memory only (no I/O, no flock) so it is
        # safe from the inline stats op on the wire loop
        out["store"] = self.store.stats() if self.store is not None else None
        out["slo"] = self.slo_snapshot()
        return out

    def _on_degraded(self, entering: bool, reason: str) -> None:
        self.metrics.event("service_degraded", entering=entering,
                           reason=reason)
        registry().gauge("service.degraded").set(1.0 if entering else 0.0)
        if entering and self.recorder is not None:
            # circuit breaker opened: the minutes before are exactly
            # what a postmortem needs — freeze them now
            self.recorder.trigger("breaker_open", reason=reason)

    def inject_chaos(self, spec: str) -> int:
        """Extend the live schedule (the ``chaos`` wire op / tests)."""
        ds = parse_chaos(spec)
        self.chaos.extend(ds)
        return len(ds)

    # --- wire event loop --------------------------------------

    def _wake(self) -> None:
        """Nudge the selector out of its wait (worker reply enqueued, a
        kill flagged, drain/stop). Safe from any thread."""
        w = self._wake_w
        if w is None:
            return
        try:
            w.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # pipe full or closed: the loop is waking anyway

    def _wire_loop(self) -> None:
        """The selector event loop: one thread owns every socket.

        Non-blocking reads stream through each connection's incremental
        :class:`FrameDecoder`, so any number of pipelined requests ride
        one socket and a peer dribbling a frame byte-by-byte costs one
        buffer append per tick, never a parked thread. Inline ops are
        answered right here (front-inserted into the write queue, ahead
        of any queued query replies); admitted queries flow through the
        unchanged lane/worker plane, whose replies come back via
        :meth:`_reply` + the wake pipe. Writes are flushed on
        write-readiness per connection — svc_slow_frame connections
        instead drain bytes-per-tick on a timer — so one slow consumer
        never head-of-line-blocks another connection's replies."""
        sel = selectors.DefaultSelector()
        listener = self._listener
        assert listener is not None and self._wake_r is not None
        listener.setblocking(False)
        sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        sel.register(listener, selectors.EVENT_READ, "accept")
        listener_live = True
        try:
            while not self._closing:
                if listener_live and self._draining:
                    listener_live = False
                    try:
                        sel.unregister(listener)
                        listener.close()
                    except (KeyError, ValueError, OSError):
                        pass
                timeout = self._refresh_interest(sel)
                for key, ev in sel.select(timeout):
                    if key.data == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    elif key.data == "accept":
                        listener_live = self._accept_ready(sel, listener)
                    else:
                        c = key.data
                        if ev & selectors.EVENT_READ and not c.closed:
                            self._read_ready(sel, c)
                        if ev & selectors.EVENT_WRITE and not c.closed:
                            if not self._flush(c):
                                self._close_conn(sel, c)
                self._tick_throttled(sel)
        finally:
            with self._conns_lock:
                conns = list(self._conns)
            for c in conns:
                self._close_conn(sel, c)
            if listener_live:
                try:
                    listener.close()
                except OSError:
                    pass
            for s in (self._wake_r, self._wake_w):
                if s is not None:
                    try:
                        s.close()
                    except OSError:
                        pass
            sel.close()

    def _refresh_interest(self, sel) -> float:
        """Reap killed conns, sync each conn's selector mask with its
        queue state, and pick the select timeout (a short tick while a
        throttled connection still has bytes to dribble)."""
        timeout = 0.2
        now = time.monotonic()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            if c.kill or c.closed:
                self._close_conn(sel, c)
                continue
            throttled = c.throttle_bps > 0
            with c.lock:
                pending = bool(c.wq)
            desired = selectors.EVENT_READ
            if pending and not throttled:
                desired |= selectors.EVENT_WRITE
            if desired != c.mask:
                try:
                    sel.modify(c.sock, desired, c)
                    c.mask = desired
                except (KeyError, ValueError, OSError):
                    self._close_conn(sel, c)
                    continue
            if throttled and pending:
                timeout = min(timeout, max(0.0, c.next_t - now))
        return timeout

    def _accept_ready(self, sel, listener) -> bool:
        """Drain the accept backlog; False retires the listener."""
        while True:
            try:
                sock, _ = listener.accept()
            except BlockingIOError:
                return True
            except OSError:
                # drain()/stop() shut the listener down
                try:
                    sel.unregister(listener)
                    listener.close()
                except (KeyError, ValueError, OSError):
                    pass
                return False
            sock.setblocking(False)
            try:
                # hot RPC path: a multi-segment reply must not sit in
                # the Nagle buffer waiting on the peer's delayed ACK
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass  # non-TCP transports (tests) have no such knob
            c = _Conn(sock)
            with self._conns_lock:
                self._conns.add(c)
            try:
                sel.register(sock, selectors.EVENT_READ, c)
                c.mask = selectors.EVENT_READ
            except (ValueError, OSError):
                self._close_conn(sel, c)

    def _read_ready(self, sel, c: _Conn) -> None:
        try:
            data = c.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(sel, c)
            return
        if not data:
            self._close_conn(sel, c)
            return
        try:
            msgs = c.decoder.feed(data)
        except ValueError:
            self._close_conn(sel, c)  # framing garbage: cut the peer off
            return
        for msg in msgs:
            if trace.now_s() < self._replica_down_until:
                self._close_conn(sel, c)  # replica_down: drop, no reply
                return
            if self._dispatch(c, msg) == "drop":
                self._close_conn(sel, c)
                return

    def _flush(self, c: _Conn, budget: int | None = None) -> bool:
        """Write queued frames to the socket until it would block, the
        queue empties, or the byte budget (throttled conns) runs out.
        False means the peer is gone and the conn must be closed.
        ``tx`` is held across the whole drain so the loop thread and a
        worker's direct send can never interleave bytes on the wire."""
        with c.tx:
            try:
                while True:
                    with c.lock:
                        if c.closed:
                            return False
                        if not c.wq:
                            return True
                        head = c.wq[0]
                        off = c.head_off
                        c.sending = True
                    # memoryview slices: resuming a partially-sent frame
                    # (and budget-capping a throttled one) must not copy
                    # the frame tail on every send() round
                    chunk = memoryview(head)[off:]
                    if budget is not None:
                        if budget <= 0:
                            return True
                        chunk = chunk[:budget]
                    try:
                        n = c.sock.send(chunk)
                    except (BlockingIOError, InterruptedError):
                        return True
                    except OSError:
                        return False
                    if budget is not None:
                        budget -= n
                    with c.lock:
                        if c.closed:
                            return False
                        c.head_off += n
                        c.wq_bytes -= n
                        if c.head_off >= len(head):
                            c.wq.popleft()
                            c.head_off = 0
            finally:
                with c.lock:
                    c.sending = False

    def _tick_throttled(self, sel) -> None:
        """svc_slow_frame drain: each throttled connection gets at most
        ``throttle_bps`` bytes per ``_TICK_S``, on its own clock."""
        now = time.monotonic()
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            if c.closed or c.throttle_bps <= 0 or now < c.next_t:
                continue
            if not c.pending():
                continue
            c.next_t = now + _TICK_S
            if not self._flush(c, budget=max(1, int(c.throttle_bps))):
                self._close_conn(sel, c)

    def _close_conn(self, sel, c: _Conn) -> None:
        with self._conns_lock:
            self._conns.discard(c)
        with c.lock:
            c.closed = True
            c.wq.clear()
            c.wq_bytes = 0
            c.head_off = 0
        try:
            sel.unregister(c.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            c.sock.close()
        except OSError:
            pass

    def _reply(self, c: _Conn, payload: dict, front: bool = False,
               cols: dict | None = None) -> None:
        """Enqueue one encoded reply frame on the connection's bounded
        write queue and wake the loop. ``front=True`` (inline ops) jumps
        ahead of queued query replies — but never into the middle of a
        partially-sent frame. Called from worker threads and from the
        loop itself; a closed conn swallows the reply (the outcome is
        already counted), and overflowing the queue kills the slow
        consumer rather than growing without bound.

        When the queue held nothing before this frame and the conn is
        unthrottled, the calling thread flushes the frame to the socket
        directly instead of waking the loop — on a busy box the
        wake-byte + selector-thread context switch costs more than the
        reply itself, and an idle-queue conn has no in-flight partial
        frame a direct send could interleave with (``tx`` guarantees
        it even against a racing loop flush).

        ``cols`` ships the payload as a v2 columnar frame —
        callers pass it only on connections that negotiated v2."""
        frame = encode_msg_v2(payload, cols) if cols else encode_msg(payload)
        overflow = False
        direct = False
        queued = 0
        with c.lock:
            if c.closed or c.kill:
                return
            if c.wq_bytes + len(frame) > self.settings.write_queue_bytes:
                c.kill = True
                overflow = True
                queued = c.wq_bytes
            else:
                if front:
                    busy_head = (c.head_off > 0 or c.sending) and c.wq
                    c.wq.insert(1 if busy_head else 0, frame)
                else:
                    c.wq.append(frame)
                c.wq_bytes += len(frame)
                direct = (len(c.wq) == 1 and c.head_off == 0
                          and c.throttle_bps <= 0)
        if overflow:
            self._bump("slow_consumer_closed")
            self.metrics.event("service_slow_consumer", quietable=True,
                               queued_bytes=queued,
                               limit=self.settings.write_queue_bytes)
            self._wake()
            return
        if direct:
            if not self._flush(c):
                with c.lock:
                    c.kill = True  # peer gone; the loop reaps it
            elif not c.pending():
                return  # fully on the wire: the loop has nothing to do
        self._wake()

    def _dispatch(self, conn: _Conn, msg: dict) -> str | None:
        mtype = msg.get("type")
        rid = msg.get("id")
        idx = self.index  # one snapshot per message, even for health
        if mtype == "health":
            # answered inline by the event loop, front-inserted AHEAD of
            # queued query replies: health must stay observable under
            # full-queue shed pressure and a dead backend alike
            hot, cold = self._lane_depths()
            self._reply(conn, {
                "type": "health", "id": rid, "ok": True,
                "status": "degraded" if self.cold.degraded else "ok",
                "covered_hi": idx.covered_hi,
                "total_primes": idx.total_primes,
                "queue_depth": hot + cold,
                "queue_depth_hot": hot,
                "queue_depth_cold": cold,
                "brownout": self.brownout(),
                "snapshot_age_s": round(
                    trace.now_s() - self._snapshot_ts, 3
                ),
                "refreshes": self._refreshes,
                "draining": self._draining,
                "range_lo": self.base,
                "proc": self.settings.proc_index,
                # health() is the store's cheap in-memory subset — safe
                # inline on the wire loop, unlike the blocking store ops
                "store": (self.store.health()
                          if self.store is not None else None),
                # cold-plane identity — describe() is
                # lock-free, so inline on the wire loop is safe
                **self.cold.describe(),
            }, front=True)
            return None
        if mtype == "stats":
            self._reply(conn,
                        {"type": "stats", "id": rid, "ok": True,
                         "stats": self.stats()}, front=True)
            return None
        if mtype == "hello":
            # wire-version negotiation: intersect the peer's
            # advertised versions with ours, highest mutual wins, v1
            # JSON is the floor. Answered inline BEFORE any pipelined
            # query reply, so the client knows the encoding of
            # everything that follows. Decoding is capability-based
            # (frames are self-describing) — negotiation only governs
            # what each side sends.
            try:
                peer = {int(v) for v in (msg.get("wire") or ())
                        if not isinstance(v, bool)}
            except (TypeError, ValueError):
                peer = set()
            mine = set(SUPPORTED_WIRE) if self.settings.wire_v2 \
                else {WIRE_V1}
            mutual = peer & mine
            conn.wire_v = max(mutual) if mutual else WIRE_V1
            if conn.wire_v >= WIRE_V2:
                self._bump("wire_v2_conns")
            self._reply(conn, {"type": "hello", "id": rid, "ok": True,
                               "wire": conn.wire_v,
                               "versions": sorted(mine)}, front=True)
            return None
        if mtype == "shutdown":
            # rolling-restart control message: same path as SIGTERM
            self._reply(conn,
                        {"type": "reply", "id": rid, "ok": True,
                         "draining": True}, front=True)
            self.drain()
            return None
        if mtype == "metrics":
            # live telemetry plane: the full registry
            # snapshot, answered inline like health — the fleet poller
            # must see a wedged server's counters, not time out behind
            # its queue
            self._reply(conn, {
                "type": "metrics", "id": rid, "ok": True,
                "role": "service", "metrics": registry().snapshot(),
            }, front=True)
            return None
        if mtype == "debug":
            # flight-recorder freeze: answered inline by the
            # event loop like metrics, so a wedged worker pool still
            # dumps its black box (no disk write, no throttle)
            self._reply(conn, {
                "type": "debug", "id": rid, "ok": True, "role": "service",
                "bundle": (self.recorder.snapshot("manual")
                           if self.recorder is not None else None),
            }, front=True)
            return None
        if mtype == "profile":
            # continuous-profiler pull: collapsed-stack table,
            # inline from the event loop like debug — a wedged worker
            # pool still profiles. svc_prof_gap chaos drops the K-th
            # reply (puller times out, never sees a malformed frame) and
            # pauses the sampler one beat.
            self._prof_pulls += 1
            gap = bool(self.chaos.take_kinds(0, self._prof_pulls,
                                             PROFILE_KINDS))
            snap = (self.profiler.snapshot()
                    if self.profiler is not None else None)
            self.metrics.event(
                "profile_pulled", quietable=True, role="service",
                samples=(snap or {}).get("samples"),
                stacks=len((snap or {}).get("stacks") or ()), gap=gap,
            )
            if gap:
                self._bump("profile_gaps")
                if self.profiler is not None:
                    self.profiler.pause(1)
                return None
            self._bump("profile_pulls")
            self._reply(conn, {
                "type": "profile", "id": rid, "ok": True,
                "role": "service", "profile": snap,
            }, front=True)
            return None
        if mtype == "exemplars":
            # tail-sampled exemplar pull: the kept-exemplar
            # ring, inline from the event loop (in-memory only — the
            # rolling file is the sampler's own concern). ``ctx`` prefix
            # filter is how the router fetches the downstream exemplars
            # of one slow route.
            ctx_f = msg.get("ctx")
            n_f = msg.get("n")
            self._reply(conn, {
                "type": "exemplars", "id": rid, "ok": True,
                "role": "service",
                "exemplars": (self.exemplar.tail(
                    n=n_f if isinstance(n_f, int) else None,
                    ctx_prefix=ctx_f if isinstance(ctx_f, str) else None,
                ) if self.exemplar is not None else []),
            }, front=True)
            return None
        if mtype == "telemetry":
            # explicit ring flush: the router pulls this from every
            # replica when its trace closes, collecting whatever the
            # batched piggyback has not shipped yet. Echoes the clock
            # stamps so the flush itself feeds the caller's aligner.
            reply: dict[str, Any] = {"type": "telemetry", "id": rid,
                                     "ok": True}
            if msg.get("t_send") is not None:
                reply["t_recv"] = round(trace.now_s(), 6)
            if self._telemetry_on:
                events, dropped = trace.drain_events()
                reply["telemetry"] = {"events": events, "dropped": dropped}
                self._bump("telemetry_replies")
            if msg.get("t_send") is not None:
                reply["t_sent"] = round(trace.now_s(), 6)
            self._reply(conn, reply, front=True)
            return None
        if mtype == "chaos":
            if not self.settings.wire_chaos:
                # refusal is typed AND evented: a production server must
                # record who tried to fault-inject it over the wire
                self.metrics.event("service_chaos_refused",
                                   spec=str(msg.get("spec", "")))
                self._reply(conn, {
                    "type": "reply", "id": rid, "ok": False,
                    "error": "bad_request",
                    "detail": "wire chaos injection is disabled on this "
                              "server (start it with --allow-chaos)",
                }, front=True)
                return None
            try:
                n = self.inject_chaos(str(msg.get("spec", "")))
            except ValueError as e:
                self._reply(conn,
                            {"type": "reply", "id": rid, "ok": False,
                             "error": "bad_request", "detail": str(e)},
                            front=True)
                return None
            self._reply(conn,
                        {"type": "reply", "id": rid, "ok": True,
                         "injected": n}, front=True)
            return None
        if mtype != "query":
            self._reply(conn,
                        {"type": "reply", "id": rid, "ok": False,
                         "error": "bad_request",
                         "detail": f"unknown message type {mtype!r}"})
            return None
        dl = msg.get("deadline_s")
        if dl is not None and (
            not isinstance(dl, (int, float)) or isinstance(dl, bool)
            or dl <= 0 or not math.isfinite(dl)
        ):
            # a malformed deadline is the CLIENT's bug: reply typed
            # bad_request instead of manufacturing an already-expired
            # deadline and calling it deadline_exceeded
            self._bump("bad_requests")
            self._reply(conn, {
                "type": "reply", "id": rid, "ok": False,
                "op": str(msg.get("op", "")), "error": "bad_request",
                "detail": f"deadline_s must be a positive number, "
                          f"got {dl!r}",
            })
            return None
        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        directives = self.chaos.take_kinds(0, seq, SERVICE_REQUEST_KINDS)
        op = str(msg.get("op", ""))
        for d in directives:
            if d["kind"] == "replica_down":
                self._replica_down_until = max(
                    self._replica_down_until,
                    trace.now_s() + float(d["param"] or 0.0),
                )
                return "drop"  # dead replica: no reply, connection cut
            if d["kind"] == "svc_drain":
                self.drain()
            if d["kind"] == "svc_slow_frame":
                # from this request on, replies to THIS connection are
                # dribbled at param bytes per event-loop tick; other
                # connections must stay at full speed (gated by test)
                conn.throttle_bps = max(1.0, float(d["param"] or 1.0))
                self.metrics.event("service_slow_frame", quietable=True,
                                   bytes_per_tick=conn.throttle_bps)
        if any(d["kind"] == "svc_shed" for d in directives):
            self._shed(conn, rid, op, forced=True, ctx=msg.get("ctx"))
            return None
        flood = next(
            (d for d in directives if d["kind"] == "svc_flood"), None
        )
        if flood is not None:
            # svc_flood:any@sK:<lane> — request K is refused as if the
            # named lane were at capacity: the deterministic injection of
            # the lane-shed surface (reply lane field, service_lane_shed
            # event, ReplicaSet failover) without a real 20-thread flood
            self._shed(conn, rid, op, forced=True,
                       lane=str(flood["param"] or "cold"),
                       chaos_kind="svc_flood", ctx=msg.get("ctx"))
            return None
        if self._draining:
            hot, cold = self._lane_depths()
            self._bump("draining_replies")
            self.metrics.event("service_shed", quietable=True, op=op,
                               queue_depth=hot + cold,
                               reason="draining")
            self._reply(conn, {
                "type": "reply", "id": rid, "ok": False, "op": op,
                "error": "draining",
                "detail": "server is draining (rolling restart); retry "
                          "on another replica",
            })
            return None
        lane = self._classify(msg, idx)
        item = (msg, rid if rid is not None else seq, trace.now_s(),
                directives, idx, conn, lane, False)
        with self._inflight_lock:
            self._inflight_n += 1
        if not self._lane_put(lane, item):
            with self._inflight_lock:
                self._inflight_n -= 1
            self._shed(conn, rid, op, forced=False, lane=lane,
                       ctx=msg.get("ctx"))
            return None
        self._bump(f"{lane}_admitted")
        return None

    def _shed(self, conn: _Conn, rid, op: str, forced: bool,
              lane: str | None = None, chaos_kind: str = "svc_shed",
              ctx: Any = None) -> None:
        hot, cold = self._lane_depths()
        depth = hot + cold
        self._bump("shed")
        self.metrics.event("service_shed", quietable=True, op=op,
                           queue_depth=depth)
        if lane is not None:
            self._bump(f"lane_shed_{lane}")
            self.metrics.event(
                "service_lane_shed", quietable=True, op=op, lane=lane,
                queue_depth=hot if lane == "hot" else cold,
            )
        if forced and lane is not None:
            detail = (f"shed by injected {chaos_kind} fault "
                      f"({lane} lane at capacity)")
        elif forced:
            detail = "shed by injected svc_shed fault"
        else:
            with self._lane_cond:
                limit = self._lane_limit_locked(lane)
            d = hot if lane == "hot" else cold
            detail = f"admission queue full: {lane} lane ({d}/{limit})"
            if lane == "cold" and limit < self._cold_limit:
                detail += " [brownout: cold limit halved]"
        reply = {
            "type": "reply", "id": rid, "ok": False, "op": op,
            "error": "overloaded", "detail": detail,
        }
        if lane is not None:
            reply["lane"] = lane
        # a shed never ran, so there is no span tree — but the typed
        # outcome is still exemplar-kept, so the file records
        # every refused request alongside the slow ones
        if self.exemplar is not None:
            self._bump("exemplars_seen")
            reason = self.exemplar.decide("overloaded", 0.0)
            if reason is not None:
                self._bump("exemplars_kept")
                self.exemplar.keep({
                    "ctx": ctx if isinstance(ctx, str) and ctx else None,
                    "op": op, "outcome": "overloaded", "ms": 0.0,
                    "lane": lane, "reason": reason, "spans": [],
                })
        self._reply(conn, reply)

    # --- request handling ------------------------------------------------

    def _classify(self, msg: dict, idx: SieveIndex) -> str:
        """Lane classification at enqueue: **hot** iff the
        query is fully answerable from SieveIndex + the caches — hi
        within covered_hi (every slice is index-materializable), or
        every grid chunk past covered already sitting in the cold
        cache. Anything that may need a backend dispatch is **cold**.
        Malformed queries classify hot: a typed bad_request is cheap
        and must never queue behind a cold flood."""
        op = msg.get("op")
        try:
            if op == "pi":
                return self._lane_for_prefixes([int(msg["x"]) + 1], idx)
            if op == "is_prime":
                x = int(msg["x"])
                return self._lane_for_prefixes([x, x + 1], idx)
            if op == "count":
                lo, hi = int(msg["lo"]), int(msg["hi"])
                if hi < lo or hi > MAX_HI:
                    return "hot"  # typed bad_request
                if str(msg.get("kind", "primes")) == "primes":
                    return self._lane_for_prefixes([lo, hi], idx)
                # pair kinds enumerate: hot only within the index
                return "hot" if hi <= idx.covered_hi else "cold"
            if op == "nth_prime":
                return ("hot" if int(msg["k"]) <= idx.total_primes
                        else "cold")
            if op == "primes":
                lo, hi = int(msg["lo"]), int(msg["hi"])
                if hi < lo or hi > MAX_HI:
                    return "hot"
                return "hot" if hi <= idx.covered_hi else "cold"
            if op == "batch":
                if "b_op" in msg:
                    # columnar batch: one vectorized bound
                    # check instead of a member loop. The max over both
                    # argument columns (+1 for the pi/is_prime prefix)
                    # over-approximates every needed prefix; anything
                    # malformed classifies hot (typed bad_request).
                    b_a, b_b = msg.get("b_a"), msg.get("b_b")
                    try:
                        if b_a.size == 0:
                            return "hot"
                        top = max(int(b_a.max()) + 1, int(b_b.max()))
                    except (AttributeError, TypeError, ValueError):
                        return "hot"
                    return self._lane_for_prefixes([top], idx)
                items = msg.get("items")
                if (not isinstance(items, list) or not items
                        or len(items) > self.settings.batch_queries):
                    return "hot"  # whole-batch typed bad_request
                vs: list[int] = []
                for m in items:
                    if not isinstance(m, dict):
                        continue  # per-member typed bad_request, cheap
                    try:
                        mop = m.get("op")
                        if mop == "pi":
                            vs.append(int(m["x"]) + 1)
                        elif mop == "is_prime":
                            x = int(m["x"])
                            vs.extend((x, x + 1))
                        elif mop == "count":
                            vs.extend((int(m["lo"]), int(m["hi"])))
                    except (KeyError, TypeError, ValueError):
                        continue
                return self._lane_for_prefixes(vs, idx) if vs else "hot"
        except (KeyError, TypeError, ValueError):
            return "hot"  # malformed → typed bad_request, cheap
        return "hot"  # unknown op → typed bad_request

    def _lane_for_prefixes(self, vs: list[int], idx: SieveIndex) -> str:
        keys: set[tuple[int, int]] = set()
        for v in vs:
            if v > MAX_HI:
                return "hot"  # typed bad_request
            keys.update(self._grid_chunks(min(v, idx.covered_hi), v))
        if not keys:
            return "hot"
        if len(keys) > 32:
            return "cold"  # too many chunks to probe the cache for
        with self._cold_lock:
            return ("hot" if all(k in self._cold_cache for k in keys)
                    else "cold")

    def _grid_chunks(self, covered: int, v: int) -> list[tuple[int, int]]:
        """The cold chunk list [covered, v) on the fixed grid — shared
        by classification and _count_upto so they can never disagree."""
        chunks: list[tuple[int, int]] = []
        a = covered
        while a < v:
            b = min(_grid_next(a, self.settings.cold_chunk), v)
            chunks.append((a, b))
            a = b
        return chunks

    def _worker_loop(self, dedicated: bool = False) -> None:
        while True:
            item = self._next_item(dedicated)
            if item is None:
                return
            try:
                self._handle(*item)
            except ChaosCrash:
                raise  # svc_crash drill: this worker thread must die
            except Exception:
                pass  # _handle replies "internal" itself; never die

    def _requeue_cold(self, msg, rid, enq_t, idx, conn) -> bool:
        """Demotion: re-enqueue a misclassified hot request on
        the cold lane. The original enq_t rides along, so its deadline
        keeps draining and cold-lane aging sees its true wait."""
        item = (msg, rid, enq_t, (), idx, conn, "cold", True)
        return self._lane_put("cold", item)

    def _handle(self, msg, rid, enq_t, directives, idx,
                conn: _Conn, lane: str = "cold",
                demoted: bool = False) -> None:
        # ``idx`` is the snapshot captured at admission: the whole request
        # runs on it even if the follower swaps self.index mid-flight
        op = str(msg.get("op", ""))
        # trace ctx: echo the caller's context into every span
        # this request produces, so the router/report can correlate them
        tctx = msg.get("ctx")
        tkw = {"ctx": tctx} if isinstance(tctx, str) and tctx else {}
        t_pop = trace.now_s()
        trace.add_span("query.queue_wait", enq_t, t_pop - enq_t, op=op,
                       lane=lane, **tkw)
        registry().histogram(f"service.queue_wait_ms.{lane}").observe(
            (t_pop - enq_t) * 1000.0
        )
        deadline = enq_t + float(
            msg.get("deadline_s") or self.settings.default_deadline_s
        )
        ctx = QueryCtx()
        ctx.lane = lane

        def check() -> None:
            if trace.now_s() > deadline:
                raise DeadlineExceeded(ctx.answered_hi, ctx.count_so_far)

        ctx.check = check
        if not demoted:  # a demoted re-run is the SAME request
            self._bump("requests")
        outcome = "ok"
        reply: dict = {"type": "reply", "id": rid, "ok": True, "op": op}
        try:
            for d in directives:
                if d["kind"] == "svc_stall":
                    time.sleep(float(d["param"] or 0.0))
                elif d["kind"] == "backend_down":
                    self.cold.force_down(float(d["param"] or 0.0),
                                         "chaos backend_down")
                elif d["kind"] == "svc_crash":
                    raise ChaosCrash(
                        f"chaos svc_crash: worker killed mid-{op or 'query'}"
                    )
            check()
            reply["value"] = self._execute(op, msg, ctx, deadline, idx)
        except _Demoted as e:
            if self._requeue_cold(msg, rid, enq_t, idx, conn):
                self._bump("demoted")
                self.metrics.event("service_demoted", quietable=True,
                                   op=op, chunks=e.chunks)
                # no reply, no inflight decrement: the cold re-run of
                # this same request owns both now
                return
            # cold lane refused the demotion: typed lane shed
            outcome = "overloaded"
            _h, c = self._lane_depths()
            self._bump("shed")
            self._bump("lane_shed_cold")
            self.metrics.event("service_lane_shed", quietable=True, op=op,
                               lane="cold", queue_depth=c)
            reply = {
                "type": "reply", "id": rid, "ok": False, "op": op,
                "error": "overloaded", "lane": "cold",
                "detail": "cold lane full while demoting a misclassified "
                          "hot query; retry",
                "partial": None,
            }
        except ChaosCrash:
            # svc_crash drill: this request will never reply, so settle
            # its drain accounting here, then let the exception escape
            # both catch-all nets — the worker thread must genuinely die
            # so threading.excepthook (the recorder's crash hook) fires
            with self._inflight_lock:
                self._inflight_n -= 1
            self._maybe_drained()
            raise
        except tuple(_ERROR_KIND) as e:
            outcome = _ERROR_KIND[type(e)]
            reply = {
                "type": "reply", "id": rid, "ok": False, "op": op,
                "error": outcome, "detail": str(e),
                "partial": self._partial(op, e),
            }
        except Exception as e:  # noqa: BLE001 — server must not die
            outcome = "internal"
            reply = {
                "type": "reply", "id": rid, "ok": False, "op": op,
                "error": "internal", "detail": f"{type(e).__name__}: {e}",
                "partial": None,
            }
        t_end = trace.now_s()
        source = ctx.source()
        reply.setdefault("source", source)
        reply["elapsed_ms"] = round((t_end - enq_t) * 1000, 3)
        trace.add_span("rpc.query", enq_t, t_end - enq_t, op=op,
                       outcome=outcome, source=source, lane=lane, **tkw)
        self._observe_slo(op, reply["elapsed_ms"])
        # tail-sampled exemplar: now that the outcome is
        # known, decide whether this request's span tree is kept. The
        # rpc.query span above is already in the tracer's exemplar ring.
        if self.exemplar is not None:
            self._bump("exemplars_seen")
            reason = self.exemplar.decide(
                outcome, reply["elapsed_ms"], flagged=demoted,
            )
            if reason is not None:
                self._bump("exemplars_kept")
                self.exemplar.keep({
                    "ctx": tctx if tkw else None,
                    "op": op,
                    "outcome": outcome,
                    "ms": reply["elapsed_ms"],
                    "lane": lane,
                    "reason": reason,
                    "spans": (trace.exemplar_collect(tctx)
                              if tkw else []),
                })
        # counters/events before the reply: a stats call racing the
        # reply must already see this request accounted for
        if outcome == "ok" and not ctx.cold and not ctx.materialized:
            self._bump("index_hits")
        elif outcome == "deadline_exceeded":
            self._bump("deadline_exceeded")
        elif outcome == "degraded":
            self._bump("degraded_replies")
        elif outcome == "bad_request":
            self._bump("bad_requests")
        elif outcome == "internal":
            self._bump("internal_errors")
        self.metrics.event(
            "service_request", quietable=True, op=op, outcome=outcome,
            source=source, ms=reply["elapsed_ms"],
        )
        # telemetry piggyback: echo receive/send timestamps
        # for the caller's clock aligner, and — when asked and armed —
        # drain the bounded span ring onto this reply (the rpc.query
        # span above is already in it). Batched: only ship once
        # telemetry_batch events are pending, so the hot path is not
        # paying a serialize per reply; the ``telemetry`` wire op
        # flushes the remainder when the caller's trace closes.
        # svc_trace_drop ships an explicit null payload: telemetry
        # lost (the pending ring is discarded, not deferred), query
        # result untouched.
        if msg.get("t_send") is not None:
            reply["t_recv"] = round(enq_t, 6)
        if msg.get("telemetry"):
            if any(d["kind"] == "svc_trace_drop" for d in directives):
                trace.drain_events()
                reply["telemetry"] = None
                self._bump("trace_drops")
                self.metrics.event("service_trace_drop", quietable=True,
                                   op=op)
            elif (self._telemetry_on and trace.pending_events()
                    >= self.settings.telemetry_batch):
                events, dropped = trace.drain_events()
                reply["telemetry"] = {"events": events, "dropped": dropped}
                self._bump("telemetry_replies")
        if msg.get("t_send") is not None:
            reply["t_sent"] = round(trace.now_s(), 6)
        # reply finalization: array-shaped values become v2
        # columns on a negotiated connection, or plain JSON lists on v1
        # — the op handlers above never branch on the wire version
        cols = None
        val = reply.get("value")
        if isinstance(val, BatchOutcomes):
            if conn.wire_v >= WIRE_V2:
                del reply["value"]
                extra, cols = val.wire()
                reply.update(extra)
            else:
                reply["value"] = val.to_items()
        elif isinstance(val, np.ndarray):
            if conn.wire_v >= WIRE_V2:
                del reply["value"]
                extra, cols = primes_to_cols(val, self.config.packing,
                                             int(msg.get("lo", 0)),
                                             int(msg.get("hi", 0)))
                reply.update(extra)
            else:
                reply["value"] = val.tolist()
        try:
            self._reply(conn, reply, cols=cols)
        finally:
            # drain accounting: this admitted query is now answered
            with self._inflight_lock:
                self._inflight_n -= 1
            self._maybe_drained()

    @staticmethod
    def _partial(op: str, e: Exception) -> dict | None:
        if not isinstance(e, DeadlineExceeded):
            return None
        if op == "pi":
            return {"answered_hi": e.answered_hi, "pi_so_far": e.count_so_far}
        if op == "nth_prime":
            return {"searched_hi": e.answered_hi,
                    "count_so_far": e.count_so_far}
        return {"answered_hi": e.answered_hi, "count_so_far": e.count_so_far}

    # --- ops -------------------------------------------------------------

    def _execute(self, op: str, msg: dict, ctx: QueryCtx, deadline: float,
                 idx: SieveIndex):
        if op == "pi":
            if self.base > 2:
                # a shard-local prefix count is NOT pi: refusing here is
                # what lets the router compose exact global answers
                raise BadRequest(
                    f"pi is a global-prefix op; this server serves "
                    f"[{self.base}, ...) — use count(lo, hi) or query "
                    "the router"
                )
            x = _req_int(msg, "x")
            if x < 0 or x + 1 > MAX_HI:
                raise BadRequest(f"pi({x}): x must be in [0, {MAX_HI})")
            return self._count_upto(x + 1, ctx, deadline, idx)
        if op == "is_prime":
            x = _req_int(msg, "x")
            if x + 1 > MAX_HI:
                raise BadRequest(f"is_prime({x}): x must be < {MAX_HI}")
            if x < 2:
                return False
            self._check_base(op, x)
            lo_c = self._count_upto(x, ctx, deadline, idx)
            return self._count_upto(x + 1, ctx, deadline, idx) - lo_c > 0
        if op == "count":
            lo, hi = _req_int(msg, "lo"), _req_int(msg, "hi")
            if hi > lo:
                self._check_base(op, lo)
            kind = str(msg.get("kind", "primes"))
            return self._count(lo, hi, kind, ctx, deadline, idx)
        if op == "nth_prime":
            return self._nth_prime(_req_int(msg, "k"), ctx, deadline, idx)
        if op == "primes":
            lo, hi = _req_int(msg, "lo"), _req_int(msg, "hi")
            if hi > lo:
                self._check_base(op, lo)
            return self._primes(lo, hi, ctx, deadline, idx)
        if op == "batch":
            if "b_op" in msg:
                return self._execute_batch_cols(msg, ctx, deadline, idx)
            return self._execute_batch(msg, ctx, deadline, idx)
        raise BadRequest(
            f"unknown op {op!r} (one of pi, is_prime, count, nth_prime, "
            "primes, batch)"
        )

    def _execute_batch_cols(self, msg: dict, ctx: QueryCtx, deadline: float,
                            idx: SieveIndex) -> BatchOutcomes:
        """Columnar batch fast path: validate and answer M
        members with pure array ops — zero per-member Python objects.

        The request arrives as ``b_op``/``b_a``/``b_b`` columns (see
        :func:`sieve.rpc.batch_items_to_cols`). When every member is
        well-formed and every needed prefix is inside the index, the
        whole batch is: dedup -> one ``count_upto_batch`` row -> three
        masked gathers. ANY deviation — unknown opcode, bound
        violation, shard-base issue, a cold value — rebuilds the member
        dicts and delegates to :meth:`_execute_batch`, which owns the
        typed per-member outcome semantics (and ``_Demoted``); the fast
        path never re-implements an error message."""
        b_op, b_a, b_b = msg.get("b_op"), msg.get("b_a"), msg.get("b_b")
        if (not isinstance(b_op, np.ndarray) or not isinstance(b_a, np.ndarray)
                or not isinstance(b_b, np.ndarray)
                or not (b_op.size == b_a.size == b_b.size)):
            raise BadRequest("batch: malformed column payload")
        m = int(b_op.size)
        if m == 0:
            raise BadRequest("batch: items must be a non-empty list")
        if m > self.settings.batch_queries:
            raise BadRequest(
                f"batch: {m} members exceed "
                f"batch_queries={self.settings.batch_queries}"
            )
        ops = b_op.astype(np.int64)
        a = b_a.astype(np.int64)
        b = b_b.astype(np.int64)
        pi_m = ops == 0
        ip_m = ops == 1
        ct_m = ops == 2
        fast = bool(
            (pi_m | ip_m | ct_m).all()
            and not (pi_m.any() and self.base > 2)
            and not (a[pi_m] < 0).any()
            # spelled >= MAX_HI (not +1 > MAX_HI): x+1 on an int64 max
            # would wrap negative and sneak past the guard
            and not (a[pi_m | ip_m] >= MAX_HI).any()
            and not (b[ct_m] > MAX_HI).any()
            and not (b[ct_m] < a[ct_m]).any()
        )
        if fast and self.base > 2:
            # shard server: scalar paths typed-reject members below the
            # shard base (is_prime keeps the x<2 -> False carve-out)
            if ((ip_m & (a >= 2) & (a < self.base))
                    | (ct_m & (b > a) & (a < self.base))).any():
                fast = False
        if fast:
            needed = np.concatenate(
                (a[pi_m] + 1, a[ip_m], a[ip_m] + 1, a[ct_m], b[ct_m])
            )
            if needed.size and int(needed.max()) > idx.covered_hi:
                fast = False  # a cold prefix: the member loop owns it
        if not fast:
            sub = dict(msg)
            sub["items"] = batch_cols_to_items(b_op, b_a, b_b)
            return BatchOutcomes.from_items(
                self._execute_batch(sub, ctx, deadline, idx)
            )
        self._bump("batch_requests")
        self._bump("batch_members", m)
        uniq = np.unique(needed)
        resolved = np.zeros(uniq.size, dtype=np.int64)
        hot = uniq > self.base  # <= base resolves to 0 by definition
        if hot.any():
            resolved[hot] = idx.count_upto_batch(uniq[hot], ctx)

        def pref(vs: np.ndarray) -> np.ndarray:
            return resolved[np.searchsorted(uniq, vs)]

        val = np.zeros(m, dtype=np.int64)
        val[pi_m] = pref(a[pi_m] + 1)
        val[ip_m] = pref(a[ip_m] + 1) - pref(a[ip_m]) > 0
        val[ct_m] = pref(b[ct_m]) - pref(a[ct_m])
        return BatchOutcomes(np.ones(m, dtype=np.uint8), val, {}, b_op)

    def _execute_batch(self, msg: dict, ctx: QueryCtx, deadline: float,
                       idx: SieveIndex) -> list[dict]:
        """Vectorized batch op: M prefix/interval/is_prime
        members answered as per-member typed outcomes.

        Every member decomposes into prefix counts P(v) = primes in
        [base, v): pi(x) = P(x+1), count(lo,hi) = P(hi) - P(lo),
        is_prime(x) = P(x+1) - P(x) > 0. The distinct v's are deduped,
        every hot one (≤ covered_hi) is answered by ONE
        ``np.searchsorted`` row over the index prefix
        (:meth:`SieveIndex.count_upto_batch`), and cold ones walk the
        existing scalar path — ascending, so the ColdBatcher coalesces
        their chunk flights — each catching its typed fault
        individually. A member whose values all resolved replies
        ``{"ok": True, "value": ...}``; one touching a faulted value
        replies ``{"ok": False, "error": <kind>, ...}`` (deadline
        members carry the prefix partial). Malformed members are typed
        per-member; a malformed items container or an oversized batch
        is a whole-batch bad_request. ``_Demoted`` propagates whole-
        batch so the standard demotion path re-runs it on the cold
        lane."""
        items = msg.get("items")
        if not isinstance(items, list) or not items:
            raise BadRequest("batch: items must be a non-empty list")
        if len(items) > self.settings.batch_queries:
            raise BadRequest(
                f"batch: {len(items)} members exceed "
                f"batch_queries={self.settings.batch_queries}"
            )
        self._bump("batch_requests")
        self._bump("batch_members", len(items))
        # plan each member: ("err", outcome) | (mop, needed_vals, finish)
        plans: list[tuple] = []
        needed: set[int] = set()
        for m in items:
            mop = str(m.get("op", "")) if isinstance(m, dict) else ""
            try:
                if not isinstance(m, dict):
                    raise BadRequest("batch member must be an object")
                if mop == "pi":
                    if self.base > 2:
                        raise BadRequest(
                            f"pi is a global-prefix op; this server "
                            f"serves [{self.base}, ...) — use "
                            "count(lo, hi) or query the router"
                        )
                    x = _req_int(m, "x")
                    if x < 0 or x + 1 > MAX_HI:
                        raise BadRequest(
                            f"pi({x}): x must be in [0, {MAX_HI})"
                        )
                    plans.append((mop, (x + 1,), lambda p: p[0]))
                elif mop == "is_prime":
                    x = _req_int(m, "x")
                    if x + 1 > MAX_HI:
                        raise BadRequest(
                            f"is_prime({x}): x must be < {MAX_HI}"
                        )
                    if x < 2:
                        plans.append((mop, (), lambda p: False))
                        continue
                    self._check_base(mop, x)
                    plans.append(
                        (mop, (x, x + 1), lambda p: p[1] - p[0] > 0)
                    )
                elif mop == "count":
                    lo, hi = _req_int(m, "lo"), _req_int(m, "hi")
                    if hi > MAX_HI:
                        raise BadRequest(f"count: hi={hi} exceeds {MAX_HI}")
                    if hi < lo:
                        raise BadRequest(f"count: hi={hi} < lo={lo}")
                    if str(m.get("kind", "primes")) != "primes":
                        raise BadRequest(
                            "batch count members support kind=primes only"
                        )
                    if hi > lo:
                        self._check_base(mop, lo)
                    plans.append((mop, (lo, hi), lambda p: p[1] - p[0]))
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
                continue
            needed.update(plans[-1][1])
        # resolve the deduped prefix values: one vectorized gather for
        # the hot set, then the cold tail ascending
        res: dict[int, int] = {}
        faults: dict[int, dict] = {}
        hot = sorted(v for v in needed
                     if self.base < v <= idx.covered_hi)
        for v in needed:
            if v <= self.base:
                res[v] = 0
        if hot:
            counts = idx.count_upto_batch(hot, ctx)
            for v, c in zip(hot, counts):
                res[v] = int(c)
        for v in sorted(v for v in needed if v > idx.covered_hi):
            try:
                res[v] = self._count_upto(v, ctx, deadline, idx)
            except _Demoted:
                raise  # whole batch re-runs on the cold lane
            except tuple(_ERROR_KIND) as e:
                fault = {"error": _ERROR_KIND[type(e)], "detail": str(e),
                         "partial": None}
                if isinstance(e, DeadlineExceeded):
                    fault["partial"] = {"answered_hi": e.answered_hi,
                                       "count_so_far": e.count_so_far}
                faults[v] = fault
        out: list[dict] = []
        for plan in plans:
            if plan[0] == "err":
                out.append(plan[1])
                continue
            mop, vals, finish = plan
            bad = next((v for v in vals if v in faults), None)
            if bad is not None:
                out.append({"ok": False, "op": mop, **faults[bad]})
            else:
                out.append({"ok": True, "op": mop,
                            "value": finish([res[v] for v in vals])})
        return out

    def _check_base(self, op: str, lo: int) -> None:
        """Range-sharded servers reject queries below their shard."""
        if self.base > 2 and lo < self.base:
            raise BadRequest(
                f"{op}: lo={lo} below this server's range "
                f"[{self.base}, ...) (range_lo={self.base})"
            )

    def _count_upto(self, v: int, ctx: QueryCtx, deadline: float,
                    idx: SieveIndex) -> int:
        """Primes in [base, v): index prefix + cold chunks past covered_hi
        (base is 2 on a whole-range server, range_lo on a shard).

        The WHOLE cold chunk list is computed up front and submitted to
        the batcher in one go — a request spanning K chunks
        registers all K flights before the first wait, so one queue
        drain sees them together and one backend dispatch answers them."""
        if v <= self.base:
            return 0
        covered = min(v, idx.covered_hi)
        total = idx.count_upto(covered, ctx)
        if covered >= v:
            return total
        chunks = self._grid_chunks(covered, v)
        return total + self._cold_counts(chunks, ctx, deadline, base=total)

    def _count(self, lo: int, hi: int, kind: str,
               ctx: QueryCtx, deadline: float, idx: SieveIndex) -> int:
        if hi > MAX_HI:
            raise BadRequest(f"count: hi={hi} exceeds {MAX_HI}")
        if hi < lo:
            raise BadRequest(f"count: hi={hi} < lo={lo}")
        if kind == "primes":
            c_lo = self._count_upto(lo, ctx, deadline, idx)
            return self._count_upto(hi, ctx, deadline, idx) - c_lo
        if kind in ("twins", "cousins"):
            gap = 2 if kind == "twins" else 4
            if hi - lo > self.settings.max_pair_span:
                raise BadRequest(
                    f"count kind={kind}: span {hi - lo} exceeds "
                    f"{self.settings.max_pair_span} (pair counts enumerate)"
                )
            a = self._collect_primes(lo, hi, ctx, deadline, cap=None,
                                     idx=idx)
            return _pairs(a, gap)
        raise BadRequest(
            f"count: unknown kind {kind!r} (primes, twins, cousins)"
        )

    def _nth_prime(self, k: int, ctx: QueryCtx, deadline: float,
                   idx: SieveIndex) -> int:
        if k < 1:
            raise BadRequest(f"nth_prime({k}): k must be >= 1")
        if k <= idx.total_primes:
            return idx.nth(k, ctx)
        # extend past the index: cold-count the fixed grid until the
        # containing chunk, then materialize just that chunk locally
        seen = idx.total_primes
        ctx.index = bool(idx.segments)
        ctx.count_so_far = max(ctx.count_so_far, seen)
        a = idx.covered_hi
        while True:
            ctx.tick()
            if a >= MAX_HI:
                raise BadRequest(
                    f"nth_prime({k}): search passed MAX_HI={MAX_HI} "
                    f"with only {seen} primes"
                )
            # chunk-at-a-time on purpose: the search extent is unknown,
            # so there is no chunk list to pre-submit (concurrent
            # nth_prime searches still batch with each other's chunks)
            b = min(_grid_next(a, self.settings.cold_chunk), MAX_HI)
            c = self._cold_counts([(a, b)], ctx, deadline, base=seen)
            if seen + c >= k:
                return self._nth_in_window(a, b, k - seen, ctx, idx)
            seen += c
            a = b
            ctx.answered_hi = max(ctx.answered_hi, a)
            ctx.count_so_far = max(ctx.count_so_far, seen)

    def _nth_in_window(self, lo: int, hi: int, r: int, ctx: QueryCtx,
                       idx: SieveIndex) -> int:
        """r-th prime (1-indexed) inside [lo, hi) — r is known to exist."""
        layout = idx.layout
        extras = [p for p in layout.extra_primes if lo <= p < hi]
        if r <= len(extras):
            return extras[r - 1]
        r -= len(extras)
        flags = idx.get_flags(lo, hi, ctx)
        pos = np.nonzero(flags)[0][r - 1]
        return int(layout.values_np(lo, np.array([pos]))[0])

    def _primes(self, lo: int, hi: int, ctx: QueryCtx,
                deadline: float, idx: SieveIndex) -> np.ndarray:
        if hi > MAX_HI:
            raise BadRequest(f"primes: hi={hi} exceeds {MAX_HI}")
        if hi < lo:
            raise BadRequest(f"primes: hi={hi} < lo={lo}")
        # stays an int64 array: a v2 connection ships it as raw bitset
        # words or a packed column, a v1 connection gets .tolist() at
        # reply-encode time — either way, no per-element work here
        return self._collect_primes(lo, hi, ctx, deadline,
                                    cap=self.settings.max_primes, idx=idx)

    def _collect_primes(self, lo: int, hi: int, ctx: QueryCtx,
                        deadline: float, cap: int | None,
                        idx: SieveIndex) -> np.ndarray:
        """Materialize primes in [lo, hi) through the enumerate seam,
        feeding hot slices from the index LRU (``flags_fn``) and marking
        the request cold when a slice falls past the covered range."""
        lo = max(lo, 2)
        if hi <= lo:
            return np.zeros(0, dtype=np.int64)
        last_slice = [lo]

        def flags_fn(slo: int, shi: int):
            last_slice[0] = shi
            f = idx.flags_for_slice(slo, shi, ctx)
            if f is None:
                ctx.cold = True
                self._bump("cold_computes")
            return f

        out: list[np.ndarray] = []
        count = 0
        try:
            gen = primes_in_range(self.config.packing, lo, hi,
                                  bounds=idx.bounds, flags_fn=flags_fn)
        except ValueError as e:
            raise BadRequest(str(e)) from None
        for arr in gen:
            out.append(arr)
            count += arr.size
            ctx.answered_hi = max(ctx.answered_hi, last_slice[0])
            ctx.count_so_far = max(ctx.count_so_far, count)
            if cap is not None and count > cap:
                raise BadRequest(
                    f"primes: result exceeds {cap} values at "
                    f"{last_slice[0]}; narrow the window or raise "
                    f"SIEVE_SVC_MAX_PRIMES"
                )
            ctx.tick()
        return (np.concatenate(out) if out
                else np.zeros(0, dtype=np.int64))

    # --- cold tier: single-flight registration + batched dispatch --------

    def _cold_counts(self, chunks: list[tuple[int, int]], ctx: QueryCtx,
                     deadline: float, base: int = 0) -> int:
        """Primes across ``chunks`` (ascending, disjoint, grid-aligned).

        Single-flight registration happens for ALL chunks under one lock
        pass — per chunk the request is either a cache hit, a follower
        on an existing flight, or the registering leader — then every
        leader key is submitted to the batcher at once and the request
        waits on its flights in ascending order, so typed
        ``deadline_exceeded`` partials report the same contiguous prefix
        the sequential path did. ``base`` is the count already answered
        below ``chunks[0]`` (keeps ``ctx.count_so_far`` exact)."""
        plan: list[tuple[tuple[int, int], Any, _Flight | None, bool]] = []
        submit: list[tuple[int, int]] = []
        with self._cold_lock:
            for key in chunks:
                res = self._cold_cache.get(key)
                if res is not None:
                    self._cold_cache.move_to_end(key)
                    plan.append((key, res, None, False))
                    continue
                flight = self._inflight.get(key)
                if flight is None:
                    flight = self._inflight[key] = _Flight()
                    submit.append(key)
                    plan.append((key, None, flight, False))
                else:
                    plan.append((key, None, flight, True))
        if submit:
            ctx.cold = True
            self.batcher.submit(submit)
        if ctx.lane == "hot" and any(res is None for _k, res, _f, _fl in plan):
            # misclassified hot query: the chunks are already
            # handed to the cold plane (leaders submitted above, flights
            # registered); demote instead of parking a hot worker on a
            # backend dispatch. The cold re-run waits as a follower —
            # its tier bumps happen then, so nothing double-counts.
            raise _Demoted(sum(1 for _k, res, _f, _fl in plan
                               if res is None))
        for key, res, _f, follower in plan:
            if res is not None:
                ctx.cold_cached = True
                self._bump("cold_cache_hits")
            elif follower:
                self._bump("coalesced")
                self.metrics.event("service_coalesced", quietable=True,
                                   op="count_range", lo=key[0], hi=key[1])
        total = 0
        for key, res, flight, _follower in plan:
            ctx.tick()
            if res is None:
                assert flight is not None
                if not flight.event.wait(
                    timeout=max(0.0, deadline - trace.now_s())
                ):
                    raise DeadlineExceeded(ctx.answered_hi, ctx.count_so_far)
                if flight.error is not None:
                    if isinstance(flight.error, Degraded):
                        raise Degraded(str(flight.error))
                    raise RuntimeError(
                        f"batched cold compute failed: {flight.error}"
                    ) from flight.error
                ctx.cold = True
                res = flight.result
                assert res is not None
            total += int(res.count)
            ctx.answered_hi = max(ctx.answered_hi, key[1])
            ctx.count_so_far = max(ctx.count_so_far, base + total)
        return total

    def _persist_results(self, results) -> int:
        """Ledger write-back (``--persist-cold``): one atomic checksummed
        flush per batch. Best-effort by design — a full disk must degrade
        durability, never exactness of the replies in flight."""
        if self._writer is None:
            return 0
        # never shrink: a chunk clipped at a query's v shares its seg_id
        # (COLD_SEG_BASE + lo) with the full grid chunk — recording the
        # clipped one over an already-persisted larger hi would shrink
        # ledger coverage and strand every entry chained past it
        keep = [r for r in results
                if r.hi > self._writer.recorded_hi(r.seg_id)]
        if not keep:
            return 0
        try:
            self._writer.record_many(keep)
        except Exception:  # noqa: BLE001 — persistence never fails queries
            registry().counter("service.persist_failed").inc()
            return 0
        # tier-1 store entries: boundary words, not just
        # counts — the restart-hot half of --persist-cold. Keyed on the
        # exact (lo, hi) chunk, so clipped chunks persist independently
        # of the grid chunk sharing their seg_id. Best-effort, like the
        # ledger write above. ALL results qualify (not just `keep`): a
        # clipped chunk is an exact fact even when the ledger already
        # covers a larger hi for its seg_id.
        if self.store is not None and self.store.writer:
            try:
                for r in results:
                    self.store.put_boundary(
                        r.lo, r.hi, r.count, r.first_word, r.last_word
                    )
            except Exception:  # noqa: BLE001
                registry().counter("service.persist_failed").inc()
        self._bump("cold_persisted", len(keep))
        return len(keep)

    def _store_cold_result(self, key: tuple[int, int]):
        """Rebuild a cold chunk's SegmentResult from a persisted tier-1+
        store entry (restart-hot), or None. Tier 0 can't
        qualify — counts alone lack the boundary words downstream merges
        read — and pair-counting configs recompute: the store header has
        no twin_count field, so a synthesized result could carry a wrong
        one."""
        if self.store is None or self.config.twins:
            return None
        ent = self.store.get_entry(*key)
        if ent is None or ent[0] < TIER_BOUNDARY:
            return None
        tier, count, fw, lw = ent
        lo, hi = key
        return SegmentResult(
            seg_id=COLD_SEG_BASE + lo, lo=lo, hi=hi, count=int(count),
            twin_count=0, first_word=int(fw), last_word=int(lw),
            nbits=get_layout(self.config.packing).nbits(lo, hi),
            elapsed_s=0.0,
        )


def _grid_next(a: int, chunk: int) -> int:
    """Next cold-chunk boundary strictly above ``a`` on the fixed grid —
    overlapping queries land on identical (lo, hi) keys and coalesce."""
    return (a // chunk + 1) * chunk


def _req_int(msg: dict, field: str) -> int:
    v = msg.get(field)
    if not isinstance(v, int) or isinstance(v, bool):
        raise BadRequest(f"field {field!r} must be an integer, got {v!r}")
    return v


def _pairs(primes: np.ndarray, gap: int) -> int:
    """Pairs (p, p+gap) with both members present in the sorted array."""
    if primes.size < 2:
        return 0
    idx = np.searchsorted(primes, primes + gap)
    ok = idx < primes.size
    return int(np.count_nonzero(primes[idx[ok]] == primes[ok] + gap))
