"""Metrics: a registry of counters, gauges and histograms, and event sinks.

The reference's ``sieve/metrics.py``, for the parts the port runs:

* :class:`MetricsRegistry`: named instruments updated from anywhere
  (cluster heartbeats, straggler watermarks, segment timings, kernel
  launches). ``registry().snapshot()`` is plain JSON, which is what a
  cluster worker ships to its coordinator.
* :class:`MetricsHistory`: a daemon sampler of registry snapshots into a
  bounded two-tier ring (``SIEVE_METRICS_SAMPLE_S``), the flight
  recorder's trend window.
* Event sinks: every structured event (one JSON object) goes to the
  emitting logger's stream (stderr) and to every registered sink;
  ``--metrics-file`` installs a :class:`FileSink` (JSONL), tests a
  :class:`MemorySink`.

Every record carries ``event`` and ``ts`` (seconds on the trace epoch,
comparable with span times). The required keys per kind are
:data:`EVENT_SCHEMA`. ``--quiet`` drops only the per-segment console
lines; sinks get every record.
"""

from __future__ import annotations

import collections
import itertools
import json
import math
import random
import sys
import threading
import zlib
from typing import TYPE_CHECKING, Any, TextIO

from sieve_torch import env, trace
from sieve_torch.analysis.lockdebug import named_lock

if TYPE_CHECKING:
    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import SieveResult
    from sieve_torch.worker import SegmentResult

# Required keys per event kind ("event" and "ts" are implicit). Cluster
# events carry the run id and the attempt's trace context ("ctx", None
# when the failure was not mid-assignment). The service's kinds are the
# reference's, so one event stream validates alike in both packages.
EVENT_SCHEMA: dict[str, set[str]] = {
    "segment": {"id", "lo", "hi", "ms", "count"},
    "run": {"n", "pi", "backend", "packing", "elapsed_s", "values_per_sec"},
    "resume": {"restored"},
    "worker_failed": {"worker", "reason", "run_id", "ctx"},
    "segment_error": {"reason", "run_id", "ctx"},
    "reassign": {"seg_id", "run_id", "ctx"},
    "host_prepare": {"prep_s"},
    "worker_telemetry": {"worker", "events", "dropped"},
    # elastic membership; "active" is the live worker count after it
    "worker_joined": {"worker", "run_id", "active"},
    "worker_left": {"worker", "reason", "run_id", "active"},
    "deadline_adjusted": {"deadline_s", "prev_s", "p95_s", "run_id"},
    "ledger_salvaged": {"salvaged", "quarantined"},
    # query service: one service_request per admitted request
    # ("outcome" is ok/deadline_exceeded/degraded/bad_request/internal,
    # "source" index/cold/mixed/none); shed requests get service_shed
    # instead (never both). service_coalesced marks a follower joining a
    # leader's in-flight cold range; service_degraded marks health
    # transitions (entering=True/False).
    "service_request": {"op", "outcome", "source", "ms"},
    "service_shed": {"op", "queue_depth"},
    "service_coalesced": {"op", "lo", "hi"},
    "service_degraded": {"entering", "reason"},
    # replication plane: service_refreshed marks each live
    # snapshot swap (covered_hi is monotonic per process);
    # service_refresh_failed a skipped refresh (corrupt / mid-quarantine
    # / regressing read); service_drain the flip to draining;
    # service_chaos_refused a wire chaos injection denied by the
    # --allow-chaos gate; ledger_unverified a checksum-less v1 read-only
    # open (loads, but never silently).
    "service_refreshed": {"covered_hi", "prev_covered_hi", "segments",
                          "refreshes"},
    "service_refresh_failed": {"reason"},
    "service_drain": {"queued", "inflight"},
    "service_chaos_refused": {"spec"},
    "ledger_unverified": {"path"},
    # batched cold plane: one service_batched per backend
    # dispatch — "chunks" is the batch size (also observed by the
    # service.batch_chunks histogram), "persisted" how many results were
    # written back to the ledger (0 unless --persist-cold), "failed" how
    # many chunks were chaos-failed out of the batch pre-dispatch.
    "service_batched": {"chunks", "lo", "hi", "ms", "persisted", "failed"},
    # priority lanes: service_lane_shed marks a per-lane
    # admission refusal (queue_depth is THAT lane's depth; a lane shed
    # also emits the lane-less service_shed for continuity);
    # service_demoted marks a misclassified hot request re-enqueued on
    # the cold lane ("chunks" = how many chunks needed a dispatch).
    "service_lane_shed": {"op", "lane", "queue_depth"},
    "service_demoted": {"op", "chunks"},
    # router fabric: one router_request per routed query
    # ("shards" = how many shards the scatter touched; point routes say
    # 1); router_shard_down marks a shard held unreachable (chaos window
    # or exhausted replicas — "reason" says which); router_spliced marks
    # a cross-shard pair stitch at a shard edge ("pair_kind" twins /
    # cousins, "pairs" = pairs crossing that edge). router_drain and
    # router_chaos_refused mirror their service_ counterparts.
    "router_request": {"op", "outcome", "shards", "ms"},
    "router_shard_down": {"shard", "reason"},
    "router_spliced": {"edge", "pair_kind", "pairs"},
    "router_drain": {"inflight"},
    "router_chaos_refused": {"spec"},
    # fleet trace/telemetry plane: service_trace_drop marks a
    # reply whose piggybacked telemetry was chaos-dropped (query result
    # still exact); router_trace_gap the router-side degradation for a
    # reply that should have carried telemetry but didn't ("reason"
    # dropped/malformed); router_telemetry one merged shard-replica span
    # batch (rebased onto the router timeline — the service analogue of
    # worker_telemetry); service_slo_burn the transition of one op's
    # rolling p95 above its configured SLO.
    "service_trace_drop": {"op"},
    "router_trace_gap": {"shard", "reason"},
    "router_telemetry": {"shard", "replica", "events", "dropped"},
    "service_slo_burn": {"op", "p95_ms", "slo_ms", "window"},
    # flight recorder: one debug_bundle per frozen postmortem
    # bundle — "trigger" names the edge that fired (slo_burn /
    # breaker_open / shard_down / crash), "path" the bundle directory
    # (None when no --debug-dir is set and the freeze stayed in memory)
    "debug_bundle": {"trigger", "path"},
    # wire plane: service_slow_frame marks a connection put
    # under the svc_slow_frame chaos throttle (its replies dribble at
    # "bytes_per_tick" per event-loop tick); service_slow_consumer
    # marks a connection killed because its bounded write queue
    # overflowed ("queued_bytes" = bytes pending when the cap tripped).
    "service_slow_frame": {"bytes_per_tick"},
    "service_slow_consumer": {"queued_bytes"},
    # binary wire v2: a v2-capable client whose hello came
    # back v1-only — "negotiated" is the version the peer settled on.
    # Emitted once per downgraded connection so a supposedly-binary
    # fleet silently running JSON is visible in the metrics stream.
    "wire_downgrade": {"addr", "negotiated"},
    # tiered segment store: store_demoted marks an LRU/_pv
    # eviction landing in tier 2 (bytes = wheel-compressed payload);
    # store_compacted one generation swap by the elected writer
    # (reclaimed_bytes may be negative if peers appended mid-compaction);
    # store_torn_entry one checksum-failed record skipped by a reader or
    # deliberately written torn by the store_torn_write chaos kind —
    # counted, never fatal, the chunk simply re-materializes.
    "store_demoted": {"lo", "hi", "bytes", "tier"},
    "store_compacted": {"gen", "live", "reclaimed_bytes", "downgraded"},
    "store_torn_entry": {"offset", "gen"},
    # mesh cold plane: service_mesh_dispatch is one SPMD
    # launch over the device mesh ("chunks" = drain-slice fanout,
    # "launch" = the ColdBackend's mesh-launch counter — the
    # svc_mesh_fail chaos key); service_mesh_fallback is a typed
    # degradation to the local loop worker ("reason" names mesh init vs
    # launch failure; chunks=0 for the one-shot init fallback) — the
    # answers stay exact either way.
    "service_mesh_dispatch": {"chunks", "devices", "launch", "ms"},
    "service_mesh_fallback": {"reason", "chunks"},
    # capacity observatory: service_exemplar_kept is one
    # tail-sampled span tree retained at request completion ("reason" is
    # the retention rule: error/flagged/slow/baseline); observer_scrape_gap
    # is one failed observer poll (chaos or a genuinely down endpoint) —
    # counted, never fabricated into a sample; fleet_anomaly is an
    # edge-triggered robust z-score breach with its evidence row (and the
    # fleet debug bundle it pulled); scaling_advice a split/merge/
    # add-replica advisory derived from the same trend windows.
    "service_exemplar_kept": {"role", "ctx", "op", "outcome", "reason",
                              "ms", "spans"},
    "observer_scrape_gap": {"addr", "scrape", "gap"},
    "fleet_anomaly": {"addr", "signal", "value", "mean", "dev", "z",
                      "scrape", "bundle"},
    "scaling_advice": {"advice", "shard", "qps", "shed_rate", "share",
                       "scrape"},
    # a scrape cycle that raised past the per-endpoint nets: counted so
    # a silently wedged observer is visible, never fatal to the daemon
    "observer_error": {"error"},
    # continuous profiler: profile_captured is one sampler
    # table frozen into a FlightRecorder bundle ("samples" = thread
    # samples folded since start, "stacks" = distinct collapsed stacks
    # held); profile_pulled is one inline ``profile`` wire reply (or
    # the observer's fleet-wide anomaly pull, role="observer") —
    # "gap" flags a reply the svc_prof_gap chaos kind dropped.
    "profile_captured": {"role", "samples", "stacks"},
    "profile_pulled": {"role", "samples", "stacks", "gap"},
}


def validate_record(record: dict[str, Any]) -> None:
    """Raise ValueError if a record violates the documented schema."""
    kind = record.get("event")
    if not isinstance(kind, str):
        raise ValueError(f"record missing 'event' kind: {record!r}")
    if "ts" not in record:
        raise ValueError(f"record missing 'ts': {record!r}")
    missing = EVENT_SCHEMA.get(kind, set()) - record.keys()
    if missing:
        raise ValueError(f"{kind!r} record missing keys {sorted(missing)}")
    json.dumps(record)  # every value must be JSON-serializable


# --- instruments -------------------------------------------------------------


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = named_lock("Counter._lock")

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n
        trace.counter(self.name, self.value)

    def snapshot(self) -> dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-observed value (straggler lag, clock error, merged counts)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value: float | None = None
        self._lock = named_lock("Gauge._lock")

    def set(self, v: float) -> None:
        with self._lock:
            self.value = v
        trace.counter(self.name, v)

    def max(self, v: float) -> None:
        """Keep the running maximum (straggler watermarks)."""
        with self._lock:
            if self.value is None or v > self.value:
                self.value = v

    def snapshot(self) -> dict[str, Any]:
        return {"type": "gauge", "value": self.value}


# reservoir size: bounded memory, nearest-rank percentiles within ~2%
HISTOGRAM_RESERVOIR = 4096


def _pctile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile of a sorted non-empty list."""
    return sorted_vals[max(0, math.ceil(q * len(sorted_vals)) - 1)]


class Histogram:
    """count/sum/min/max plus a fixed-size reservoir (Algorithm R, seeded
    from the name so snapshots reproduce) for percentiles."""

    __slots__ = ("name", "count", "sum", "min", "max", "_lock",
                 "_reservoir", "_cap", "_rng")

    def __init__(self, name: str, reservoir: int = HISTOGRAM_RESERVOIR):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._reservoir: list[float] = []
        self._cap = max(1, reservoir)
        self._rng = random.Random(zlib.crc32(name.encode()))
        self._lock = named_lock("Histogram._lock")

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if len(self._reservoir) < self._cap:
                self._reservoir.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._reservoir[j] = v

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            count, total = self.count, self.sum
            lo, hi = self.min, self.max
            vals = sorted(self._reservoir)
        return {
            "type": "histogram",
            "count": count,
            "sum": total,
            "min": lo,
            "max": hi,
            "mean": total / count if count else None,
            "p50": _pctile(vals, 0.50) if vals else None,
            "p95": _pctile(vals, 0.95) if vals else None,
            "p99": _pctile(vals, 0.99) if vals else None,
        }


class MetricsRegistry:
    """Named instruments; one process-wide instance by default."""

    def __init__(self) -> None:
        self._lock = named_lock("MetricsRegistry._lock")
        self._instruments: dict[str, Any] = {}  # guard: _lock

    def _get(self, name: str, cls):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name)
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> dict[str, dict]:
        with self._lock:
            return {k: v.snapshot() for k, v in self._instruments.items()}


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


# --- metrics history ---------------------------------------------------------

# two-tier ring shape: the newest HISTORY_RECENT samples stay dense (one
# per tick); as a sample ages out of the dense tier every
# HISTORY_DECIMATE-th one is promoted into a coarse tier of
# HISTORY_COARSE slots — an hour of 1 s sampling costs ~660 snapshots,
# not 3600, and trend queries still see the whole hour.
HISTORY_RECENT = 300
HISTORY_COARSE = 360
HISTORY_DECIMATE = 10


def sample_interval_s() -> float:
    """The MetricsHistory tick from ``SIEVE_METRICS_SAMPLE_S`` (seconds;
    default 1.0; 0 disables sampling). Parse failures name the env var."""
    v = env.env_float("SIEVE_METRICS_SAMPLE_S", 1.0)
    if v < 0 or not math.isfinite(v):
        raise ValueError(
            f"env SIEVE_METRICS_SAMPLE_S={v!r}: must be a non-negative "
            "finite number of seconds"
        )
    return v


class MetricsHistory:
    """Daemon sampler: periodic registry snapshots into a bounded,
    time-downsampled ring.

    This is the trend input the flight recorder bundles: recent samples
    dense, older samples decimated, memory bounded regardless of process
    lifetime. ``start``/``stop`` are idempotent; a 0 sample
    interval disables the sampler entirely (zero samples, zero
    threads); ``stop`` takes one final synchronous sample so whatever
    changed since the last timer tick is not lost."""

    def __init__(
        self,
        reg: MetricsRegistry | None = None,
        sample_s: float | None = None,
        recent: int = HISTORY_RECENT,
        coarse: int = HISTORY_COARSE,
        decimate: int = HISTORY_DECIMATE,
    ):
        self._reg = reg if reg is not None else registry()
        self.sample_s = (
            sample_interval_s() if sample_s is None else float(sample_s)
        )
        self._recent: collections.deque = collections.deque(maxlen=recent)
        self._coarse: collections.deque = collections.deque(maxlen=coarse)
        self._decimate = max(1, decimate)
        self._taken = 0  # guard: _lock
        self._lock = named_lock("MetricsHistory._lock")
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # --- lifecycle -------------------------------------------------------

    def start(self) -> "MetricsHistory":
        if self.sample_s <= 0:
            return self  # disabled: no thread, no samples
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self  # idempotent
            self._stop_evt = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, args=(self._stop_evt,), daemon=True,
                name="metrics-history",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
            self._stop_evt.set()
        if t is not None:
            t.join(timeout=5)
            self.sample_now()  # drain-on-stop: the partial tick lands

    def _loop(self, stop_evt: threading.Event) -> None:
        while not stop_evt.wait(self.sample_s):
            self.sample_now()

    # --- sampling --------------------------------------------------------

    def sample_now(self) -> float:
        """Take one sample immediately (the timer thread's tick body;
        also the test/drain hook). Returns the sample timestamp."""
        snap = self._reg.snapshot()
        ts = round(trace.now_s(), 4)
        with self._lock:
            self._taken += 1
            if len(self._recent) == self._recent.maxlen:
                aged = self._recent[0]  # about to be evicted by append
                if aged[2] % self._decimate == 0:
                    self._coarse.append(aged)
            self._recent.append((ts, snap, self._taken))
        return ts

    @property
    def samples(self) -> int:
        """Samples ever taken (monotonic; survives ring eviction)."""
        with self._lock:
            return self._taken

    # --- queries ---------------------------------------------------------

    def rows(self, window_s: float | None = None) -> list[tuple[float, dict]]:
        """Raw ``(ts, registry-snapshot)`` rows, oldest first (coarse
        tier then dense), optionally limited to the trailing window —
        the flight recorder bundles this verbatim."""
        cutoff = None if window_s is None else trace.now_s() - window_s
        with self._lock:
            rows = list(itertools.chain(self._coarse, self._recent))
        return [
            (ts, snap) for ts, snap, _ in rows
            if cutoff is None or ts >= cutoff
        ]

    def history(self, name: str, window_s: float) -> list[tuple[float, Any]]:
        """Trend rows for one instrument over the trailing window:
        ``(ts, value)`` for counters and gauges, ``(ts, snapshot-dict)``
        for histograms. Samples predating the instrument's registration
        are absent, not None — registry churn is expected."""
        out: list[tuple[float, Any]] = []
        for ts, snap in self.rows(window_s):
            inst = snap.get(name)
            if inst is None:
                continue
            out.append((ts, inst["value"] if "value" in inst else inst))
        return out


# --- sinks -------------------------------------------------------------------


class MemorySink:
    """Collects records in memory (tests, inspection)."""

    def __init__(self) -> None:
        self.records: list[dict] = []
        self._lock = named_lock("MemorySink._lock")

    def emit(self, record: dict) -> None:
        with self._lock:
            self.records.append(record)

    def close(self) -> None:
        pass


class StreamSink:
    """JSONL onto an open text stream."""

    def __init__(self, stream: TextIO):
        self.stream = stream
        self._lock = named_lock("StreamSink._lock")

    def emit(self, record: dict) -> None:
        with self._lock:
            self.stream.write(json.dumps(record) + "\n")
            self.stream.flush()

    def close(self) -> None:
        pass


class FileSink(StreamSink):
    """JSONL appended to a file (``--metrics-file``)."""

    def __init__(self, path: str):
        super().__init__(open(path, "a"))

    def close(self) -> None:
        self.stream.close()


_SINKS: list = []
_SINKS_LOCK = named_lock("metrics._SINKS_LOCK")


def add_sink(sink) -> None:
    """Register a global sink; every MetricsLogger fans records into it."""
    with _SINKS_LOCK:
        _SINKS.append(sink)


def remove_sink(sink) -> None:
    with _SINKS_LOCK:
        if sink in _SINKS:
            _SINKS.remove(sink)


def _global_sinks() -> list:
    with _SINKS_LOCK:
        return list(_SINKS)


# --- the event logger --------------------------------------------------------


class MetricsLogger:
    """Structured event emitter for one run: one JSON line per segment and
    a run summary on stderr, every record to the global sinks. ``quiet``
    suppresses the per-segment console lines only."""

    def __init__(self, config: "SieveConfig", stream: TextIO | None = None):
        self.config = config
        self.stream = stream if stream is not None else sys.stderr
        self.t_start = trace.now_s()

    def _emit(self, record: dict[str, Any], per_segment: bool = False) -> None:
        record.setdefault("ts", round(trace.now_s(), 4))
        for sink in _global_sinks():
            sink.emit(record)
        if per_segment and self.config.quiet:
            return
        self.stream.write(json.dumps(record) + "\n")
        self.stream.flush()

    def event(self, kind: str, quietable: bool = False, **fields: Any) -> None:
        """Emit one record; ``quietable`` marks per-segment chatter that
        ``--quiet`` keeps off the console (sinks always get it)."""
        self._emit({"event": kind, **fields}, per_segment=quietable)

    def segment(self, res: "SegmentResult") -> None:
        reg = registry()
        reg.counter("segments_done").inc()
        reg.histogram("segment_ms").observe(res.elapsed_s * 1000)
        self._emit(
            {
                "event": "segment",
                "id": res.seg_id,
                "lo": res.lo,
                "hi": res.hi,
                "ms": round(res.elapsed_s * 1000, 3),
                "count": res.count,
            },
            per_segment=True,
        )

    def run_summary(self, result: "SieveResult") -> None:
        chips = max(1, self.config.workers)
        record = {
            "event": "run",
            "n": result.n,
            "pi": result.pi,
            "twins": result.twin_pairs,
            "backend": result.backend,
            "packing": result.packing,
            "elapsed_s": round(result.elapsed_s, 4),
            "values_per_sec": round(result.values_per_sec, 1),
            "primes_per_sec_per_chip": round(result.pi / result.elapsed_s / chips, 1)
            if result.elapsed_s > 0
            else None,
        }
        if self.config.count_kind not in ("primes", "twins"):
            record["count_kind"] = self.config.count_kind
        phases = result.host_phases
        if phases:
            for key in (
                "prep_s",
                "prep_values_per_sec",
                "device_idle_frac",
                "overlap_efficiency",
                "reduction_mode",
                "postlude_fused_s",
                "postlude_split_s",
                "telemetry_workers",
                "telemetry_dropped_events",
                "clock_err_max_s",
                "workers_joined",
                "workers_left",
            ):
                if key in phases:
                    record[key] = phases[key]
        self._emit(record)
