"""Fleet trend aggregation with anomaly-triggered advisories.

The reference's ``sieve/service/observe.py``: the same settings
(``SIEVE_OBSERVE_*``), signals, anomaly engine, events and ring bytes, so a
ring either package wrote reads back equal with the other's
:func:`read_ring`.

A live fleet table shows the fleet *now*; this module watches it over
time. A :class:`FleetObserver` daemon (``python -m sieve_torch observe``) scrapes the
router and every advertised shard replica on a cadence through one
:class:`~sieve_torch.service.client.ClientPool`, derives per-endpoint trend
signals from consecutive samples (hot/cold qps, shed and error rates,
lane depth, SLO burn, store hit ratio, covered_hi growth, mesh fanout),
and persists a compact downsampled snapshot per scrape into an on-disk
:class:`SnapshotRing` under ``--observe-dir`` so trends survive the
process and feed a fleet table's sparklines.

The ring file follows the segment store's discipline: append-only CRC'd
records (magic + length + crc32 header per JSON payload), a torn tail
is silently trimmed at open and skipped by readers, and the size cap is
enforced by compaction — newest records rewritten through a tempfile +
``os.replace`` + directory fsync, never an in-place truncate.

On top of the samples runs an EWMA + robust z-score anomaly engine.
Per (endpoint, signal) the observer tracks an exponentially-weighted
mean and mean absolute deviation; a sample alarms only when the
endpoint is *armed* (``warmup`` consecutive real samples — a scrape gap
resets the streak, so the sample right after a gap can never alarm) and
the excursion clears BOTH an absolute floor (``min_delta``) and the
robust z threshold. A breach is edge-triggered with a global cooldown:
one ``fleet_anomaly`` event with its evidence row, plus a fleet-wide
flight-recorder pull (every endpoint's inline ``debug`` op, merged into
``anomaly_<scrape>.json`` — the flight recorder's bundle, fired by trend data
instead of a crash). The same windows drive ``scaling_advice``
(add_replica on sustained shed, split on a shard holding most of the
fleet's hot qps, merge on a near-idle shard), also edge-triggered.

Scrape faults are first-class: the ``svc_scrape_gap`` chaos kind (drawn
on the observer's own scrape counter, worker = target index) and any
genuinely unreachable endpoint produce a counted gap row and an
``observer_scrape_gap`` event — never a fabricated sample, and never an
alarm caused by the gap itself.

Locking: ``FleetObserver._lock`` guards counters and trend state and is
NEVER held across a pool RPC or ring I/O; ``SnapshotRing._lock``
serializes file appends/compactions and is a leaf.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
import tempfile
import threading
import time
import types
import zlib
from typing import Any

from sieve_torch import trace
from sieve_torch.analysis.lockdebug import named_lock
from sieve_torch.chaos import OBSERVER_KINDS, ChaosSchedule
from sieve_torch.debug import FLEET_BUNDLE_VERSION
from sieve_torch.metrics import MetricsLogger
from sieve_torch.service.client import ClientPool

RING_FILE = "fleet_ring.bin"

# per-record framing: magic, payload length, crc32(payload); payload is
# UTF-8 JSON. Mirrors the segment store's header discipline at snapshot
# granularity.
_REC_HEADER = struct.Struct("<III")
_REC_MAGIC = 0x53524E47  # "SRNG"

# signals the anomaly engine watches (the rest are recorded for trends
# and sparklines but never alarm — a store hit ratio drifting is
# capacity planning, not an incident)
ANOMALY_SIGNALS = ("hot_qps", "shed_rate", "err_rate", "lane_depth",
                   "slo_burn")


# --- settings ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ObserverSettings:
    """Knobs for the observer daemon (env: ``SIEVE_OBSERVE_*``)."""

    scrape_s: float = 1.0        # SIEVE_OBSERVE_SCRAPE_S
    timeout_s: float = 5.0       # SIEVE_OBSERVE_TIMEOUT_S (per-endpoint RPC)
    ring_bytes: int = 4 << 20    # SIEVE_OBSERVE_RING_BYTES (snapshot ring cap)
    alpha: float = 0.3           # SIEVE_OBSERVE_ALPHA (EWMA smoothing)
    z_threshold: float = 6.0     # SIEVE_OBSERVE_Z (robust z-score gate)
    min_delta: float = 2.0       # SIEVE_OBSERVE_MIN_DELTA (absolute floor)
    warmup: int = 8              # SIEVE_OBSERVE_WARMUP (consecutive samples
    #                              before an endpoint may alarm)
    cooldown_s: float = 30.0     # SIEVE_OBSERVE_COOLDOWN_S (edge-trigger
    #                              re-arm delay, anomalies and advice)
    observe_dir: str | None = None  # ring + anomaly bundles land here
    debug_pull: bool = True      # pull fleet debug bundles on anomaly
    quiet: bool = False

    def validate(self) -> "ObserverSettings":
        for name in ("scrape_s", "timeout_s"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or not math.isfinite(v) \
                    or v <= 0:
                raise ValueError(f"{name} must be a positive number, got {v!r}")
        if not isinstance(self.cooldown_s, (int, float)) or not \
                math.isfinite(self.cooldown_s) or self.cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be non-negative, got {self.cooldown_s!r}")
        if not isinstance(self.ring_bytes, int) or isinstance(
                self.ring_bytes, bool) or self.ring_bytes <= 0:
            raise ValueError(
                f"ring_bytes must be a positive int, got {self.ring_bytes!r}")
        if not isinstance(self.warmup, int) or isinstance(
                self.warmup, bool) or self.warmup < 0:
            raise ValueError(
                f"warmup must be a non-negative int, got {self.warmup!r}")
        if not isinstance(self.alpha, (int, float)) or not (
                0 < self.alpha <= 1):
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha!r}")
        for name in ("z_threshold", "min_delta"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or not math.isfinite(v) \
                    or v < 0:
                raise ValueError(
                    f"{name} must be a non-negative number, got {v!r}")
        if self.observe_dir is not None and not isinstance(
                self.observe_dir, str):
            raise ValueError("observe_dir must be a string path or None")
        return self

    @classmethod
    def from_env(cls, **overrides: Any) -> "ObserverSettings":
        from sieve_torch import env

        s = cls(
            scrape_s=env.env_float("SIEVE_OBSERVE_SCRAPE_S", cls.scrape_s),
            timeout_s=env.env_float("SIEVE_OBSERVE_TIMEOUT_S", cls.timeout_s),
            ring_bytes=env.env_int("SIEVE_OBSERVE_RING_BYTES",
                                   cls.ring_bytes),
            alpha=env.env_float("SIEVE_OBSERVE_ALPHA", cls.alpha),
            z_threshold=env.env_float("SIEVE_OBSERVE_Z", cls.z_threshold),
            min_delta=env.env_float("SIEVE_OBSERVE_MIN_DELTA", cls.min_delta),
            warmup=env.env_int("SIEVE_OBSERVE_WARMUP", cls.warmup),
            cooldown_s=env.env_float("SIEVE_OBSERVE_COOLDOWN_S",
                                     cls.cooldown_s),
        )
        return dataclasses.replace(s, **overrides) if overrides else s


# --- on-disk snapshot ring ---------------------------------------------------


class SnapshotRing:
    """Append-only CRC'd record file with a compaction-enforced size cap.

    Writer-side object (the observer daemon). Readers in other
    processes (a fleet table's sparklines, tests) use the
    module-level :func:`read_ring`, which tolerates a racing appender by
    construction: a record is either completely present with a valid
    CRC or it is the torn tail, and the scan stops there.
    """

    def __init__(self, path: str, cap_bytes: int = 4 << 20) -> None:
        self.path = path
        self._cap = max(1, int(cap_bytes))
        self._lock = named_lock("SnapshotRing._lock")
        self.torn = 0       # guard: _lock — bytes trimmed at open, torn tails
        self.compactions = 0  # guard: _lock
        self.appended = 0   # guard: _lock
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with self._lock:
            self._trim_torn_tail_locked()

    def _trim_torn_tail_locked(self) -> None:
        """Drop a partially-written final record left by a crash: scan
        to the last structurally complete record and truncate there."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        good = 0
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(_REC_HEADER.size)
                if len(hdr) < _REC_HEADER.size:
                    break
                magic, ln, crc = _REC_HEADER.unpack(hdr)
                if magic != _REC_MAGIC:
                    break
                payload = f.read(ln)
                if len(payload) < ln or zlib.crc32(payload) != crc:
                    break
                good = f.tell()
        if good < size:
            self.torn += 1
            with open(self.path, "r+b") as f:
                f.truncate(good)

    def append(self, record: dict) -> None:
        payload = json.dumps(record, separators=(",", ":")).encode()
        frame = _REC_HEADER.pack(_REC_MAGIC, len(payload),
                                 zlib.crc32(payload)) + payload
        with self._lock:
            with open(self.path, "ab") as f:
                f.write(frame)
                f.flush()
            self.appended += 1
            try:
                if os.path.getsize(self.path) > self._cap:
                    self._compact_locked()
            except OSError:
                pass

    def _compact_locked(self) -> None:
        """Rewrite the newest records into half the cap (so compaction
        amortizes instead of thrashing at the boundary), then swap the
        new generation in atomically: tempfile + ``os.replace`` +
        directory fsync — a reader either sees the old file or the new
        one, never a half-written middle."""
        recs = read_ring(self.path)
        budget = self._cap // 2
        kept: list[bytes] = []
        total = 0
        for rec in reversed(recs):
            payload = json.dumps(rec, separators=(",", ":")).encode()
            frame = _REC_HEADER.pack(_REC_MAGIC, len(payload),
                                     zlib.crc32(payload)) + payload
            if total + len(frame) > budget and kept:
                break
            kept.append(frame)
            total += len(frame)
        kept.reverse()
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".ring-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(b"".join(kept))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self.compactions += 1

    def records(self, n: int | None = None) -> list[dict]:
        with self._lock:
            recs = read_ring(self.path)
        return recs[-n:] if n is not None and n >= 0 else recs

    def stats(self) -> dict:
        with self._lock:
            return {"appended": self.appended, "torn": self.torn,
                    "compactions": self.compactions}


def read_ring(path: str) -> list[dict]:
    """Every structurally complete, CRC-valid record of a ring file,
    oldest first. Stops silently at the first torn/invalid frame — a
    racing appender's half-written tail is tomorrow's valid record, not
    an error."""
    out: list[dict] = []
    try:
        f = open(path, "rb")
    except OSError:
        return out
    with f:
        while True:
            hdr = f.read(_REC_HEADER.size)
            if len(hdr) < _REC_HEADER.size:
                break
            magic, ln, crc = _REC_HEADER.unpack(hdr)
            if magic != _REC_MAGIC:
                break
            payload = f.read(ln)
            if len(payload) < ln or zlib.crc32(payload) != crc:
                break
            try:
                rec = json.loads(payload)
            except (json.JSONDecodeError, UnicodeDecodeError):
                break
            if isinstance(rec, dict):
                out.append(rec)
    return out


# --- signal derivation -------------------------------------------------------


def _counter(stats: dict | None, *keys: str) -> int:
    return sum(int(stats.get(k) or 0) for k in keys) if stats else 0


def _worst_burn(stats: dict | None) -> float:
    slo = (stats or {}).get("slo") or {}
    burns = [v.get("burn") for v in slo.values()
             if isinstance(v, dict) and v.get("burn") is not None]
    return float(max(burns)) if burns else 0.0


def derive_signals(role: str, health: dict | None, stats: dict | None,
                   prev: dict | None, dt: float | None) -> dict[str, float]:
    """Per-endpoint trend signals from two consecutive samples.

    Counter-valued signals (qps, shed/err rates, covered_hi growth) are
    deltas over ``dt`` and come out 0.0 on the first sample — a trend
    needs two points; the observer never fabricates one. Instantaneous
    signals (lane depth, SLO burn, store hit ratio, mesh fanout) read
    straight off the current sample."""
    rate_dt = dt if dt is not None and dt > 0 else None

    def rate(*keys: str) -> float:
        if prev is None or rate_dt is None:
            return 0.0
        return max(0, _counter(stats, *keys) - _counter(prev, *keys)) / rate_dt

    sig: dict[str, float] = {}
    if role == "router":
        sig["hot_qps"] = rate("requests")
        sig["cold_qps"] = 0.0
        sig["shed_rate"] = rate("shed_relayed")
        sig["err_rate"] = rate("deadline_exceeded", "internal_errors",
                               "shard_errors", "unavailable_replies")
        sig["lane_depth"] = 0.0
    else:
        sig["hot_qps"] = rate("hot_admitted")
        sig["cold_qps"] = rate("cold_admitted")
        sig["shed_rate"] = rate("shed", "lane_shed_hot", "lane_shed_cold")
        sig["err_rate"] = rate("deadline_exceeded", "internal_errors",
                               "degraded_replies")
        sig["lane_depth"] = float((stats or {}).get("queue_depth") or 0)
    sig["slo_burn"] = _worst_burn(stats)
    st = (stats or {}).get("store") or {}
    hits = int(st.get("hits") or 0)
    misses = int(st.get("misses") or 0)
    sig["store_hit"] = hits / (hits + misses) if hits + misses else 0.0
    covered = float((health or {}).get("covered_hi") or 0)
    prev_covered = float((prev or {}).get("_covered_hi") or covered)
    sig["covered_rate"] = (
        max(0.0, covered - prev_covered) / rate_dt
        if prev is not None and rate_dt else 0.0
    )
    sig["mesh_fanout"] = float((stats or {}).get("mesh_fanout") or 0)
    return sig


# --- the observer ------------------------------------------------------------


class FleetObserver:
    """Scrape → derive → detect → advise loop. See the module docstring."""

    def __init__(
        self,
        router_addr: str,
        settings: ObserverSettings | None = None,
        chaos: ChaosSchedule | None = None,
    ) -> None:
        self.settings = (settings or ObserverSettings.from_env()).validate()
        self.router_addr = router_addr
        # MetricsLogger only reads .quiet off its config (router shim)
        self.metrics = MetricsLogger(
            types.SimpleNamespace(quiet=self.settings.quiet)
        )
        self.chaos = chaos if chaos is not None else ChaosSchedule([])
        self.pool = ClientPool(timeout_s=self.settings.timeout_s)
        self.ring: SnapshotRing | None = None
        if self.settings.observe_dir:
            self.ring = SnapshotRing(
                os.path.join(self.settings.observe_dir, RING_FILE),
                cap_bytes=self.settings.ring_bytes,
            )
        self._lock = named_lock("FleetObserver._lock")
        self._scrapes = 0        # guard: _lock — global scrape counter (the
        #                          svc_scrape_gap chaos segment key)
        self._gap_count = 0      # guard: _lock
        self._anomaly_count = 0  # guard: _lock
        self._advice_count = 0   # guard: _lock
        self._prev: dict[str, dict] = {}   # guard: _lock — addr -> last
        #                          sample {"ts","stats","_covered_hi"}
        self._good: dict[str, int] = {}    # guard: _lock — addr ->
        #                          consecutive real samples (gap resets)
        self._ewma: dict[tuple, dict] = {}  # guard: _lock —
        #                          (addr, signal) -> {"mean","dev","n"}
        self._anomaly_ts = -math.inf       # guard: _lock — last fire
        self._advice_ts: dict[tuple, float] = {}  # guard: _lock —
        #                          (advice, shard) -> last fire
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None

    # --- target discovery ------------------------------------------------

    def _discover(self) -> list[dict]:
        """Router first, then every advertised shard replica. A failed
        router poll still yields the router target (as a gap row);
        replicas are whatever the last reachable health advertised."""
        targets = [{"role": "router", "addr": self.router_addr,
                    "shard": None}]
        try:
            health = self.pool.get(self.router_addr).health()
        except Exception:  # noqa: BLE001 — discovery gap, scrape records it
            self.pool.invalidate(self.router_addr)
            return targets
        for ent in health.get("shards", []) or []:
            for addr in ent.get("addrs", []) or []:
                targets.append({"role": "shard", "addr": addr,
                                "shard": ent.get("shard")})
        return targets

    # --- one scrape ------------------------------------------------------

    def scrape_once(self) -> dict:
        """One full scrape cycle, synchronous (tests call it directly).

        Returns the snapshot row that was appended to the ring."""
        with self._lock:
            self._scrapes += 1
            k = self._scrapes
        targets = self._discover()
        now = time.time()

        # 1) poll every target — RPCs happen with NO observer lock held.
        #    A chaos draw or transport failure is a gap row, never a
        #    fabricated sample.
        rows: list[dict] = []
        for ti, tgt in enumerate(targets):
            addr = tgt["addr"]
            drawn = self.chaos.take_kinds(ti, k, OBSERVER_KINDS)
            if drawn:
                rows.append({**tgt, "gap": drawn[0]["kind"]})
                continue
            try:
                cli = self.pool.get(addr)
                rows.append({**tgt, "gap": None, "health": cli.health(),
                             "stats": cli.stats()})
            except Exception as e:  # noqa: BLE001 — dead endpoint = gap row
                self.pool.invalidate(addr)
                rows.append({**tgt, "gap": type(e).__name__})

        # 2) fold into trend state under the lock (pure computation)
        snapshot_targets: list[dict] = []
        anomalies: list[dict] = []
        gap_events: list[dict] = []
        with self._lock:
            for row in rows:
                addr = row["addr"]
                if row["gap"] is not None:
                    self._gap_count += 1
                    # the gap disarms the endpoint: the next REAL sample
                    # re-seeds the delta baseline and can never alarm
                    self._good[addr] = 0
                    self._prev.pop(addr, None)
                    gap_events.append({"addr": addr, "scrape": k,
                                       "gap": row["gap"]})
                    snapshot_targets.append({
                        "addr": addr, "role": row["role"],
                        "shard": row["shard"], "gap": row["gap"],
                    })
                    continue
                prev = self._prev.get(addr)
                dt = (now - prev["ts"]) if prev else None
                sig = derive_signals(row["role"], row["health"],
                                     row["stats"],
                                     prev["stats"] if prev else None, dt)
                good = self._good.get(addr, 0)
                self._good[addr] = good + 1
                armed = good >= max(2, self.settings.warmup)
                for name in ANOMALY_SIGNALS:
                    x = sig[name]
                    state = self._ewma.setdefault(
                        (addr, name), {"mean": x, "dev": 0.0, "n": 0})
                    if armed and state["n"] >= 2:
                        delta = abs(x - state["mean"])
                        z = delta / max(state["dev"], 1e-9)
                        if (delta > self.settings.min_delta
                                and z > self.settings.z_threshold):
                            anomalies.append({
                                "addr": addr, "signal": name,
                                "value": round(x, 4),
                                "mean": round(state["mean"], 4),
                                "dev": round(state["dev"], 4),
                                "z": round(min(z, 1e6), 2), "scrape": k,
                            })
                    a = self.settings.alpha
                    state["mean"] += a * (x - state["mean"])
                    state["dev"] = ((1 - a) * state["dev"]
                                    + a * abs(x - state["mean"]))
                    state["n"] += 1
                stats = dict(row["stats"] or {})
                stats["_covered_hi"] = (row["health"] or {}).get(
                    "covered_hi") or 0
                self._prev[addr] = {"ts": now, "stats": stats}
                snapshot_targets.append({
                    "addr": addr, "role": row["role"],
                    "shard": row["shard"], "gap": None,
                    "signals": {s: round(v, 4) for s, v in sig.items()},
                })
            advice = self._advise_locked(snapshot_targets, k, now)
            fire = None
            if anomalies and now - self._anomaly_ts >= \
                    self.settings.cooldown_s:
                # edge-trigger: one bundle per breach episode, the
                # first breaching row is the evidence
                self._anomaly_ts = now
                self._anomaly_count += 1
                fire = anomalies[0]
            self._advice_count += len(advice)

        # 3) side effects with the lock released: events, the fleet
        #    debug pull, the ring append
        for g in gap_events:
            self.metrics.event("observer_scrape_gap", quietable=True, **g)
        bundle_path = None
        if fire is not None:
            bundle_path = self._pull_fleet_bundle(targets, k)
            self.metrics.event("fleet_anomaly", bundle=bundle_path, **fire)
        for adv in advice:
            self.metrics.event("scaling_advice", **adv)
        snap = {"ts": round(now, 3), "scrape": k,
                "targets": snapshot_targets, "anomalies": anomalies,
                "advice": advice}
        if self.ring is not None:
            self.ring.append(snap)
        return snap

    # --- advisories ------------------------------------------------------

    def _advise_locked(self, targets: list[dict], k: int,
                       now: float) -> list[dict]:
        """Split/merge/add-replica advisories from the EWMA windows.
        Caller holds ``_lock``. Edge-triggered per (advice, shard)."""
        per_shard: dict[int, dict] = {}
        for t in targets:
            if t["role"] != "shard" or t.get("gap") is not None:
                continue
            si = t["shard"]
            if not isinstance(si, int):
                continue
            agg = per_shard.setdefault(
                si, {"qps": 0.0, "shed": 0.0, "armed": True})
            mean = self._ewma.get((t["addr"], "hot_qps"),
                                  {"mean": 0.0, "n": 0})
            shed = self._ewma.get((t["addr"], "shed_rate"),
                                  {"mean": 0.0, "n": 0})
            agg["qps"] += max(0.0, mean["mean"])
            agg["shed"] += max(0.0, shed["mean"])
            if min(mean.get("n", 0), shed.get("n", 0)) < max(
                    2, self.settings.warmup):
                agg["armed"] = False
        fleet_qps = sum(a["qps"] for a in per_shard.values())
        out: list[dict] = []

        def fire(advice: str, si: int, agg: dict, share: float) -> None:
            key = (advice, si)
            if now - self._advice_ts.get(key, -math.inf) < \
                    self.settings.cooldown_s:
                return
            self._advice_ts[key] = now
            out.append({"advice": advice, "shard": si,
                        "qps": round(agg["qps"], 3),
                        "shed_rate": round(agg["shed"], 3),
                        "share": round(share, 4), "scrape": k})

        for si, agg in sorted(per_shard.items()):
            if not agg["armed"]:
                continue
            share = agg["qps"] / fleet_qps if fleet_qps > 0 else 0.0
            if agg["shed"] > 0.5:
                fire("add_replica", si, agg, share)
            elif share > 0.6 and len(per_shard) > 1 and fleet_qps > 1.0:
                fire("split", si, agg, share)
            elif share < 0.05 and len(per_shard) > 1 and fleet_qps > 1.0:
                fire("merge", si, agg, share)
        return out

    # --- anomaly bundle --------------------------------------------------

    def _pull_fleet_bundle(self, targets: list[dict],
                           k: int) -> str | None:
        """Fleet-wide flight-recorder pull (every endpoint's inline
        ``debug`` op) plus its continuous-profiler snapshot (the
        ``profile`` op), written as ``anomaly_<scrape>.json`` under the
        observe dir. A partial pull still lands — each unreachable
        endpoint carries its named error, and a profile gap (svc_prof_gap
        chaos) never takes the debug half down with it."""
        if not self.settings.debug_pull or not self.settings.observe_dir:
            return None
        procs: list[dict] = []
        for tgt in targets:
            addr = tgt["addr"]
            try:
                row = {"addr": addr, "role": tgt["role"],
                       "shard": tgt["shard"],
                       "bundle": self.pool.get(addr).debug(),
                       "error": None, "profile": None,
                       "profile_error": None}
                try:
                    row["profile"] = self.pool.get(addr).profile()
                except Exception as pe:  # noqa: BLE001 — gap != down
                    self.pool.invalidate(addr)
                    row["profile_error"] = f"{type(pe).__name__}: {pe}"
                prof = row["profile"]
                self.metrics.event(
                    "profile_pulled", quietable=True, role="observer",
                    samples=(prof or {}).get("samples"),
                    stacks=len((prof or {}).get("stacks") or ()),
                    gap=row["profile_error"] is not None,
                )
                procs.append(row)
            except Exception as e:  # noqa: BLE001 — partial bundle is fine
                self.pool.invalidate(addr)
                procs.append({"addr": addr, "role": tgt["role"],
                              "shard": tgt["shard"], "bundle": None,
                              "error": f"{type(e).__name__}: {e}",
                              "profile": None, "profile_error": None})
        doc = {"bundle": FLEET_BUNDLE_VERSION, "ts": time.time(),
               "trigger": "fleet_anomaly", "scrape": k,
               "processes": procs}
        path = os.path.join(self.settings.observe_dir,
                            f"anomaly_{k}.json")
        try:
            os.makedirs(self.settings.observe_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        except OSError:
            return None
        return path

    # --- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="sieve-observer", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            t0 = trace.now_s()
            try:
                self.scrape_once()
            except Exception as e:  # noqa: BLE001 — observer must survive
                self.metrics.event("observer_error", quietable=True,
                                   error=f"{type(e).__name__}: {e}")
            elapsed = trace.now_s() - t0
            self._stop_evt.wait(max(0.0, self.settings.scrape_s - elapsed))

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        self.pool.close()

    def stats(self) -> dict:
        with self._lock:
            out = {"scrapes": self._scrapes, "gaps": self._gap_count,
                   "anomalies": self._anomaly_count,
                   "advice": self._advice_count,
                   "endpoints": len(self._good)}
        if self.ring is not None:
            out["ring"] = self.ring.stats()
        return out

    def __enter__(self) -> "FleetObserver":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


__all__ = [
    "ANOMALY_SIGNALS",
    "RING_FILE",
    "FleetObserver",
    "ObserverSettings",
    "SnapshotRing",
    "derive_signals",
    "read_ring",
]
