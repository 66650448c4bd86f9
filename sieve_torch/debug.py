"""Black-box flight recorder: triggered postmortem bundles.

The reference's ``sieve/debug.py``.

A :class:`FlightRecorder` runs inside every server and router,
continuously holding the cheap-to-keep tail of what the process was
doing: the newest span-ring events, the last structured EVENT_SCHEMA
records (the recorder registers itself as a global metrics sink), the
bounded :class:`~sieve_torch.metrics.MetricsHistory` trend window, and a
redacted copy of the config. Edge triggers — an op entering SLO burn,
the cold-plane circuit breaker opening, a shard going dark on the
router, or a crash (``sys.excepthook`` + ``threading.excepthook``,
plus ``faulthandler`` for interpreter-level faults) — freeze that
state into a timestamped bundle directory under ``--debug-dir``,
throttled to one bundle per trigger kind per cooldown so a burn storm
cannot fill the disk.

The ``debug`` wire op snapshots the same state inline (no disk, no
throttle), answered by the reader thread like ``metrics`` — a wedged
worker pool still dumps. The bundle format is the reference's, so
its fleet tools read a bundle of either package.
"""

from __future__ import annotations

import collections
import dataclasses
import faulthandler
import json
import os
import sys
import threading
import time
from typing import Any

from sieve_torch import metrics, trace
from sieve_torch.analysis.lockdebug import named_lock

BUNDLE_VERSION = "sieve-debug/1"
FLEET_BUNDLE_VERSION = "sieve-fleet-debug/1"
BUNDLE_FILE = "bundle.json"

TRIGGER_KINDS = ("slo_burn", "breaker_open", "shard_down", "crash", "manual")

# config keys that smell like credentials are masked, never shipped in a
# bundle (bundles leave the machine: fleet_debug, bug reports)
_REDACT_MARKERS = ("secret", "token", "password", "credential", "api_key",
                   "auth")
# event kinds matching any of these substrings count as "last errors"
_ERRORISH = ("error", "failed", "down", "refused", "crash", "burn",
             "unverified", "gap", "drop", "shed", "salvaged")


def redact(obj: Any) -> Any:
    """JSON-safe copy of a config-ish object with secret-looking keys
    masked. Dataclasses flatten to dicts; anything non-JSON becomes its
    repr — a bundle must always serialize."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        try:
            obj = dataclasses.asdict(obj)
        except Exception:  # noqa: BLE001 — unpicklable field values
            obj = dict(vars(obj))
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            key = str(k)
            if any(m in key.lower() for m in _REDACT_MARKERS):
                out[key] = "<redacted>"
            else:
                out[key] = redact(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [redact(v) for v in obj]
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    return repr(obj)


def _errorish(kind: Any) -> bool:
    return isinstance(kind, str) and any(m in kind for m in _ERRORISH)


class FlightRecorder:
    """Continuous bounded capture + edge-triggered postmortem freeze.

    The recorder is cheap while armed: one deque append per metrics
    event (it is a sink), zero cost per span (the tracer ring already
    exists). All the work happens at trigger time — and triggers are
    throttled per kind, so the steady-state overhead stays small."""

    def __init__(
        self,
        role: str,
        *,
        debug_dir: str | None = None,
        history: "metrics.MetricsHistory | None" = None,
        config: Any = None,
        logger: "metrics.MetricsLogger | None" = None,
        cooldown_s: float = 30.0,
        span_tail: int = 256,
        event_tail: int = 256,
        history_window_s: float = 600.0,
        profiler: Any = None,
    ):
        self.role = role
        self.debug_dir = debug_dir
        self.history = history
        # continuous profiler: any object with .snapshot();
        # its collapsed-stack table rides every bundle
        self.profiler = profiler
        self.config = redact(config) if config is not None else None
        self.cooldown_s = cooldown_s
        self.span_tail = span_tail
        self.history_window_s = history_window_s
        self._logger = logger
        self._events: collections.deque = collections.deque(maxlen=event_tail)
        self._last_fire: dict[str, float] = {}
        self._lock = named_lock("FlightRecorder._lock")
        self._installed = False
        self._bundles = 0  # guard: _lock
        self._suppressed = 0  # guard: _lock
        self.last_bundle: dict | None = None  # guard: _lock
        self._sys_hook = None
        self._thread_hook = None
        self._prev_sys_hook = None
        self._prev_thread_hook = None
        self._fault_file = None

    # --- sink protocol (metrics.add_sink) --------------------------------

    def emit(self, record: dict) -> None:
        self._events.append(record)  # deque append: atomic, bounded

    def close(self) -> None:
        pass

    # --- lifecycle -------------------------------------------------------

    def install(self) -> "FlightRecorder":
        """Arm the recorder: register as a global metrics sink and chain
        the crash hooks (previous hooks still run — recorders nest).
        Idempotent; :meth:`uninstall` unwinds."""
        if self._installed:
            return self
        self._installed = True
        metrics.add_sink(self)

        self._prev_sys_hook = sys.excepthook

        def _sys_hook(tp, val, tb):
            if self._installed:
                self._on_crash(tp, val)
            (self._prev_sys_hook or sys.__excepthook__)(tp, val, tb)

        self._sys_hook = _sys_hook
        sys.excepthook = _sys_hook

        self._prev_thread_hook = threading.excepthook

        def _thread_hook(args):
            if self._installed and args.exc_type is not SystemExit:
                self._on_crash(
                    args.exc_type, args.exc_value,
                    thread=getattr(args.thread, "name", None),
                )
            self._prev_thread_hook(args)

        self._thread_hook = _thread_hook
        threading.excepthook = _thread_hook

        if self.debug_dir:
            try:
                os.makedirs(self.debug_dir, exist_ok=True)
                # interpreter-level faults (segfault, deadlock dumps)
                # land next to the bundles the python-level hooks write
                self._fault_file = open(
                    os.path.join(self.debug_dir, "faulthandler.log"), "a"
                )
                faulthandler.enable(file=self._fault_file)
            except OSError:
                self._fault_file = None
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False  # stale chained hooks become pass-through
        metrics.remove_sink(self)
        if sys.excepthook is self._sys_hook:
            sys.excepthook = self._prev_sys_hook or sys.__excepthook__
        if threading.excepthook is self._thread_hook:
            threading.excepthook = self._prev_thread_hook
        if self._fault_file is not None:
            try:
                faulthandler.disable()
                self._fault_file.close()
            except (OSError, ValueError):
                pass
            self._fault_file = None

    def _on_crash(self, tp, val, thread: str | None = None) -> None:
        try:
            self.trigger(
                "crash",
                error=f"{getattr(tp, '__name__', tp)}: {val}",
                thread=thread,
            )
        except Exception:  # noqa: BLE001
            pass  # the recorder must never mask the original failure

    # --- capture ---------------------------------------------------------

    def snapshot(self, trigger: str = "manual",
                 detail: dict | None = None) -> dict:
        """Freeze the current black-box state into one JSON-able bundle
        (no disk, no throttle — the ``debug`` wire op calls this)."""
        tr = trace.get_tracer()
        events = list(self._events)
        rows = (self.history.rows(self.history_window_s)
                if self.history is not None else [])
        profile = (self.profiler.snapshot()
                   if self.profiler is not None else None)
        if profile is not None and self._logger is not None:
            try:
                self._logger.event(
                    "profile_captured", quietable=True, role=self.role,
                    samples=profile.get("samples"),
                    stacks=len(profile.get("stacks") or ()),
                )
            except Exception:  # noqa: BLE001 — snapshots run inline
                pass
        with self._lock:
            bundles, suppressed = self._bundles, self._suppressed
        return {
            "bundle": BUNDLE_VERSION,
            "role": self.role,
            "trigger": trigger,
            "detail": redact(detail) if detail else None,
            "ts": round(trace.now_s(), 4),
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "pid": os.getpid(),
            "config": self.config,
            "spans": tr.tail(self.span_tail),
            "spans_dropped": tr.dropped,
            "events": events,
            "errors": [e for e in events if _errorish(e.get("event"))][-20:],
            "metrics": metrics.registry().snapshot(),
            "history": [{"ts": ts, "metrics": snap} for ts, snap in rows],
            "profile": profile,
            "recorder": {
                "bundles": bundles,
                "suppressed": suppressed,
                "cooldown_s": self.cooldown_s,
                "debug_dir": self.debug_dir,
            },
        }

    def trigger(self, kind: str, **detail: Any) -> dict | None:
        """Edge trigger: freeze a bundle for ``kind``, throttled to one
        per trigger kind per cooldown. Returns the bundle (its ``path``
        key names the directory when ``debug_dir`` is set), or None
        when the cooldown suppressed it."""
        now = trace.now_s()
        with self._lock:
            last = self._last_fire.get(kind)
            if last is not None and now - last < self.cooldown_s:
                self._suppressed += 1
                return None
            self._last_fire[kind] = now
        bundle = self.snapshot(kind, detail or None)
        path = self._write(bundle) if self.debug_dir else None
        bundle["path"] = path
        with self._lock:
            self._bundles += 1
            self.last_bundle = bundle
        if self._logger is not None:
            try:
                self._logger.event("debug_bundle", trigger=kind, path=path)
            except Exception:  # noqa: BLE001 — triggers run on hot paths
                pass
        return bundle

    def _write(self, bundle: dict) -> str | None:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        base = os.path.join(
            self.debug_dir,
            f"bundle-{bundle['trigger']}-{stamp}-{os.getpid()}",
        )
        path, n = base, 0
        while os.path.exists(path):  # same kind, same second: suffix
            n += 1
            path = f"{base}.{n}"
        try:
            os.makedirs(path, exist_ok=True)
            bundle["path"] = path
            with open(os.path.join(path, BUNDLE_FILE), "w") as f:
                json.dump(bundle, f, indent=1)
        except OSError:
            return None  # a full disk must not take the trigger path down
        return path
