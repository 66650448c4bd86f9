"""Host-side span tracing, the reference's ``sieve/trace.py``.

One process-wide :class:`Tracer` times named spans on any thread::

    from sieve_torch import trace
    with trace.span("round.drain", round=k):
        ...

Aggregation is always on: every span's duration folds into a ``name ->
(total_seconds, count)`` table, which is what ``run_mesh`` reads its
``host_phases`` from (``snapshot`` before the run, ``since`` after it).
Event capture is opt-in (``trace.enable()`` / ``--trace FILE``): each span
then also appends a Chrome trace-event record, and ``save`` writes
``{"traceEvents": [...]}`` for Perfetto or ``chrome://tracing``.

Every timestamp is ``time.perf_counter()`` relative to one process-wide
epoch (``now_s``), so spans, instants, counters and metrics events share
one timeline. A cluster worker captures into a bounded drop-oldest ring
(``set_event_limit`` / ``drain_events``) and ships its events on its
replies; the coordinator rebases them with :class:`ClockAlign` and folds
them in with ``ingest``, so one ``--trace`` file holds every process.

``device_span`` times the work queued on a device inside it: on a card
by a pair of CUDA events, turned into a span by ``flush_device_spans``
after the fetch that waits for them; on the CPU by the host clock. It
costs nothing while capture is off, and its spans go on a track of
their own per device (``device_track``), never on the issuing thread's.
``mirror_to_profiler`` makes every span a ``torch.profiler``
record_function range too, for an operator's profiler session.

For the service plane the tracer also keeps each thread's open-span
stack (``active_label``, the profiler's span tag), a second bounded ring
of request-scoped spans (those whose args carry a ``ctx``) that the
exemplar sampler collects at request completion (``exemplar_enable`` /
``exemplar_collect``), and ``tail``, ``pending``, ``reset`` and
``total_s``.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, TextIO

from sieve_torch.analysis.lockdebug import named_lock

# one monotonic epoch for the whole process
_EPOCH = time.perf_counter()

# every captured event carries the process id: read once, and again in a
# forked child (getpid is a system call: ~23 us each under gVisor)
_PID = os.getpid()


def _refresh_pid() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_refresh_pid)


def now_s() -> float:
    """Seconds since the process trace epoch (monotonic)."""
    return time.perf_counter() - _EPOCH


# While an operator's torch.profiler session runs (the CLI's
# ``--profile-dir``), every span is also entered as a record_function
# range, so the profile shows the port's spans on the kernels' own clock.
# None (the default) mirrors nothing; only ``mirror_to_profiler`` sets it.
_MIRROR = None


def mirror_to_profiler(on: bool) -> None:
    """Mirror every span into torch.profiler as a record_function range
    (``on``), or stop. Set only around a profiler session that records
    host activity; a profiler of the card alone must never see them."""
    global _MIRROR
    if on:
        from torch.profiler import record_function

        _MIRROR = record_function
    else:
        _MIRROR = None


# Device spans have tracks of their own in the capture, one per device,
# on fixed tids that no thread has (thread idents are addresses): the CPU
# on DEVICE_TID, card i on DEVICE_TID + 1 + i.
DEVICE_TID = 9000


def device_track(device) -> tuple[int, str]:
    """The (tid, track name) of a device's spans, e.g. ``cuda:0 (events)``."""
    dev = str(device)
    if dev.startswith("cuda"):
        index = int(dev.partition(":")[2] or _current_card())
        return DEVICE_TID + 1 + index, f"cuda:{index} (events)"
    return DEVICE_TID, "cpu (events)"


def _current_card() -> int:
    import torch

    return torch.cuda.current_device()


def _cuda_event():
    """A timing CUDA event (a stub in tests)."""
    import torch

    return torch.cuda.Event(enable_timing=True)


def _current_stream(device):
    import torch

    return torch.cuda.current_stream(device)


# Per-thread open-span stacks, the profiler's span tag: each thread only
# ever mutates its own list with single GIL-atomic dict/list operations,
# so neither the span hot path nor the sampler's cross-thread read locks.
_ACTIVE_SPANS: dict[int, list] = {}


def active_label(tid: int | None = None) -> str | None:
    """The innermost open span name on thread ``tid`` (calling thread when
    None), or None. A race with the owner's push/pop yields a stale label,
    never a crash."""
    stack = _ACTIVE_SPANS.get(tid if tid is not None else threading.get_ident())
    if not stack:
        return None
    try:
        return stack[-1]
    except IndexError:
        return None  # owner popped between the check and the read


def _ex_root(ctx: str) -> str:
    """The root request context of a span ctx, ``run_id/seq.attempt`` (the
    first two ``/``-separated parts): every span of one request tree shares
    it, so it is the exemplar ring's bucket key."""
    first = ctx.find("/")
    if first < 0:
        return ctx
    second = ctx.find("/", first + 1)
    return ctx if second < 0 else ctx[:second]


class Span:
    """Context manager for one timed span; ``elapsed`` (seconds) is valid
    after ``__exit__``. While an operator's profiler session mirrors the
    port's spans (:func:`mirror_to_profiler`), the span is also a
    ``torch.profiler.record_function`` range around the timed interval."""

    __slots__ = ("_tracer", "name", "args", "t0", "elapsed", "_stack", "_range")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.elapsed = 0.0

    def __enter__(self) -> "Span":
        tid = threading.get_ident()
        stack = _ACTIVE_SPANS.get(tid)
        if stack is None:
            stack = _ACTIVE_SPANS[tid] = []
        stack.append(self.name)
        self._stack = stack
        mirror = _MIRROR
        self._range = None if mirror is None else mirror(self.name).__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.elapsed = t1 - self.t0
        if self._stack:
            self._stack.pop()
        self._tracer._record(self.name, self.t0 - _EPOCH, t1 - _EPOCH, self.args)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False


class DeviceSpan:
    """One :meth:`Tracer.device_span` with capture or the mirror on."""

    __slots__ = ("_tracer", "name", "device", "args", "_on_card", "_start",
                 "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, device, args: dict | None):
        self._tracer = tracer
        self.name = name
        self.device = device
        self.args = args
        self._on_card = str(device).startswith("cuda")
        self._start = self._t0 = None

    def __enter__(self) -> "DeviceSpan":
        mirror = _MIRROR
        self._range = None if mirror is None else mirror(self.name).__enter__()
        if self._tracer.enabled:
            if self._on_card:
                self._start = _cuda_event()
                self._start.record(_current_stream(self.device))
            else:
                self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._start is not None:
            end = _cuda_event()
            end.record(_current_stream(self.device))
            self._tracer._pend((self.name, device_track(self.device),
                                self._start, end, self.args))
        elif self._t0 is not None:
            t1 = time.perf_counter()
            self._tracer._record(self.name, self._t0 - _EPOCH, t1 - _EPOCH,
                                 self.args, device_track(self.device))
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False


class _NoSpan:
    """The shared do-nothing device span (capture and mirror off)."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class Tracer:
    """Thread-safe span tracer with always-on aggregation and optional
    Chrome trace-event capture."""

    def __init__(self) -> None:
        self._lock = named_lock("Tracer._lock")
        self.enabled = False
        self._events: list[dict] = []  # guard: _lock
        self._totals: dict[str, list] = {}  # guard: _lock; name -> [s, count]
        self._tids_named: set[int] = set()
        # bounded capture (telemetry shipping): at most this many events,
        # the oldest non-metadata event dropped on overflow
        self._max_events: int | None = None
        self._dropped = 0
        # counter tracks are sampled: at most one event per track per
        # interval, however often the instrument changes
        self._counter_interval_us = 10_000.0
        self._counter_seen: dict[str, float] = {}
        # exemplar capture: a second bounded ring of request-scoped spans
        # (args carry a ``ctx``), fed whether or not capture is on and
        # bucketed by root request context, so a keep collects one
        # request's spans; eviction drops whole oldest-request buckets.
        # Entries are raw tuples of atomic values (GC-untracked). 0 = off.
        self._ex_limit = 0  # guard: _lock
        self._ex_spans: collections.OrderedDict[str, list[tuple]] = \
            collections.OrderedDict()  # guard: _lock
        self._ex_count = 0  # guard: _lock
        self._ex_dropped = 0  # guard: _lock
        # device spans whose CUDA events the card has not passed yet:
        # (name, track, start event, end event, args)
        self._device_pending: list[tuple] = []  # guard: _lock

    # --- recording -----------------------------------------------------------

    def span(self, name: str, **args: Any) -> Span:
        return Span(self, name, args or None)

    def _record(self, name: str, t0: float, t1: float, args: dict | None,
                track: tuple[int, str] | None = None) -> None:
        # t0/t1 are epoch-relative seconds (the ``now_s()`` clock); a
        # device span names its device's track
        with self._lock:
            tot = self._totals.get(name)
            if tot is None:
                tot = self._totals[name] = [0.0, 0]
            tot[0] += t1 - t0
            tot[1] += 1
            if self.enabled:
                self._append_event(name, t0, t1, args, track)
            if self._ex_limit and args and "ctx" in args:
                root = _ex_root(str(args["ctx"]))
                bucket = self._ex_spans.get(root)
                if bucket is None:
                    bucket = self._ex_spans[root] = []
                bucket.append((name, t0, t1, threading.get_ident(),
                               str(args["ctx"]), tuple(args.items())))
                self._ex_count += 1
                self._ex_trim_locked()

    def add_span(self, name: str, t0: float, duration_s: float, **args: Any) -> None:
        """Record an already-measured interval (``t0`` is a :func:`now_s`
        value), e.g. a device-idle window observed rather than entered."""
        self._record(name, t0, t0 + duration_s, args or None)

    def add_device_span(self, name: str, device, t0: float, duration_s: float,
                        **args: Any) -> None:
        """Record an interval the device timed (CUDA events) on that
        device's track; ``t0`` is where it is placed on the :func:`now_s`
        clock."""
        self._record(name, t0, t0 + duration_s, args or None, device_track(device))

    def device_span(self, name: str, device, **args: Any):
        """A span of the work queued on ``device`` inside it, on the
        device's own track. With capture off it records no event and
        reads no clock (and, unless the profiler mirror is on, is a shared
        no-op). With capture on, on a card, it records a pair of timing
        CUDA events on the current stream, which
        :meth:`flush_device_spans` turns into a span once the card has
        passed them; on the CPU, whose ops run as they are issued, it
        times them with the host clock."""
        if not self.enabled and _MIRROR is None:
            return _NO_SPAN
        return DeviceSpan(self, name, device, args or None)

    def _pend(self, entry: tuple) -> None:
        with self._lock:
            self._device_pending.append(entry)

    def flush_device_spans(self) -> None:
        """Turn every pending device span the card has passed into a span.
        Called after a synchronising fetch, so a segment's spans are all
        done. Durations are the events' own; on the host clock each is
        placed so that the newest on its device ends now."""
        if not self._device_pending:
            return
        with self._lock:
            pending, self._device_pending = self._device_pending, []
        done, waiting = [], []
        for p in pending:
            (done if p[3].query() else waiting).append(p)
        if waiting:
            with self._lock:
                self._device_pending[:0] = waiting
        now = now_s()
        newest = {p[1]: p[3] for p in done}
        for name, track, start, end, args in done:
            back = start.elapsed_time(newest[track]) / 1e3
            t0 = now - back
            self._record(name, t0, t0 + start.elapsed_time(end) / 1e3, args, track)

    def instant(self, name: str, **args: Any) -> None:
        """Zero-duration marker (heartbeats, joins, resume points)."""
        if not self.enabled:
            return
        with self._lock:
            if not self.enabled:
                return
            self._events.append({
                "name": name,
                "ph": "i",
                "s": "t",
                "ts": round((time.perf_counter() - _EPOCH) * 1e6, 3),
                "pid": _PID,
                "tid": threading.get_ident(),
                **({"args": args} if args else {}),
            })
            self._trim()

    def counter(self, name: str, value: float) -> None:
        """Sample a counter or gauge onto the timeline, at most once per
        track per interval (the first sample of a track always lands)."""
        if not self.enabled:
            return
        ts = (time.perf_counter() - _EPOCH) * 1e6
        last = self._counter_seen.get(name)
        if last is not None and ts - last < self._counter_interval_us:
            return
        ts = round(ts, 3)
        with self._lock:
            if not self.enabled:
                return
            self._counter_seen[name] = ts
            self._events.append({
                "name": name,
                "ph": "C",
                "ts": ts,
                "pid": _PID,
                "tid": threading.get_ident(),
                "args": {"value": value},
            })
            self._trim()

    def _append_event(self, name: str, t0: float, t1: float,
                      args: dict | None,
                      track: tuple[int, str] | None = None) -> None:
        # caller holds the lock
        tid = threading.get_ident() if track is None else track[0]
        if tid not in self._tids_named:
            self._tids_named.add(tid)
            self._events.append({
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": tid,
                "args": {"name": threading.current_thread().name
                         if track is None else track[1]},
            })
        ev = {
            "name": name,
            "ph": "X",
            "ts": round(t0 * 1e6, 3),
            "dur": round((t1 - t0) * 1e6, 3),
            "pid": _PID,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        self._events.append(ev)
        self._trim()

    def _trim(self) -> None:
        # caller holds the lock; metadata ("M") events name the tracks
        # every surviving event needs, so they are never evicted
        if self._max_events is None:
            return
        while len(self._events) > self._max_events:
            for i, e in enumerate(self._events):
                if e.get("ph") != "M":
                    del self._events[i]
                    self._dropped += 1
                    break
            else:
                return  # only metadata left

    # --- control / export ----------------------------------------------------

    def enable(self, clear: bool = True) -> None:
        """Start capturing events; by default the buffer is cleared so each
        capture session stands alone (aggregation totals are kept)."""
        with self._lock:
            if clear:
                self._events.clear()
                self._tids_named.clear()
                self._counter_seen.clear()
                self._dropped = 0
            self.enabled = True

    def disable(self) -> None:
        with self._lock:
            self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._totals.clear()
            self._tids_named.clear()
            self._counter_seen.clear()
            self._dropped = 0
            self._ex_spans.clear()
            self._ex_count = 0
            self._ex_dropped = 0
            self._device_pending.clear()

    def set_event_limit(self, max_events: int | None) -> None:
        """Bound the capture buffer to ``max_events`` (None = unbounded);
        overflow drops the oldest non-metadata event and counts it."""
        with self._lock:
            self._max_events = max_events
            self._trim()

    @property
    def dropped(self) -> int:
        """Events evicted by the ring limit since the last fresh enable."""
        with self._lock:
            return self._dropped

    def pending(self) -> int:
        """Captured events not yet drained."""
        with self._lock:
            return len(self._events)

    def drain_events(self) -> tuple[list[dict], int]:
        """Take (and clear) the captured events; returns ``(events,
        cumulative_dropped)``. Track names already shipped are not sent
        again: the consumer accumulates successive drains in order."""
        with self._lock:
            events, self._events = self._events, []
            return events, self._dropped

    def ingest(self, events: list[dict]) -> None:
        """Merge foreign, already-rebased events (a worker's telemetry):
        complete spans fold into the totals, and the events join the
        buffer when capture is on (the ring limit does not apply)."""
        with self._lock:
            for e in events:
                if e.get("ph") == "X":
                    tot = self._totals.get(e["name"])
                    if tot is None:
                        tot = self._totals[e["name"]] = [0.0, 0]
                    tot[0] += e.get("dur", 0.0) / 1e6
                    tot[1] += 1
                if self.enabled:
                    self._events.append(e)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def tail(self, n: int) -> list[dict]:
        """The newest ``n`` captured events without draining (the flight
        recorder's span tail); empty when capture is off or ``n`` <= 0."""
        if n <= 0:
            return []
        with self._lock:
            return self._events[-n:]

    # --- exemplar capture ------------------------------------------------------

    def _ex_trim_locked(self) -> None:
        while self._ex_count > self._ex_limit:
            root = next(iter(self._ex_spans))
            bucket = self._ex_spans[root]
            if len(self._ex_spans) == 1:
                # one request owns the whole ring: age its oldest spans
                # individually instead of dropping its live tree
                n_drop = self._ex_count - self._ex_limit
                del bucket[:n_drop]
                self._ex_count -= n_drop
                self._ex_dropped += n_drop
                return
            del self._ex_spans[root]
            self._ex_count -= len(bucket)
            self._ex_dropped += len(bucket)

    def exemplar_enable(self, limit: int) -> None:
        """Arm the exemplar ring: keep the newest ``limit`` ctx-carrying
        spans. Independent of :meth:`enable`; ``limit <= 0`` disarms and
        clears."""
        with self._lock:
            self._ex_limit = max(0, limit)
            if self._ex_limit == 0:
                self._ex_spans.clear()
                self._ex_count = 0
            else:
                self._ex_trim_locked()

    def exemplar_disable(self) -> None:
        self.exemplar_enable(0)

    def exemplar_collect(self, ctx_prefix: str | None = None) -> list[dict]:
        """Spans in the exemplar ring whose ``args.ctx`` starts with
        ``ctx_prefix`` (all when None), oldest request first, as complete
        trace events. Non-draining. A full request ctx is one bucket lookup;
        a bare run-id prefix scans the buckets."""
        pid = _PID

        def mat(e: tuple) -> dict:
            name, t0, t1, tid, _ctx, pairs = e
            return {"name": name, "ph": "X", "ts": round(t0 * 1e6, 3),
                    "dur": round((t1 - t0) * 1e6, 3), "pid": pid, "tid": tid,
                    "args": dict(pairs)}

        with self._lock:
            if ctx_prefix is None:
                return [mat(e) for bucket in self._ex_spans.values() for e in bucket]
            if "/" in ctx_prefix:
                bucket = self._ex_spans.get(_ex_root(ctx_prefix))
                if not bucket:
                    return []
                return [mat(e) for e in bucket if e[4].startswith(ctx_prefix)]
            out: list[dict] = []
            for root, bucket in self._ex_spans.items():
                if root.startswith(ctx_prefix):
                    out.extend(mat(e) for e in bucket if e[4].startswith(ctx_prefix))
            return out

    @property
    def exemplar_dropped(self) -> int:
        with self._lock:
            return self._ex_dropped

    def save(self, path_or_file: str | TextIO) -> None:
        """Write the captured events as Chrome trace-event JSON."""
        doc = {"traceEvents": self.events(), "displayTimeUnit": "ms"}
        if hasattr(path_or_file, "write"):
            json.dump(doc, path_or_file)
        else:
            with open(path_or_file, "w") as f:
                json.dump(doc, f)

    # --- aggregation ---------------------------------------------------------

    def snapshot(self) -> dict[str, tuple[float, int]]:
        """Copy of the (total_seconds, count) aggregate per span name."""
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._totals.items()}

    def since(self, snap: dict[str, tuple[float, int]]
              ) -> dict[str, tuple[float, int]]:
        """Aggregate delta since a :meth:`snapshot` (per-run accounting)."""
        out: dict[str, tuple[float, int]] = {}
        for name, (tot, cnt) in self.snapshot().items():
            b_tot, b_cnt = snap.get(name, (0.0, 0))
            if cnt > b_cnt:
                out[name] = (tot - b_tot, cnt - b_cnt)
        return out

    def total_s(self, name: str,
                snap: dict[str, tuple[float, int]] | None = None) -> float:
        agg = self.since(snap) if snap is not None else self.snapshot()
        return agg.get(name, (0.0, 0))[0]


class ClockAlign:
    """NTP-style clock alignment against one remote process.

    Each exchange gives four timestamps, each on its own process's epoch:
    local send, remote receive, remote send, local done. The sample with
    the smallest round trip gives the offset (ties refresh to the newest,
    tracking drift); the error bound is half that round trip.
    ``remote_clock ~= local_clock + offset_s``.
    """

    __slots__ = ("offset_s", "rtt_s", "samples")

    def __init__(self) -> None:
        self.offset_s = 0.0
        self.rtt_s = float("inf")
        self.samples = 0

    def sample(self, t_send: float, t_remote_recv: float,
               t_remote_send: float, t_done: float) -> None:
        rtt = max(0.0, (t_done - t_send) - (t_remote_send - t_remote_recv))
        self.samples += 1
        if rtt <= self.rtt_s:
            self.rtt_s = rtt
            self.offset_s = ((t_remote_recv - t_send) + (t_remote_send - t_done)) / 2

    @property
    def err_s(self) -> float:
        """Worst-case offset error: half the best round trip seen."""
        return self.rtt_s / 2 if self.samples else float("inf")


# the process-wide tracer and the module-level calls every site uses
_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, **args: Any) -> Span:
    return Span(_TRACER, name, args or None)


def add_span(name: str, t0: float, duration_s: float, **args: Any) -> None:
    _TRACER.add_span(name, t0, duration_s, **args)


def add_device_span(name: str, device, t0: float, duration_s: float,
                    **args: Any) -> None:
    _TRACER.add_device_span(name, device, t0, duration_s, **args)


def device_span(name: str, device, **args: Any):
    return _TRACER.device_span(name, device, **args)


def flush_device_spans() -> None:
    _TRACER.flush_device_spans()


def instant(name: str, **args: Any) -> None:
    _TRACER.instant(name, **args)


def counter(name: str, value: float) -> None:
    _TRACER.counter(name, value)


def enable() -> None:
    _TRACER.enable()


def disable() -> None:
    _TRACER.disable()


def enabled() -> bool:
    return _TRACER.enabled


def save(path_or_file: str | TextIO) -> None:
    _TRACER.save(path_or_file)


def set_event_limit(max_events: int | None) -> None:
    _TRACER.set_event_limit(max_events)


def drain_events() -> tuple[list[dict], int]:
    return _TRACER.drain_events()


def pending_events() -> int:
    return _TRACER.pending()


def ingest(events: list[dict]) -> None:
    _TRACER.ingest(events)


def tail(n: int) -> list[dict]:
    return _TRACER.tail(n)


def exemplar_enable(limit: int) -> None:
    _TRACER.exemplar_enable(limit)


def exemplar_collect(ctx_prefix: str | None = None) -> list[dict]:
    return _TRACER.exemplar_collect(ctx_prefix)


def snapshot() -> dict[str, tuple[float, int]]:
    return _TRACER.snapshot()


def since(snap: dict[str, tuple[float, int]]) -> dict[str, tuple[float, int]]:
    return _TRACER.since(snap)


def total_s(name: str, snap: dict[str, tuple[float, int]] | None = None) -> float:
    return _TRACER.total_s(name, snap)
