"""Tail-sampled exemplar retention, the reference's
``sieve/service/exemplar.py``.

Without it tracing is all-or-nothing: either ``--trace`` captures
every event (too heavy to leave on) or nothing is kept and a slow
request's spans are gone by the time anyone asks. Tail sampling flips
the decision to request *completion*, when the outcome is known: the
tracer's always-on exemplar ring (``sieve_torch/trace.py``) holds the recent
ctx-carrying spans cheaply, and this module's :class:`ExemplarSampler`
decides which requests' span trees are worth keeping —

* every request that ended typed-error / shed / degraded / demoted
  (the ``reason="error"`` / ``"flagged"`` rules — 100% retention, the
  acceptance bar),
* any request whose latency exceeded the sampler's own rolling p95
  times ``exemplar_slack`` (armed only after ``exemplar_warmup``
  observations — a cold window has no percentile), and
* a deterministic 1-in-``exemplar_baseline`` healthy baseline, so a
  report always has normal requests to diff the outliers against.

Kept exemplars are JSON records ``{ts, role, ctx, op, outcome, ms,
reason, spans, ...}`` committed to a bounded in-memory ring (served
inline by the ``exemplars`` wire op — the router pulls shard-side
exemplars so a slow route and its downstream query land in one file)
and, when a ``debug_dir`` is set, appended to a size-capped rolling
``exemplars.jsonl`` (at the cap the file rotates to ``.1``; one
generation of history survives). The record format is the
reference's, so its ``tools/trace_report.py --exemplars`` renders a file
of either package.

Both the service and the router embed one sampler (``role`` tells the
records apart in a merged file). Locking: ``_lock`` guards the decision
window and the kept ring (in-memory only — safe under the wire loop's
inline ``exemplars`` op); file appends are taken fully off the request
path — ``keep()`` only enqueues the record under ``_io_cond`` and a
lazy daemon writer thread drains the queue to disk, so a kept request
never pays the rotate+append (kept requests ARE the slow tail; a sync
write there lands exactly on the p95 the overhead gate measures).
``_io_cond`` is never held together with ``_lock``, and the writer
releases it before touching the file. ``flush()`` blocks until the
queue is drained — tests and shutdown call it before reading the file.
"""

from __future__ import annotations

import bisect
import collections
import json
import math
import os
import threading
import time
from typing import Any

from sieve_torch.analysis.lockdebug import named_condition, named_lock

EXEMPLAR_FILE = "exemplars.jsonl"

# span ring armed on the process tracer when exemplar sampling is on:
# spans are collected at request completion (microseconds after they
# were recorded), so the ring only needs to cover the spans of the
# handful of requests in flight at once — 2048 is ~500 requests deep
EXEMPLAR_SPAN_RING = 2048


class ExemplarSampler:
    """Completion-time retention decider + kept-exemplar sink."""

    def __init__(
        self,
        role: str,
        *,
        slack: float = 2.0,
        baseline: int = 100,
        window: int = 256,
        warmup: int = 30,
        ring: int = 256,
        file_bytes: int = 4 << 20,
        debug_dir: str | None = None,
        logger: Any = None,
    ) -> None:
        self.role = role
        self._slack = float(slack)
        self._baseline = max(1, int(baseline))
        self._warmup = max(0, int(warmup))
        self._file_bytes = max(1, int(file_bytes))
        self._dir = debug_dir
        self._logger = logger
        self._lock = named_lock("ExemplarSampler._lock")
        self._io_cond = named_condition("ExemplarSampler._io_cond")
        self._window: collections.deque = collections.deque(
            maxlen=max(1, int(window))
        )  # guard: _lock — recent terminal latencies (ms), arrival order
        self._sorted: list = []  # guard: _lock — same values, kept sorted
        #                          (decide() runs per request; re-sorting
        #                          256 floats there is the p95 overhead)
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(ring))
        )  # guard: _lock — kept exemplar records
        self._seen = 0      # guard: _lock
        self._kept = 0      # guard: _lock
        self._pending: list = []   # guard: _io_cond — records awaiting disk
        self._draining = False     # guard: _io_cond — writer mid-batch
        self._io_stop = False      # guard: _io_cond
        self._flush_req = False    # guard: _io_cond — skip the coalesce nap
        self._coalesce_s = 0.25    # guard: none(set once; writer-only read)
        self._writer: threading.Thread | None = None  # guard: _io_cond — lazy
        self._rotations = 0  # guard: none(written by the writer thread
        #                      only; stats() reads are advisory)

    # --- decision --------------------------------------------------------

    def decide(self, outcome: str, elapsed_ms: float,
               flagged: bool = False) -> str | None:
        """Retention reason for one completed request, or None to drop.

        ``flagged`` marks conditions the outcome string alone cannot
        carry (a demoted re-run, a degraded reply that still said ok).
        Only healthy latencies fold into the rolling window — an error
        storm (shed 0 ms replies, deadline blowups) must not move the
        slow-tail threshold — and the p95 is computed from observations
        *before* this one, so a request can never excuse itself."""
        with self._lock:
            self._seen += 1
            seen = self._seen
            ns = len(self._sorted)
            p95 = (self._sorted[max(0, math.ceil(0.95 * ns) - 1)]
                   if ns >= max(1, self._warmup) else None)
            if outcome == "ok":
                v = float(elapsed_ms)
                if len(self._window) == self._window.maxlen:
                    old = self._window.popleft()
                    del self._sorted[bisect.bisect_left(self._sorted, old)]
                self._window.append(v)
                bisect.insort(self._sorted, v)
        if outcome != "ok":
            return "error"
        if flagged:
            return "flagged"
        if p95 is not None:
            if elapsed_ms > p95 * self._slack:
                return "slow"
        # deterministic healthy baseline: request 1, 1+N, 1+2N, ... —
        # the very first request is always an exemplar
        if (seen - 1) % self._baseline == 0:
            return "baseline"
        return None

    # --- commit ----------------------------------------------------------

    def keep(self, record: dict) -> dict:
        """Commit one kept exemplar: stamp it, ring it, and hand it to
        the writer thread (rolling-file append + the
        ``service_exemplar_kept`` event). Returns the stamped record
        (callers embed it in tests/replies)."""
        rec = dict(record)
        rec["role"] = self.role
        rec.setdefault("ts", time.time())
        with self._lock:
            self._kept += 1
            self._ring.append(rec)
        # the file append AND the kept-event emit ride the writer
        # thread: keep() runs on the request path of exactly the slow
        # requests the overhead gate prices, so the only synchronous
        # work is the ring append above
        self._enqueue_file(rec)
        return rec

    def _enqueue_file(self, rec: dict) -> None:
        if self._dir is None and self._logger is None:
            return
        with self._io_cond:
            if self._io_stop:
                return
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop,
                    name=f"exemplar-writer-{self.role}", daemon=True,
                )
                self._writer.start()
            self._pending.append(rec)
            if len(self._pending) == 1:
                # later keeps skip the notify: the writer is already
                # awake (napping on its coalesce deadline) and a wake
                # per keep is a context switch billed to the request
                self._io_cond.notify()

    def _writer_loop(self) -> None:
        while True:
            with self._io_cond:
                while not self._pending and not self._io_stop:
                    self._io_cond.wait()
                if not self._pending and self._io_stop:
                    return
                # coalesce: keeps arrive in bursts (an error storm, a
                # cold batch) — napping briefly turns N wake+write
                # cycles into one, keeping the writer's GIL/disk time
                # away from the requests being served right now; only
                # flush()/close() cut the nap short (keep() notifies
                # land as spurious wakes and loop back to the deadline)
                nap_until = time.monotonic() + self._coalesce_s
                while not (self._io_stop or self._flush_req):
                    left = nap_until - time.monotonic()
                    if left <= 0:
                        break
                    self._io_cond.wait(left)
                batch = self._pending
                self._pending = []
                self._draining = True
            # file I/O + event emit outside the condition: a slow disk
            # or console must never stall a keep() enqueue (only this
            # thread touches the file)
            for rec in batch:
                if self._dir is not None:
                    self._write_line(rec)
                if self._logger is not None:
                    self._logger.event(
                        "service_exemplar_kept", quietable=True,
                        role=self.role, ctx=rec.get("ctx"),
                        op=rec.get("op"), outcome=rec.get("outcome"),
                        reason=rec.get("reason"), ms=rec.get("ms"),
                        spans=len(rec.get("spans") or ()),
                    )
            with self._io_cond:
                self._draining = False
                if not self._pending:
                    self._flush_req = False
                self._io_cond.notify_all()

    def _write_line(self, rec: dict) -> None:
        path = os.path.join(self._dir, EXEMPLAR_FILE)
        line = json.dumps(rec) + "\n"
        try:
            os.makedirs(self._dir, exist_ok=True)
            # rotate BEFORE appending: the live file stays under the
            # cap and a kept exemplar is never split across files
            try:
                if os.path.getsize(path) + len(line) > self._file_bytes:
                    os.replace(path, path + ".1")
                    self._rotations += 1
            except OSError:
                pass  # no file yet
            with open(path, "a", encoding="utf-8") as f:
                f.write(line)
        except OSError:
            # a full/readonly disk must never fail the request that
            # was merely being sampled; the in-memory ring still has
            # the exemplar for the wire op
            pass

    def flush(self, timeout_s: float = 5.0) -> None:
        """Block until every enqueued exemplar has reached the file (or
        the timeout lapses). Readers of ``exemplars.jsonl`` in the same
        process — tests, shutdown — call this first."""
        if self._dir is None and self._logger is None:
            return
        deadline = time.monotonic() + timeout_s
        with self._io_cond:
            if self._pending or self._draining:
                self._flush_req = True
                self._io_cond.notify_all()
            while self._pending or self._draining:
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._io_cond.wait(left)

    def close(self) -> None:
        """Drain the queue and retire the writer thread. Idempotent;
        keeps after close still land in the in-memory ring but are no
        longer written to disk."""
        with self._io_cond:
            self._io_stop = True
            self._io_cond.notify_all()
            writer = self._writer
        if writer is not None:
            writer.join(timeout=5)

    # --- reads -----------------------------------------------------------

    def tail(self, n: int | None = None,
             ctx_prefix: str | None = None) -> list[dict]:
        """Newest kept exemplars (all when ``n`` is None), optionally
        filtered by ``ctx`` prefix. In-memory only: safe inline on the
        wire event loop."""
        with self._lock:
            recs = list(self._ring)
        if ctx_prefix:
            recs = [r for r in recs
                    if str(r.get("ctx", "")).startswith(ctx_prefix)]
        if n is not None and n >= 0:
            recs = recs[-n:]
        return recs

    def stats(self) -> dict:
        with self._lock:
            return {"seen": self._seen, "kept": self._kept,
                    "ring": len(self._ring)}


def load_exemplars(path: str) -> list[dict]:
    """Parse an ``exemplars.jsonl`` (or its ``.1`` rotation), skipping a
    torn tail line — the file is appended live and a reader must never
    crash on the record being written."""
    out: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail (or foreign junk): skip, keep going
            if isinstance(rec, dict):
                out.append(rec)
    return out


__all__ = [
    "EXEMPLAR_FILE",
    "EXEMPLAR_SPAN_RING",
    "ExemplarSampler",
    "load_exemplars",
]
