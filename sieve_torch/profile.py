"""Always-on statistical profiler: sampled stacks, wire-pullable.

The reference's ``sieve/profile.py``.

The fleet can detect that a shard is slow (the observer's anomaly
engine) and retain the slow request's spans (exemplars), but nothing
answers "where is the CPU actually going?". A :class:`StackProfiler`
runs inside every server and router: a daemon thread samples
``sys._current_frames()`` at a low default rate (``SIEVE_PROF_HZ``,
~19 Hz — deliberately off round scheduler frequencies; 0 disables) and
folds each observed stack into a bounded collapsed-stack table
(stack -> count, drop-coldest on overflow). Each sample is tagged with

* the sampled thread's role — event-loop / worker / writer / sampler,
  derived from the fleet's canonical thread names (the role classes
  the lock sanitizer uses), and
* the tracer's active span label for that thread (``sieve_torch/trace.py``
  keeps a per-thread open-span stack), so a flame cell reads
  ``svc-wire ▸ rpc.query ▸ server._execute_batch_cols``.

Idle parks (a worker waiting on its lane condition, the main thread in
``Event.wait``, the selector blocked in ``select``) are skipped by
default — the table answers "where does the CPU go", not "where do
threads sleep" (``include_idle=True`` keeps them, tagged ``idle``).

The table is served inline by the ``profile`` wire op on both serving
tiers (same contract as ``debug``/``metrics`` — a wedged worker pool
still profiles), snapshotted into every FlightRecorder bundle, and
pulled fleet-wide (merge + top-N self-time + share deltas) and by
the FleetObserver on ``fleet_anomaly``. The module-level helpers (:func:`merge_stacks`,
:func:`collapse_lines`, :func:`self_times`, :func:`diff_shares`) are
the shared math for those tools and the tests.

Locking: one leaf lock guards the fold table and pause/beat counters;
the sampler holds it only to fold already-extracted stacks (never
while walking frames or enumerating threads), and ``snapshot()`` takes
it briefly to copy — safe inline on the wire event loop.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any

from sieve_torch import trace
from sieve_torch.analysis.lockdebug import named_lock

PROFILE_VERSION = "sieve-profile/1"

# ~19 Hz: low enough to be an always-on tax nobody can measure (the
# reference's <=1.05 bench gate prices it), prime-ish so the beat never locks onto
# 10/20/50/100 Hz schedulers or pollers and samples the same frame
DEFAULT_HZ = 19.0
DEFAULT_STACKS = 512
# frames kept per stack, leaf-most wins: deep recursion must not turn
# one sample into an unbounded collapsed key
MAX_DEPTH = 24

# thread-role classes: the canonical thread names across the
# serving plane, mapped to the role the flame's first cell carries
_LOOP_NAMES = ("svc-wire", "router-accept", "router-conn")
_WORKER_MARKS = ("svc-worker",)
_WRITER_MARKS = ("exemplar-writer", "svc-batcher", "svc-follower",
                 "store-compact", "serve-fwd")
_SAMPLER_MARKS = ("prof-sampler", "sieve-observer", "metrics-history")

# leaf frames that mean "parked, not computing": the default profile
# skips these samples entirely (py-spy's --idle model)
_IDLE_LEAVES = frozenset({
    ("threading", "wait"),
    ("threading", "_wait_for_tstate_lock"),
    ("selectors", "select"),
    ("socket", "accept"),
})


def thread_role(name: str) -> str | None:
    """The role class of a thread name, or None when unknown.

    ``main`` covers each process's MainThread (parked on the drain
    event in a serving process — visible only with ``include_idle``).
    """
    if any(name.startswith(p) for p in _LOOP_NAMES):
        return "loop"
    if any(m in name for m in _WORKER_MARKS):
        return "worker"
    if any(m in name for m in _WRITER_MARKS):
        return "writer"
    if any(m in name for m in _SAMPLER_MARKS):
        return "sampler"
    if name == "MainThread":
        return "main"
    return None


def thread_label(name: str) -> str:
    """Flame-cell label for a thread: its name with any trailing
    ``-<digits>`` instance suffix stripped, so ``svc-worker-hot-0`` and
    ``svc-worker-hot-3`` fold into one ``svc-worker-hot`` cell."""
    base = name.rstrip("0123456789")
    if base != name and base.endswith("-"):
        return base[:-1]
    return name


def _frame_label(code: Any) -> str:
    """``<module>.<function>`` for one frame's code object."""
    fn = code.co_filename
    base = os.path.basename(fn)
    if base.endswith(".py"):
        base = base[:-3]
    return f"{base}.{code.co_name}"


def _walk_stack(frame: Any) -> list[str]:
    """Root-first frame labels, leaf-most :data:`MAX_DEPTH` kept."""
    labels: list[str] = []  # leaf-first while walking
    while frame is not None and len(labels) < MAX_DEPTH:
        labels.append(_frame_label(frame.f_code))
        frame = frame.f_back
    labels.reverse()
    return labels


class StackProfiler:
    """Sampling profiler daemon + bounded collapsed-stack fold table."""

    def __init__(
        self,
        role: str,
        *,
        hz: float = DEFAULT_HZ,
        max_stacks: int = DEFAULT_STACKS,
        include_idle: bool = False,
    ) -> None:
        if not (isinstance(hz, (int, float)) and not isinstance(hz, bool)
                and hz >= 0):
            raise ValueError(f"profiler hz must be >= 0, got {hz!r}")
        self.role = role
        self.hz = float(hz)
        self.max_stacks = max(1, int(max_stacks))
        self.include_idle = bool(include_idle)
        self._lock = named_lock("StackProfiler._lock")
        self._table: dict[str, list] = {}  # guard: _lock — collapsed
        #   stack key -> [count, role-or-None]
        self._beats = 0        # guard: _lock — sampling iterations run
        self._samples = 0      # guard: _lock — thread samples folded
        self._evicted = 0      # guard: _lock — drop-coldest evictions
        self._paused_beats = 0  # guard: _lock — beats left to skip
        self._pauses = 0       # guard: _lock — pause() calls (chaos)
        self._t0 = time.time()
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None  # guard: _lock

    # --- lifecycle -------------------------------------------------------

    def start(self) -> "StackProfiler":
        """Spawn the sampler daemon. Idempotent; a no-op at ``hz=0``."""
        if self.hz <= 0:
            return self
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"prof-sampler-{self.role}",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Retire the sampler daemon. Idempotent; the fold table stays
        readable after stop (bundles freeze it post-drain)."""
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            self._stop_evt.set()
            t.join(timeout=5)

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None

    def pause(self, beats: int = 1) -> None:
        """Skip the next ``beats`` sampling beats (the ``svc_prof_gap``
        chaos kind rides this: a dropped profile reply plus one silent
        beat, healed by the next pull)."""
        with self._lock:
            self._paused_beats = max(self._paused_beats, int(beats))
            self._pauses += 1

    def _run(self) -> None:
        period = 1.0 / self.hz
        while not self._stop_evt.wait(period):
            with self._lock:
                if self._thread is None:
                    return
                if self._paused_beats > 0:
                    self._paused_beats -= 1
                    continue
            self.sample_once()

    # --- sampling --------------------------------------------------------

    def sample_once(self) -> int:
        """Take one sampling beat across every thread; returns how many
        thread samples folded in. Exposed so tests drive deterministic
        beats without a live daemon."""
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        folded: list[tuple[str, str | None]] = []
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # the profiler never profiles its own beat
            code = frame.f_code
            idle = (os.path.splitext(os.path.basename(code.co_filename))[0],
                    code.co_name) in _IDLE_LEAVES
            if idle and not self.include_idle:
                continue
            name = names.get(tid) or f"tid-{tid}"
            role = thread_role(name)
            span = trace.active_label(tid)
            cells = [thread_label(name)]
            if span:
                cells.append(span)
            if idle:
                cells.append("idle")
            cells.extend(_walk_stack(frame))
            folded.append((";".join(cells), role))
        with self._lock:
            self._beats += 1
            for key, role in folded:
                ent = self._table.get(key)
                if ent is not None:
                    ent[0] += 1
                else:
                    if len(self._table) >= self.max_stacks:
                        self._evict_coldest_locked()
                    self._table[key] = [1, role]
                self._samples += 1
        return len(folded)

    def _evict_coldest_locked(self) -> None:  # holds: _lock
        # O(table) scan, but only on overflow of a table bounded at
        # max_stacks — at 19 Hz this is noise
        coldest = min(self._table, key=lambda k: self._table[k][0])
        del self._table[coldest]
        self._evicted += 1

    # --- reads -----------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-able profile document (the ``profile`` wire op and
        the FlightRecorder bundle embed call this inline)."""
        with self._lock:
            stacks = [
                {"stack": k, "count": v[0], "role": v[1]}
                for k, v in self._table.items()
            ]
            beats, samples = self._beats, self._samples
            evicted, pauses = self._evicted, self._pauses
        stacks.sort(key=lambda r: (-r["count"], r["stack"]))
        return {
            "profile": PROFILE_VERSION,
            "role": self.role,
            "hz": self.hz,
            "pid": os.getpid(),
            "ts": round(time.time() - self._t0, 3),
            "beats": beats,
            "samples": samples,
            "evicted": evicted,
            "pauses": pauses,
            "stacks": stacks,
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "beats": self._beats,
                "samples": self._samples,
                "stacks": len(self._table),
                "evicted": self._evicted,
                "pauses": self._pauses,
                "running": self._thread is not None,
            }


# --- fleet merge / report math (fleet_profile, fleet_top, tests) -----------


def merge_stacks(profiles: list[tuple[str, dict]]) -> dict[str, dict]:
    """Merge per-process profile documents into one table.

    ``profiles`` is ``[(process_label, snapshot_doc), ...]``; each
    stack key is prefixed with its process label so the merged flame
    keeps one cell per process. Returns ``key -> {"count", "role"}``.
    """
    out: dict[str, dict] = {}
    for label, doc in profiles:
        for row in (doc or {}).get("stacks") or []:
            key = f"{label};{row['stack']}"
            ent = out.get(key)
            if ent is None:
                out[key] = {"count": int(row["count"]),
                            "role": row.get("role")}
            else:
                ent["count"] += int(row["count"])
    return out


def collapse_lines(merged: dict[str, dict]) -> list[str]:
    """Flamegraph-compatible collapsed lines (``stack count``), hottest
    first — ``flamegraph.pl`` / speedscope load the joined text."""
    rows = sorted(merged.items(), key=lambda kv: (-kv[1]["count"], kv[0]))
    return [f"{k} {v['count']}" for k, v in rows]


def self_times(merged: dict[str, dict], n: int = 0) -> list[dict]:
    """Per-frame SELF-time table from a merged (or single) stack table.

    A frame's self count is the samples where it was the LEAF — time
    spent in the frame itself, not in callees. Rows carry the frame's
    share of all samples; ``n`` > 0 keeps the top n."""
    self_counts: dict[str, int] = {}
    total = 0
    for key, ent in merged.items():
        leaf = key.rsplit(";", 1)[-1]
        self_counts[leaf] = self_counts.get(leaf, 0) + ent["count"]
        total += ent["count"]
    rows = [
        {"frame": f, "self": c,
         "share": (c / total) if total else 0.0}
        for f, c in self_counts.items()
    ]
    rows.sort(key=lambda r: (-r["self"], r["frame"]))
    return rows[:n] if n > 0 else rows


def diff_shares(old: dict[str, dict], new: dict[str, dict],
                n: int = 0) -> list[dict]:
    """Per-frame self-time SHARE deltas between two captures.

    Shares (not raw counts) so captures of different lengths compare;
    positive delta = the frame got hotter. Sorted most-positive first;
    ``n`` > 0 keeps the top n by absolute delta."""
    a = {r["frame"]: r["share"] for r in self_times(old)}
    b = {r["frame"]: r["share"] for r in self_times(new)}
    rows = [
        {"frame": f, "before": a.get(f, 0.0), "after": b.get(f, 0.0),
         "delta": b.get(f, 0.0) - a.get(f, 0.0)}
        for f in set(a) | set(b)
    ]
    rows.sort(key=lambda r: (-r["delta"], r["frame"]))
    if n > 0:
        rows = sorted(rows, key=lambda r: -abs(r["delta"]))[:n]
        rows.sort(key=lambda r: (-r["delta"], r["frame"]))
    return rows


def role_tagged_fraction(merged: dict[str, dict]) -> float:
    """Fraction of merged samples whose thread carried a known role tag
    (the acceptance bar: >= 0.9 on a loaded fleet)."""
    total = tagged = 0
    for ent in merged.values():
        total += ent["count"]
        if ent.get("role"):
            tagged += ent["count"]
    return (tagged / total) if total else 0.0


__all__ = [
    "DEFAULT_HZ",
    "DEFAULT_STACKS",
    "PROFILE_VERSION",
    "StackProfiler",
    "collapse_lines",
    "diff_shares",
    "merge_stacks",
    "role_tagged_fraction",
    "self_times",
    "thread_label",
    "thread_role",
]
