"""Streaming host-prepare pipeline: spec prep off the critical path.

A bounded producer/consumer: a small thread pool prepares round k+window
while round k computes on the device, holding at most ``window + 1``
rounds of preps resident (bounded host memory whatever the round count).

Each worker thread owns its own incremental chain state (a CudaChain),
created by ``make_state`` on first use; a chain's residue advance is
exact for any jump between rounds, so the interleaving of rounds over
threads keeps every prep equal to a from-scratch one. Rounds are claimed
strictly in order and only once a residency slot is free; the consumer
also takes them in order, so the smallest outstanding round is always
being prepared — no deadlock at any (threads, window) combination.

The prep work is numpy, which releases the GIL in its heavy vector ops,
so a couple of threads hide prep behind the device. The thread count is
``SIEVE_PREP_THREADS`` (default: min(capacity, 2)).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Sequence

from sieve_torch import env


class PrepPipeline:
    """Prepare ``rounds`` in order on background threads, bounded residency.

    ``prep_round(state, rnd)`` builds one round's preps using the
    thread-local ``state`` (from ``make_state()``). ``take(rnd)`` must be
    called in the same order as ``rounds``; it blocks until that round is
    ready and releases its residency slot. Worker exceptions re-raise in
    ``take``.
    """

    def __init__(
        self,
        rounds: Sequence[int],
        make_state: Callable[[], Any],
        prep_round: Callable[[Any, int], Any],
        window: int,
        threads: int | None = None,
    ):
        self.rounds = list(rounds)
        self._make_state = make_state
        self._prep = prep_round
        self.capacity = max(1, window + 1)
        if threads is None:
            threads = env.env_int("SIEVE_PREP_THREADS", 0) or min(
                self.capacity, 2
            )
        nthreads = max(1, min(threads, self.capacity, max(1, len(self.rounds))))
        self._cond = threading.Condition()
        self._next = 0          # index into rounds of the next unclaimed round
        self._consumed = 0      # rounds handed back through take()
        self._ready: dict[int, Any] = {}
        self._error: BaseException | None = None
        self._closed = False
        self.states: list[Any] = []  # per-thread chains, for metric harvest
        self.stats = {
            "rounds_prepared": 0,
            "prep_seconds": 0.0,     # summed across threads (cpu-seconds)
            "peak_resident": 0,      # max rounds resident (ready + in-flight)
        }
        self._threads = [
            threading.Thread(target=self._run, daemon=True)
            for _ in range(nthreads if self.rounds else 0)
        ]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        state = self._make_state()
        with self._cond:
            self.states.append(state)
        while True:
            with self._cond:
                while (
                    not self._closed
                    and self._error is None
                    and self._next < len(self.rounds)
                    and self._next - self._consumed >= self.capacity
                ):
                    self._cond.wait()
                if (
                    self._closed
                    or self._error is not None
                    or self._next >= len(self.rounds)
                ):
                    return
                i = self._next
                self._next += 1
                resident = self._next - self._consumed
                if resident > self.stats["peak_resident"]:
                    self.stats["peak_resident"] = resident
                rnd = self.rounds[i]
            t0 = time.perf_counter()
            try:
                prep = self._prep(state, rnd)
            except BaseException as e:  # propagate to the consumer
                with self._cond:
                    self._error = e
                    self._cond.notify_all()
                return
            elapsed = time.perf_counter() - t0
            with self._cond:
                self._ready[rnd] = prep
                self.stats["rounds_prepared"] += 1
                self.stats["prep_seconds"] += elapsed
                self._cond.notify_all()

    def take(self, rnd: int) -> Any:
        """Blocking fetch of round ``rnd``'s preps (call in rounds order)."""
        with self._cond:
            while rnd not in self._ready and self._error is None:
                self._cond.wait()
            if self._error is not None:
                raise self._error
            prep = self._ready.pop(rnd)
            self._consumed += 1
            self._cond.notify_all()
        return prep

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for t in self._threads:
            t.join()
