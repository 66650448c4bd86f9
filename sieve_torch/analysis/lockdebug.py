"""Runtime lock-order sanitizer, the reference's ``sieve/analysis/lockdebug.py``.

``named_lock/named_rlock/named_condition`` construct the port's locks.
The name is the lock's identity: ``Class.attr`` or ``modulebase.name``
of the declaration site, the same names the reference gives its
counterparts, so observed orders of both packages read alike.

With ``SIEVE_LOCK_DEBUG`` unset (the default) the constructors return
plain :mod:`threading` primitives: the flag is read once, at
construction time, and the hot path costs nothing. With
``SIEVE_LOCK_DEBUG=1`` they return recording wrappers that keep a
per-thread stack of held names and fold every acquisition into a
global (held, acquired) pair set; :func:`check_static_consistency`
then checks the observed orders against ``CANONICAL_LOCK_ORDER``
(sieve_torch/analysis/model.py).
"""

from __future__ import annotations

import threading


def _enabled() -> bool:
    from sieve_torch import env

    return env.env_flag("SIEVE_LOCK_DEBUG", False)


class _Recorder:
    """Global acquisition-order observations, keyed by lock name.

    Pair counts are deduplicated per thread: each (held, acquired)
    order folds into the global set once per observing thread, so the
    steady-state cost of a hot, already-seen nesting is a thread-local
    set lookup — never the global mutex. Counts therefore mean "how
    many threads observed this order", not "how many times"; the
    consistency check only needs the pair *set*."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._pairs: dict[tuple[str, str], int] = {}
        self._tls = threading.local()
        self._gen = 0  # bumped by reset() to invalidate per-thread dedup

    def _stack(self) -> list[str]:
        tls = self._tls
        try:
            return tls.stack
        except AttributeError:
            st = tls.stack = []
            return st

    def _fold(self, tls, st: list[str], name: str) -> None:
        """Record (held, name) for every held lock, deduped per thread."""
        seen = getattr(tls, "seen", None)
        if seen is None or tls.gen != self._gen:
            seen = tls.seen = set()
            tls.gen = self._gen
        for held in st:
            k = (held, name)
            if k not in seen:
                seen.add(k)
                with self._mu:
                    self._pairs[k] = self._pairs.get(k, 0) + 1

    def note_acquire(self, name: str) -> None:
        st = self._stack()
        if st:
            self._fold(self._tls, st, name)
        st.append(name)

    def note_release(self, name: str) -> None:
        st = self._stack()
        # LIFO is the overwhelmingly common case; non-LIFO releases
        # are legal for bare acquire()/release() — drop the innermost
        # matching entry
        if st and st[-1] == name:
            st.pop()
            return
        for i in range(len(st) - 1, -1, -1):
            if st[i] == name:
                del st[i]
                return

    def holds(self, name: str) -> bool:
        return name in self._stack()

    def observed_pairs(self) -> dict[tuple[str, str], int]:
        with self._mu:
            return dict(self._pairs)

    def reset(self) -> None:
        with self._mu:
            self._pairs.clear()
            self._gen += 1


_RECORDER = _Recorder()


def recorder() -> _Recorder:
    return _RECORDER


class _DebugLock:
    """Recording wrapper with the full Lock surface the code uses.

    ``__enter__``/``__exit__`` inline the recording instead of routing
    through ``acquire``/``release``: every spared Python call layer
    counts on sub-ms requests."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str, inner) -> None:
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            _RECORDER.note_acquire(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        _RECORDER.note_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "_DebugLock":
        self._inner.acquire()
        # note_acquire, inlined: the with-statement path is ~50
        # acquisitions per hot request and each spared call layer counts
        rec = _RECORDER
        tls = rec._tls
        try:
            st = tls.stack
        except AttributeError:
            st = tls.stack = []
        if st:
            rec._fold(tls, st, self.name)
        st.append(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        self._inner.release()
        st = _RECORDER._tls.stack
        if st[-1] == self.name:
            st.pop()
        else:
            _RECORDER.note_release(self.name)
        return False


class _DebugRLock(_DebugLock):
    """Reentrant variant: only the outermost acquire/release records,
    so legal reentry never shows up as a (name, name) self-pair."""

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reentry = _RECORDER.holds(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got and not reentry:
            _RECORDER.note_acquire(self.name)
        elif got:
            self._stack_depth()  # bump the reentry count
        return got

    def _stack_depth(self) -> None:
        depth = getattr(_RECORDER._tls, "rdepth", None)
        if depth is None:
            depth = _RECORDER._tls.rdepth = {}
        depth[self.name] = depth.get(self.name, 0) + 1

    def release(self) -> None:
        self._inner.release()
        depth = getattr(_RECORDER._tls, "rdepth", None) or {}
        if depth.get(self.name, 0) > 0:
            depth[self.name] -= 1
        else:
            _RECORDER.note_release(self.name)

    def __enter__(self) -> "_DebugRLock":
        self.acquire()  # reentry-aware, unlike the base fast path
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class _DebugCondition:
    """Condition wrapper: ``wait`` releases and reacquires the
    underlying lock, and both transitions are recorded — the reacquire
    after a wake is a real acquisition against whatever else the
    thread still holds."""

    def __init__(self, name: str, inner: threading.Condition) -> None:
        self.name = name
        self._inner = inner

    def acquire(self, *args) -> bool:
        got = self._inner.acquire(*args)
        if got:
            _RECORDER.note_acquire(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        _RECORDER.note_release(self.name)

    def __enter__(self) -> "_DebugCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def wait(self, timeout: float | None = None) -> bool:
        _RECORDER.note_release(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            _RECORDER.note_acquire(self.name)

    def wait_for(self, predicate, timeout: float | None = None):
        _RECORDER.note_release(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _RECORDER.note_acquire(self.name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


def named_lock(name: str):
    if not _enabled():
        return threading.Lock()
    return _DebugLock(name, threading.Lock())


def named_rlock(name: str):
    if not _enabled():
        return threading.RLock()
    return _DebugRLock(name, threading.RLock())


def named_condition(name: str):
    if not _enabled():
        return threading.Condition()
    return _DebugCondition(name, threading.Condition())


def observed_pairs() -> dict[tuple[str, str], int]:
    """(held, acquired) -> count, across every named lock so far."""
    return _RECORDER.observed_pairs()


def check_static_consistency(order: tuple[str, ...] | None = None,
                             ) -> list[str]:
    """Compare observed acquisition pairs against the canonical order.

    Returns problem strings (empty = consistent). Locks observed but
    absent from the order are problems too — the static pass should
    know every lock the runtime touches.
    """
    if order is None:
        from sieve_torch.analysis.model import CANONICAL_LOCK_ORDER

        order = CANONICAL_LOCK_ORDER
    idx = {lock: i for i, lock in enumerate(order)}
    problems = []
    for (a, b), n in sorted(_RECORDER.observed_pairs().items()):
        if a == b:
            problems.append(f"self-nesting of {a} ({n}x)")
        elif a not in idx:
            problems.append(f"observed lock {a} not in canonical order")
        elif b not in idx:
            problems.append(f"observed lock {b} not in canonical order")
        elif idx[a] > idx[b]:
            problems.append(
                f"observed {a} -> {b} ({n}x) against the canonical order"
            )
    return problems
