"""The port's lock-order sanitizer against the reference's.

With ``SIEVE_LOCK_DEBUG`` unset the named constructors return the plain
``threading`` primitives; set, they return the recording wrappers. The
same scripted acquisitions (nesting, reentry, a condition's wait,
releases out of order, the port's own store, index and metrics objects)
leave equal ``observed_pairs`` and equal ``check_static_consistency``
findings in both packages. The port's copy of the canonical order equals
the reference's, and every lock the port names appears in it.
"""

import ast
import threading
from pathlib import Path

import numpy as np
import pytest

import sieve.analysis.lockdebug as ref_ld
import sieve.backends.cpu_numpy as ref_cpu
import sieve.bitset as ref_bitset
import sieve.chaos as ref_chaos
import sieve.metrics as ref_metrics
import sieve.service.index as ref_index
import sieve.service.store as ref_store
import sieve_torch.analysis.lockdebug as ld
import sieve_torch.backends.cpu_numpy as cpu
import sieve_torch.bitset as bitset
import sieve_torch.chaos as chaos
import sieve_torch.metrics as metrics
import sieve_torch.service.index as index
import sieve_torch.service.store as store
from sieve.analysis.model import CANONICAL_LOCK_ORDER as REF_ORDER
from sieve_torch.analysis.model import CANONICAL_LOCK_ORDER

PKG = Path(__file__).resolve().parent.parent / "sieve_torch"
BOTH = {"port": ld, "reference": ref_ld}


@pytest.fixture
def debug_on(monkeypatch):
    monkeypatch.setenv("SIEVE_LOCK_DEBUG", "1")
    for mod in BOTH.values():
        mod.recorder().reset()
    yield
    for mod in BOTH.values():
        mod.recorder().reset()


# the port's kernel-library locks, which the reference has no counterpart
# of: each is taken on every launch, under ColdBackend._lock on the cold plane
PORT_ONLY_LOCKS = ("build._lock", "cpu_native._lock")


def test_canonical_order_equals_the_reference():
    """The reference's order, with the port's own locks inserted below
    ColdBackend._lock."""
    shared = tuple(n for n in CANONICAL_LOCK_ORDER if n not in PORT_ONLY_LOCKS)
    assert shared == REF_ORDER
    assert len(set(CANONICAL_LOCK_ORDER)) == len(CANONICAL_LOCK_ORDER)
    for name in PORT_ONLY_LOCKS:
        assert (CANONICAL_LOCK_ORDER.index("ColdBackend._lock")
                < CANONICAL_LOCK_ORDER.index(name)), name


def _named_in_port():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id in ("named_lock", "named_rlock", "named_condition")
                    and node.args and isinstance(node.args[0], ast.Constant)):
                names.append((path.relative_to(PKG.parent).as_posix(), node.args[0].value))
    return names


def test_every_named_lock_of_the_port_is_in_the_order():
    names = _named_in_port()
    assert len(names) >= 20  # the scan found the port's locks
    missing = [(f, n) for f, n in names if n not in CANONICAL_LOCK_ORDER]
    assert not missing
    found = {n for _, n in names}
    for want in ("seed._cache_lock", "Tracer._lock", "ChaosSchedule._lock",
                 "_Cluster.lock", "_Cluster.tele_lock", "PrepPipeline._cond",
                 "MetricsHistory._lock", "TieredSegmentStore._lock",
                 "BitsetLRU._lock", "SieveIndex._stat_lock", "FlightRecorder._lock",
                 "StackProfiler._lock", "ExemplarSampler._io_cond",
                 *PORT_ONLY_LOCKS):
        assert want in found, want


def test_flag_off_gives_plain_primitives(monkeypatch):
    monkeypatch.delenv("SIEVE_LOCK_DEBUG", raising=False)
    for mod in BOTH.values():
        assert type(mod.named_lock("a")) is type(threading.Lock())
        assert type(mod.named_rlock("a")) is type(threading.RLock())
        assert type(mod.named_condition("a")) is threading.Condition
    monkeypatch.setenv("SIEVE_LOCK_DEBUG", "0")
    assert type(ld.named_lock("a")) is type(threading.Lock())


def test_flag_on_gives_recording_wrappers(debug_on):
    for mod in BOTH.values():
        lock, rlock, cond = (mod.named_lock("a"), mod.named_rlock("b"),
                             mod.named_condition("c"))
        assert type(lock).__name__ == "_DebugLock" and lock.name == "a"
        assert type(rlock).__name__ == "_DebugRLock"
        assert type(cond).__name__ == "_DebugCondition"
        with lock:
            assert lock.locked() and mod.recorder().holds("a")
        assert not lock.locked() and not mod.recorder().holds("a")


def _script(mod):
    """Scripted acquisitions on one package's named primitives."""
    a, b, c = mod.named_lock("A"), mod.named_lock("B"), mod.named_lock("C")
    r = mod.named_rlock("R")
    cond = mod.named_condition("K")
    with a:
        with b:
            with c:
                pass
    with r:
        with r:  # reentry: no (R, R) self-pair
            with a:
                pass
    a.acquire()
    b.acquire()
    a.release()  # out of order
    c.acquire()
    c.release()
    b.release()
    with cond:
        with b:
            pass
        cond.wait(0.001)  # releases and re-acquires K
        cond.notify_all()
    with c:
        with a:  # an inversion of A -> C
            pass
    done = threading.Event()

    def other():
        with b:
            with a:
                pass
        done.set()

    threading.Thread(target=other).start()
    assert done.wait(10)
    return mod.observed_pairs()


def test_scripted_pairs_equal_the_reference(debug_on):
    got, want = _script(ld), _script(ref_ld)
    assert got == want
    assert ("A", "B") in got and ("C", "A") in got and ("R", "R") not in got
    order = ("R", "K", "A", "B", "C")
    assert ld.check_static_consistency(order) == ref_ld.check_static_consistency(order)
    assert any("C -> A" in p for p in ld.check_static_consistency(order))
    # the default order knows none of these names: each is a finding
    assert ld.check_static_consistency() == ref_ld.check_static_consistency()


def _store_script(tmp_path, st_mod, idx_mod, bs, cp, ch, mt):
    """The store and the index under chaos, events to a metrics logger's
    sinks: the nested acquisitions the data plane really makes."""
    sink = mt.MemorySink()
    mt.add_sink(sink)
    try:
        reg = mt.MetricsRegistry()
        events = lambda kind, quietable=False, **f: sink.emit(  # noqa: E731
            {"event": kind, **f}) or reg.counter(kind).inc()
        sched = ch.ChaosSchedule(ch.parse_chaos("store_torn_write:any@s2"))
        st = st_mod.TieredSegmentStore(tmp_path, writer=True, chaos=sched,
                                       events=events,
                                       settings=st_mod.StoreSettings(compact_s=0.0))
        layout = bs.get_layout("odds")
        seeds = np.array([3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53])
        entries = [(2, 1000, 168), (1000, 3000, 262)]
        st.import_ledger(entries)
        idx = idx_mod.SieveIndex("odds", [], lru_segments=1, store=st)
        for lo, hi in ((1050, 2940), (2940, 3000), (1050, 2940)):
            idx.lru.put(lo, hi, cp.sieve_segment_flags("odds", lo, hi, seeds))
        st.maybe_refresh(force=True)
        st.compact_once(force=True)
        st.close()
        return sorted(e["event"] for e in sink.records)
    finally:
        mt.remove_sink(sink)


def test_data_plane_pairs_equal_the_reference(debug_on, tmp_path):
    got_events = _store_script(tmp_path / "port", store, index, bitset, cpu, chaos,
                               metrics)
    got = ld.observed_pairs()
    want_events = _store_script(tmp_path / "ref", ref_store, ref_index, ref_bitset,
                                ref_cpu, ref_chaos, ref_metrics)
    want = ref_ld.observed_pairs()
    assert got_events == want_events and "store_torn_entry" in got_events
    assert got == want
    assert ("TieredSegmentStore._lock", "ChaosSchedule._lock") in got
    assert ld.check_static_consistency() == ref_ld.check_static_consistency() == []
