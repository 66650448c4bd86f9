"""The port's tiered segment store against the reference's.

Counterparts of tests/test_store.py:50-245. The wheel-210 codec gives
byte-equal payloads and side masks in both packages; the same sequence
of ``put_*`` calls on each package's store leaves byte-equal data files
and pointers and equal ``export_counts``, and a store written by one
package is read by the other; every behaviour case (tiers and restart,
the small-prime side mask, ledger import, a chaos-torn write skipped
and retried, a second handle following appends and compaction, the
tier-2 cap's downgrade, and the index demoting evicted chunks and
reading them back) runs on both packages.
"""

import math
import os
import sys
import threading
import types

import numpy as np
import pytest

import sieve.backends.cpu_numpy as ref_cpu
import sieve.bitset as ref_bitset
import sieve.chaos as ref_chaos
import sieve.checkpoint as ref_checkpoint
import sieve.config as ref_config
import sieve.coordinator as ref_coordinator
import sieve.metrics as ref_metrics
import sieve.seed as ref_seed
import sieve.service.index as ref_index
import sieve.service.store as ref_store
import sieve_torch.backends.cpu_numpy as cpu
import sieve_torch.bitset as bitset
import sieve_torch.chaos as chaos
import sieve_torch.checkpoint as checkpoint
import sieve_torch.config as config
import sieve_torch.coordinator as coordinator
import sieve_torch.metrics as metrics
import sieve_torch.seed as seed
import sieve_torch.service.index as index
import sieve_torch.service.store as store

PKGS = {
    "port": types.SimpleNamespace(
        cpu=cpu, bitset=bitset, chaos=chaos, checkpoint=checkpoint, config=config,
        coordinator=coordinator, metrics=metrics, seed=seed, index=index,
        store=store, backend="cuda", extra={"device": "cpu"}),
    "reference": types.SimpleNamespace(
        cpu=ref_cpu, bitset=ref_bitset, chaos=ref_chaos, checkpoint=ref_checkpoint,
        config=ref_config, coordinator=ref_coordinator, metrics=ref_metrics,
        seed=ref_seed, index=ref_index, store=ref_store, backend="cpu-numpy",
        extra={}),
}
P = ref_seed.seed_primes(100_000)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def o_primes(lo, hi):
    return P[(P >= lo) & (P < hi)].astype(np.int64)


def _flags(pkg, packing, lo, hi):
    return pkg.cpu.sieve_segment_flags(packing, lo, hi,
                                       pkg.seed.seed_primes(math.isqrt(hi - 1)))


def _store(pkg, root, **kw):
    kw.setdefault("settings", pkg.store.StoreSettings(compact_s=0.0))
    return pkg.store.TieredSegmentStore(root, **kw)


def _events(sink):
    return lambda kind, quietable=False, **f: sink.append({"event": kind, "ts": 0.0, **f})


# --- the wheel-210 codec --------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(0, 500), (2, 211), (1000, 1999), (209, 421),
                                   (4200, 4200), (2, 100_000), (99_000, 100_000)])
def test_wheel210_bytes_equal_the_reference(lo, hi):
    vals = o_primes(lo, hi)
    payload, mask = bitset.pack_wheel210(lo, hi, vals)
    assert (payload, mask) == ref_bitset.pack_wheel210(lo, hi, vals)
    back = bitset.unpack_wheel210(lo, hi, payload, mask)
    assert np.array_equal(back, vals)
    assert np.array_equal(back, ref_bitset.unpack_wheel210(lo, hi, payload, mask))
    if hi > lo:
        assert len(payload) == 6 * ((hi - 1) // 210 - lo // 210 + 1)


@pytest.mark.parametrize("values,lo,hi,payload", [
    ([2, 3, 25], 0, 100, None),
    ([], 0, 2000, b"\x00"),
])
def test_wheel210_refusals_equal_the_reference(values, lo, hi, payload):
    if payload is None:
        call = lambda mod: mod.pack_wheel210(lo, hi, np.array(values, dtype=np.int64))
    else:
        call = lambda mod: mod.unpack_wheel210(lo, hi, payload, 0)
    with pytest.raises(ValueError) as want:
        call(ref_bitset)
    with pytest.raises(ValueError) as got:
        call(bitset)
    assert str(got.value) == str(want.value)


# --- the same puts, the same bytes ------------------------------------------------


def _script(pkg, root, packing):
    """A fixed sequence of every put_* kind on one store; returns its export."""
    layout = pkg.bitset.get_layout(packing)
    with _store(pkg, root, writer=True) as st:
        st.import_ledger([(2, 1000, 168), (1000, 2000, 135)])
        st.put_count(5000, 6000, int(o_primes(5000, 6000).size))
        st.put_flags(1050, 2940, _flags(pkg, packing, 1050, 2940), layout)
        st.put_flags(2, 5000, _flags(pkg, packing, 2, 5000), layout)
        st.put_boundary(6000, 7000, 117, 0x1234, 0xBEEF)
        st.put_values(7000, 9000, o_primes(7000, 9000), layout)
        st.put_flags(1050, 2940, _flags(pkg, packing, 1050, 2940), layout)  # duplicate
        return st.export_counts()


@pytest.mark.parametrize("packing", ["plain", "odds", "wheel30"])
def test_same_puts_give_byte_equal_files(tmp_path, packing):
    got = _script(PKGS["port"], tmp_path / "port", packing)
    want = _script(PKGS["reference"], tmp_path / "ref", packing)
    assert got == want
    for name in ("segstore.json", "segstore_000001.dat"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    # and each package reads the other's store
    for mine, other in (("port", "ref"), ("reference", "port")):
        pkg = PKGS[mine]
        layout = pkg.bitset.get_layout(packing)
        with _store(pkg, tmp_path / other, writer=False) as rd:
            assert rd.export_counts() == want
            assert np.array_equal(rd.load_values(7000, 9000), o_primes(7000, 9000))
            assert np.array_equal(rd.load_flags(2, 5000, layout),
                                  _flags(pkg, packing, 2, 5000))


def test_compaction_bytes_equal_the_reference(tmp_path):
    for name, pkg in PKGS.items():
        with _store(pkg, tmp_path / name, writer=True,
                    settings=pkg.store.StoreSettings(compact_s=0.0, t2_bytes=200)) as st:
            layout = pkg.bitset.get_layout("odds")
            st.put_count(1050, 2940, 1)
            for lo in (1050, 3150, 5250):
                st.put_flags(lo, lo + 1890, _flags(pkg, "odds", lo, lo + 1890), layout)
            assert st.compact_once(force=True)
    for f in ("segstore.json", "segstore_000002.dat"):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "reference" / f).read_bytes()
    assert not (tmp_path / "port" / "segstore_000001.dat").exists()


# --- behaviour, on both packages ------------------------------------------------


def test_tiers_and_restart_persistence(tmp_path, pkg):
    layout = pkg.bitset.get_layout("odds")
    lo, hi = 1050, 2940
    flags = _flags(pkg, "odds", lo, hi)
    with _store(pkg, tmp_path, writer=True) as st:
        st.put_count(5000, 6000, int(o_primes(5000, 6000).size))
        assert st.put_flags(lo, hi, flags, layout)
        assert not st.put_flags(lo, hi, flags, layout)  # duplicate: no churn
        assert st.get_entry(5000, 6000)[0] == 0
        assert st.get_entry(lo, hi)[0] == 2
        assert np.array_equal(st.load_values(lo, hi), o_primes(lo, hi))
        s = st.stats()
        assert s["entries"] == {0: 1, 1: 0, 2: 1}
        assert s["demotions"] == 1 and s["writer"]
    with _store(pkg, tmp_path, writer=True) as st2:
        assert st2.stats()["entries"] == {0: 1, 1: 0, 2: 1}
        assert np.array_equal(st2.load_flags(lo, hi, layout), flags)
        assert st2.stats()["hits"] == 1


def test_low_range_small_mask_roundtrip(tmp_path, pkg):
    for packing in ("odds", "wheel30", "plain"):
        layout = pkg.bitset.get_layout(packing)
        flags = _flags(pkg, packing, 2, 5000)
        with _store(pkg, tmp_path / packing, writer=True) as st:
            assert st.put_flags(2, 5000, flags, layout)
            assert np.array_equal(st.load_flags(2, 5000, layout), flags)


def test_import_ledger_idempotent(tmp_path, pkg):
    entries = [(2, 1000, 168), (1000, 2000, 135)]
    with _store(pkg, tmp_path, writer=True) as st:
        assert st.import_ledger(entries) == 2
        assert st.import_ledger(entries) == 0
        assert st.get_entry(2, 1000) == (0, 168, 0, 0)
        assert [e[:3] for e in st.export_counts()] == entries


def test_torn_write_skipped_counted_retried(tmp_path, pkg):
    layout = pkg.bitset.get_layout("odds")
    events = []
    sched = pkg.chaos.ChaosSchedule(pkg.chaos.parse_chaos("store_torn_write:any@s2"))
    flags = _flags(pkg, "odds", 1050, 2940)
    with _store(pkg, tmp_path, writer=True, chaos=sched, events=_events(events)) as st:
        st.put_count(5000, 6000, 101)                          # append 1: clean
        assert not st.put_flags(1050, 2940, flags, layout)     # append 2: torn
        assert st.get_entry(1050, 2940) is None
        assert st.load_values(1050, 2940) is None
        s = st.stats()
        assert s["torn_writes"] == 1 and s["torn"] == 1 and s["demotions"] == 0
        assert st.put_flags(1050, 2940, flags, layout)         # the retry lands
        assert np.array_equal(st.load_values(1050, 2940), o_primes(1050, 2940))
    assert [e["event"] for e in events].count("store_torn_entry") == 1
    for e in events:
        pkg.metrics.validate_record(e)
    with _store(pkg, tmp_path, writer=False) as rd:
        assert rd.stats()["torn"] == 1
        assert np.array_equal(rd.load_values(1050, 2940), o_primes(1050, 2940))


def test_cross_handle_append_follow(tmp_path, pkg):
    layout = pkg.bitset.get_layout("odds")
    flags = _flags(pkg, "odds", 1050, 2940)
    with _store(pkg, tmp_path, writer=True) as wr, \
            _store(pkg, tmp_path, writer=False) as rd:
        assert wr.put_flags(1050, 2940, flags, layout)
        rd.maybe_refresh(force=True)
        assert rd.get_entry(1050, 2940)[0] == 2
        assert np.array_equal(rd.load_values(1050, 2940), o_primes(1050, 2940))
        assert not rd.writer


def test_compaction_reclaims_and_peers_follow(tmp_path, pkg):
    layout = pkg.bitset.get_layout("odds")
    flags = _flags(pkg, "odds", 1050, 2940)
    events = []
    with _store(pkg, tmp_path, writer=True, events=_events(events)) as wr, \
            _store(pkg, tmp_path, writer=False) as rd:
        wr.put_count(1050, 2940, int(o_primes(1050, 2940).size))
        assert wr.put_flags(1050, 2940, flags, layout)  # supersedes tier 0
        assert wr.stats()["dead_bytes"] > 0
        g0 = wr.stats()["gen"]
        assert wr.compact_once(force=True)
        s = wr.stats()
        assert s["gen"] == g0 + 1 and s["compactions"] == 1
        assert s["dead_bytes"] == 0 and s["entries"] == {0: 0, 1: 0, 2: 1}
        rd.maybe_refresh(force=True)
        assert rd.stats()["gen"] == g0 + 1
        assert np.array_equal(rd.load_values(1050, 2940), o_primes(1050, 2940))
        assert not rd.compact_once(force=True)  # readers never compact
    comp = [e for e in events if e["event"] == "store_compacted"]
    assert len(comp) == 1 and comp[0]["live"] == 1
    pkg.metrics.validate_record(comp[0])


def test_t2_cap_downgrades_oldest(tmp_path, pkg):
    layout = pkg.bitset.get_layout("odds")
    with _store(pkg, tmp_path, writer=True,
                settings=pkg.store.StoreSettings(compact_s=0.0, t2_bytes=1)) as st:
        for lo in (1050, 3150):
            assert st.put_flags(lo, lo + 1890, _flags(pkg, "odds", lo, lo + 1890),
                                layout)
        assert st.compact_once(force=True)
        s = st.stats()
        assert s["downgraded"] >= 1 and s["entries"][1] >= 1
        tier, count, _, _ = st.get_entry(1050, 2940)
        assert tier == 1 and count == int(o_primes(1050, 2940).size)
        assert st.load_values(1050, 2940) is None


def test_background_compactor_runs_and_stops(tmp_path, pkg):
    settings = pkg.store.StoreSettings(compact_s=0.01, compact_ratio=0.0,
                                       min_compact_bytes=1)
    layout = pkg.bitset.get_layout("odds")
    with _store(pkg, tmp_path, writer=True, settings=settings) as st:
        st.put_count(1050, 2940, 1)
        st.put_flags(1050, 2940, _flags(pkg, "odds", 1050, 2940), layout)
        st.start()
        st.start()  # idempotent
        for _ in range(500):
            if st.stats()["compactions"]:
                break
            st._stop.wait(0.01)
        assert st.stats()["compactions"] >= 1
    assert st._compactor is None


def test_threads_share_one_store_and_a_reader_follows(tmp_path):
    """More writer threads than cores demote chunks into one store (some
    the same chunk twice) while a second handle follows, under a short
    switch interval: every chunk lands exactly once and reads back exact."""
    pkg = PKGS["port"]
    layout = pkg.bitset.get_layout("odds")
    chunks = [(lo, lo + 997) for lo in range(1_000, 1_000 + 997 * 24, 997)]
    flags = {c: _flags(pkg, "odds", *c) for c in chunks}
    nthreads = 2 * (os.cpu_count() or 1) + 2
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _store(pkg, tmp_path, writer=True) as st, \
                _store(pkg, tmp_path, writer=False) as rd:
            def work(k):
                for c in chunks[k % 3::3]:
                    st.put_flags(*c, flags[c], layout)
                    rd.maybe_refresh(force=True)

            threads = [threading.Thread(target=work, args=(k,)) for k in range(nthreads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            s = st.stats()
            assert s["entries"][2] == len(chunks) == s["demotions"]
            assert s["appends"] == len(chunks)  # no chunk was appended twice
            rd.maybe_refresh(force=True)
            for c in chunks:
                assert np.array_equal(rd.load_values(*c), o_primes(*c))
    finally:
        sys.setswitchinterval(old)


def test_settings_from_env_equal_the_reference(monkeypatch):
    monkeypatch.setenv("SIEVE_STORE_FSYNC", "1")
    monkeypatch.setenv("SIEVE_STORE_COMPACT_S", "0.5")
    monkeypatch.setenv("SIEVE_STORE_T2_BYTES", "4096")
    got = store.StoreSettings.from_env()
    assert got.__dict__ == ref_store.StoreSettings.from_env().__dict__
    monkeypatch.setenv("SIEVE_STORE_T2_BYTES", "lots")
    with pytest.raises(ValueError, match="SIEVE_STORE_T2_BYTES"):
        store.StoreSettings.from_env()


# --- the index demotes into the store ---------------------------------------------


def test_index_evictions_demote_and_hit_store(tmp_path, pkg):
    cfg = pkg.config.SieveConfig(n=50_000, backend=pkg.backend, packing="odds",
                                 n_segments=4, quiet=True,
                                 checkpoint_dir=str(tmp_path / "ck"), **pkg.extra)
    pkg.coordinator.run_local(cfg)
    ledger = pkg.checkpoint.Ledger.open_readonly(cfg)
    segs = sorted(ledger.completed().values(), key=lambda r: r.lo)
    QueryCtx = pkg.index.QueryCtx
    with _store(pkg, tmp_path / "store", writer=True) as st:
        idx = pkg.index.SieveIndex("odds", ledger.completed(), lru_segments=1, store=st)
        c1 = QueryCtx()
        f1 = idx.get_flags(segs[0].lo, segs[0].hi, c1)
        assert c1.materialized
        idx.get_flags(segs[1].lo, segs[1].hi, QueryCtx())  # evicts seg 0 -> demote
        assert st.stats()["demotions"] >= 1
        c3 = QueryCtx()
        f3 = idx.get_flags(segs[0].lo, segs[0].hi, c3)
        assert c3.store_hit and not c3.materialized and c3.source() == "index"
        assert np.array_equal(f1, f3)
        assert idx.store_hits == 1 and idx.materialized == 2
