"""The port's ledger readers and segment index against the reference's.

Counterparts of tests/test_service.py:114-238 and :484. One ledger, written
by the port's counting run (and, for the mixed case, by the reference's),
is opened read-only by both packages: the outcomes are equal, errors
included, by type and by message (a missing ledger, a torn file left
untouched, a foreign config, the file vanishing between the existence
check and the read, a checksum-less version-1 file). Both packages' index
then answer ``count_upto``, ``count_upto_batch``, ``nth``, ``covered_hi``
and ``dropped_segments`` alike, with a hole in the ledger too, and the
``bounds``/``flags_fn`` seam of ``primes_in_range`` served from the
index's chunks gives the plain enumeration.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from sieve.checkpoint import Ledger as RefLedger
from sieve.config import SieveConfig as RefConfig
from sieve.coordinator import run_local as ref_run_local
from sieve.enumerate import primes_in_range as ref_primes_in_range
from sieve.seed import seed_primes as ref_seed_primes
from sieve.service.index import QueryCtx as RefCtx
from sieve.service.index import SieveIndex as RefIndex
from sieve_torch.checkpoint import (
    COLD_SEG_BASE,
    LEDGER_NAME,
    Ledger,
    LedgerCorrupt,
    LedgerMismatch,
)
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.enumerate import primes_in_range
from sieve_torch.service import QueryCtx, SieveIndex

N = 50_000
P = ref_seed_primes(200_000)
PACKINGS = ("plain", "odds", "wheel30")
TW = dict(count_kind="twins", twins=True)  # the ledgers' run


def o_pi(x):
    return int(np.searchsorted(P, x, side="right"))


def _cfg(d, packing="wheel30", **kw):
    base = dict(n=N, backend="cuda", device="cpu", packing=packing, n_segments=4,
                quiet=True, checkpoint_dir=str(d))
    return SieveConfig(**{**base, **kw})


def _ref_cfg(d, packing="wheel30", **kw):
    base = dict(n=N, backend="cpu-numpy", packing=packing, n_segments=4,
                quiet=True, checkpoint_dir=str(d))
    return RefConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def ledgers(tmp_path_factory):
    """One port-written ledger per packing (read-only in the tests)."""
    out = {}
    for packing in PACKINGS:
        d = tmp_path_factory.mktemp(f"idx_{packing}")
        run_local(_cfg(d, packing, **TW))
        out[packing] = d
    return out


def _open_both(d, **kw):
    """(port outcome, reference outcome): the ledger or the raised error."""
    out = []
    for opener, cfg in ((Ledger.open_readonly, _cfg(d, **kw)),
                        (RefLedger.open_readonly, _ref_cfg(d, **kw))):
        try:
            out.append(opener(cfg))
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            out.append(e)
    return out


def _same_outcome(got, want):
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
        return
    assert not isinstance(got, Exception), got
    assert (got.read_only, got.unverified, got.checksum) == (
        want.read_only, want.unverified, want.checksum)
    assert {k: v.to_dict() for k, v in got.completed().items()} == \
        {k: v.to_dict() for k, v in want.completed().items()}
    assert got.store_tier0_entries() == want.store_tier0_entries()


# --- Ledger.open_readonly ---------------------------------------------------------


def test_open_readonly_snapshot_never_flushes(ledgers):
    d = ledgers["wheel30"]
    before = (d / LEDGER_NAME).read_bytes()
    got, want = _open_both(d, **TW)
    _same_outcome(got, want)
    assert got.read_only and len(got.completed()) == 4
    with pytest.raises(LedgerMismatch, match="read-only"):
        got.record(next(iter(got.completed().values())))
    assert (d / LEDGER_NAME).read_bytes() == before


def test_open_readonly_missing_ledger_is_empty(tmp_path):
    got, want = _open_both(tmp_path)
    _same_outcome(got, want)
    assert got.read_only and got.completed() == {} and got.checksum is None


def test_open_readonly_refuses_corruption_without_quarantine(tmp_path, ledgers):
    src = (ledgers["wheel30"] / LEDGER_NAME).read_text()
    path = tmp_path / LEDGER_NAME
    path.write_text(src[: int(len(src) * 0.6)])  # a torn write
    damaged = path.read_text()
    got, want = _open_both(tmp_path, **TW)
    assert isinstance(got, LedgerCorrupt)
    _same_outcome(got, want)
    assert path.read_text() == damaged
    assert not os.path.exists(str(path) + ".quarantined")


def test_open_readonly_refuses_a_checksum_mismatch(tmp_path, ledgers):
    data = json.loads((ledgers["wheel30"] / LEDGER_NAME).read_text())
    data["completed"]["0"]["count"] += 1  # silent bit rot
    (tmp_path / LEDGER_NAME).write_text(json.dumps(data))
    got, want = _open_both(tmp_path, **TW)
    assert isinstance(got, LedgerCorrupt) and "checksum" in str(got)
    _same_outcome(got, want)


def test_open_readonly_refuses_foreign_config(ledgers):
    got, want = _open_both(ledgers["wheel30"], n=2 * N)
    assert isinstance(got, LedgerMismatch)
    _same_outcome(got, want)


def test_open_readonly_toctou_vanish_reads_empty(tmp_path, ledgers, monkeypatch):
    path = tmp_path / LEDGER_NAME
    text = (ledgers["wheel30"] / LEDGER_NAME).read_text()
    orig = Path.read_text

    def vanish_then_read(self, *a, **kw):
        if self.name == LEDGER_NAME and self.exists():
            self.unlink()  # quarantined between the stat and the read
        return orig(self, *a, **kw)

    path.write_text(text)
    monkeypatch.setattr(Path, "read_text", vanish_then_read)
    got = Ledger.open_readonly(_cfg(tmp_path, **TW))
    monkeypatch.setattr(Path, "read_text", orig)
    path.write_text(text)
    monkeypatch.setattr(Path, "read_text", vanish_then_read)
    want = RefLedger.open_readonly(_ref_cfg(tmp_path, **TW))
    _same_outcome(got, want)
    assert got.read_only and got.completed() == {}


def test_open_readonly_v1_loads_unverified(tmp_path, ledgers):
    data = json.loads((ledgers["wheel30"] / LEDGER_NAME).read_text())
    del data["version"], data["checksum"]  # what an old build wrote
    (tmp_path / LEDGER_NAME).write_text(json.dumps(data))
    got, want = _open_both(tmp_path, **TW)
    _same_outcome(got, want)
    assert got.unverified and got.checksum is not None
    assert len(got.completed()) == 4
    assert not Ledger.open_readonly(_cfg(ledgers["wheel30"], **TW)).unverified


def test_recorded_hi_and_cold_seg_base(tmp_path, ledgers):
    from sieve.checkpoint import COLD_SEG_BASE as REF_BASE

    assert COLD_SEG_BASE == REF_BASE == 1 << 40
    got, want = _open_both(ledgers["wheel30"], **TW)
    for seg_id in (0, 3, 4, COLD_SEG_BASE + 2):
        assert got.recorded_hi(seg_id) == want.recorded_hi(seg_id)
    assert got.recorded_hi(3) == N + 1 and got.recorded_hi(4) == 0


def test_port_reads_a_reference_ledger(tmp_path):
    ref_run_local(_ref_cfg(tmp_path, "odds"))
    got, want = _open_both(tmp_path, packing="odds")
    _same_outcome(got, want)


# --- the index ------------------------------------------------------------------


def _indexes(ledgers, packing, **kw):
    got = SieveIndex(packing, Ledger.open_readonly(
        _cfg(ledgers[packing], packing, **TW)).completed(), **kw)
    want = RefIndex(packing, RefLedger.open_readonly(
        _ref_cfg(ledgers[packing], packing, **TW)).completed(), **kw)
    return got, want


def _ctx_fields(c):
    return (c.index, c.lru_hit, c.store_hit, c.materialized, c.answered_hi,
            c.count_so_far, c.source())


@pytest.mark.parametrize("packing", PACKINGS)
def test_prefix_counts_and_nth_equal_the_reference(ledgers, packing):
    got, want = _indexes(ledgers, packing, lru_segments=2)
    assert (got.covered_hi, got.total_primes, got.dropped_segments, got.bounds) == (
        want.covered_hi, want.total_primes, want.dropped_segments, want.bounds)
    assert got.total_primes == o_pi(got.covered_hi - 1)
    for v in [2, 3, 4, 5, 6, 7, 8, 100, 12_345, 29_999, N, N + 1] + got.bounds:
        c, rc = QueryCtx(), RefCtx()
        assert got.count_upto(v, c) == want.count_upto(v, rc) == o_pi(v - 1), v
        assert _ctx_fields(c) == _ctx_fields(rc)
    for k in (1, 2, 3, 4, 100, 2_000, got.total_primes):
        c, rc = QueryCtx(), RefCtx()
        assert got.nth(k, c) == want.nth(k, rc) == int(P[k - 1]), k
        assert _ctx_fields(c) == _ctx_fields(rc)
    assert got.stats() == want.stats()
    for bad in (0, got.total_primes + 1):
        with pytest.raises(ValueError, match="outside indexed range"):
            got.nth(bad, QueryCtx())
    with pytest.raises(ValueError, match="beyond covered_hi"):
        got.count_upto(got.covered_hi + 1, QueryCtx())


@pytest.mark.parametrize("packing", PACKINGS)
def test_count_upto_batch_equals_the_reference(ledgers, packing):
    got, want = _indexes(ledgers, packing, lru_segments=1)
    rng = np.random.default_rng(7)
    vs = np.concatenate([rng.integers(2, got.covered_hi + 1, 200),
                         np.array(got.bounds), [2, got.covered_hi, 12_345, 12_345]])
    c, rc = QueryCtx(), RefCtx()
    out = got.count_upto_batch(vs.tolist(), c)
    assert out.tolist() == want.count_upto_batch(vs.tolist(), rc).tolist()
    assert out.tolist() == [o_pi(int(v) - 1) for v in vs]
    assert out.tolist() == [got.count_upto(int(v), QueryCtx()) for v in vs]
    assert _ctx_fields(c) == _ctx_fields(rc)
    assert got.count_upto_batch([], QueryCtx()).size == 0
    for bad in ([1], [got.covered_hi + 1]):
        with pytest.raises(ValueError) as e:
            got.count_upto_batch(bad, QueryCtx())
        with pytest.raises(ValueError) as r:
            want.count_upto_batch(bad, RefCtx())
        assert str(e.value) == str(r.value)


def test_repeat_interior_query_is_an_lru_hit(ledgers):
    got, _ = _indexes(ledgers, "wheel30")
    got.count_upto(12_345, QueryCtx())
    s0 = got.stats()
    c = QueryCtx()
    got.count_upto(12_345, c)
    s1 = got.stats()
    assert c.lru_hit and not c.materialized
    assert s1["lru_hits"] > s0["lru_hits"] and s1["materialized"] == s0["materialized"]


@pytest.mark.parametrize("base", [2, 12_501, 25_001])
def test_shard_base_equals_the_reference(ledgers, base):
    segs = sorted(Ledger.open_readonly(_cfg(ledgers["odds"], "odds", **TW))
                  .completed().values(), key=lambda r: r.lo)
    rsegs = sorted(RefLedger.open_readonly(_ref_cfg(ledgers["odds"], "odds", **TW))
                   .completed().values(), key=lambda r: r.lo)
    base = min((s.lo for s in segs if s.lo >= base), default=base)
    got = SieveIndex("odds", [s for s in segs if s.lo >= base], base=base)
    want = RefIndex("odds", [s for s in rsegs if s.lo >= base], base=base)
    assert (got.base, got.covered_hi, got.total_primes) == (
        want.base, want.covered_hi, want.total_primes)
    for v in (base, base + 1, base + 999, got.covered_hi):
        assert got.count_upto(v, QueryCtx()) == want.count_upto(v, RefCtx())
    assert got.nth(1, QueryCtx()) == want.nth(1, RefCtx())


def test_index_drops_segments_after_a_hole(ledgers):
    segs = sorted(Ledger.open_readonly(_cfg(ledgers["wheel30"], **TW))
                  .completed().values(), key=lambda r: r.lo)
    rsegs = sorted(RefLedger.open_readonly(_ref_cfg(ledgers["wheel30"], **TW))
                   .completed().values(), key=lambda r: r.lo)
    got = SieveIndex("wheel30", [segs[0]] + segs[2:])
    want = RefIndex("wheel30", [rsegs[0]] + rsegs[2:])
    assert (len(got.segments), got.dropped_segments, got.covered_hi) == (
        len(want.segments), want.dropped_segments, want.covered_hi) == (
        1, 2, segs[0].hi)
    with pytest.raises(ValueError, match="beyond covered_hi"):
        got.count_upto(segs[2].hi, QueryCtx())
    assert got.stats() == want.stats()


@pytest.mark.parametrize("packing", PACKINGS)
def test_flags_fn_seam_served_from_the_index(ledgers, packing):
    """The service's enumeration seam: slices cut at the index's bounds,
    served by ``flags_for_slice`` (bit-sliced from the index's chunks), give
    the plain enumeration, in both packages."""
    got_idx, want_idx = _indexes(ledgers, packing)
    c, rc = QueryCtx(), RefCtx()
    lo, hi = 11_000, got_idx.covered_hi
    got = np.concatenate(list(primes_in_range(
        packing, lo, hi, bounds=got_idx.bounds,
        flags_fn=lambda a, b: got_idx.flags_for_slice(a, b, c))))
    want = np.concatenate(list(ref_primes_in_range(
        packing, lo, hi, bounds=want_idx.bounds,
        flags_fn=lambda a, b: want_idx.flags_for_slice(a, b, rc))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, P[(P >= lo) & (P < hi)])
    assert c.materialized and _ctx_fields(c) == _ctx_fields(rc)
    assert got_idx.flags_for_slice(hi, hi + 10, QueryCtx()) is None  # past coverage
