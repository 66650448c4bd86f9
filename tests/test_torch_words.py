"""The port's word kernel and its backends against the JAX reference.

On the CPU, tolerance 0 (the arithmetic is integer):
  - the tiered preparation (``prepare_tiered``, ``marking_specs``,
    ``SpecChain``, ``TieredChain`` stepped across jumps, and
    ``with_spec_count``) array for array, dtypes included;
  - ``word_mark.mark_words`` against ``sieve.kernels.jax_mark.mark_words``
    on the very same tables (carried by ``interop.tiered_from_reference``),
    for each packing and pair kind;
  - the ``torch`` backend against ``jax`` and ``cpu-numpy``, segment by
    segment and as whole runs; ``cpu-native`` against ``cpu-numpy``;
  - the CLI on ``--backend torch`` and ``--backend cpu-native``.
"""

import contextlib
import dataclasses
import io
import math

import numpy as np
import pytest

from sieve.backends.cpu_numpy import CpuNumpyWorker as RefNumpyWorker
from sieve.backends.jax_backend import JaxWorker
from sieve.config import SieveConfig as RefConfig
from sieve.coordinator import run_local as ref_run_local
from sieve.kernels import jax_mark
from sieve.kernels import specs as ref_specs
from sieve.seed import seed_primes as ref_seed_primes
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.interop import config_from_reference, tiered_from_reference
from sieve_torch.kernels import specs, word_mark
from sieve_torch.kernels.pairs import COUSIN_KIND, TWIN_KIND, TWIN_NONE
from tests.oracles import PI, TWINS
from tests.test_backends_parity import FIXTURES

PACKINGS = ["plain", "odds", "wheel30"]
KINDS = ["primes", "twins", "cousins"]
KNOBS = dict(tier1_max=64, spec_block=16, word_bucket=8192)


def _same(a, b, what=""):
    """Dataclasses of arrays, tuples of arrays and ints, exactly equal
    (dtype included)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, tuple):
            assert len(x) == len(y), (what, f.name)
            for u, v in zip(x, y):
                assert np.asarray(u).dtype == np.asarray(v).dtype, (what, f.name)
                np.testing.assert_array_equal(u, v, err_msg=f"{what} {f.name}")
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, (what, f.name)
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {f.name}")
        else:
            assert x == y, (what, f.name)


def _kind(packing, gap):
    return TWIN_NONE if gap == 0 else (TWIN_KIND if gap == 2 else COUSIN_KIND)[packing]


@pytest.mark.parametrize("gap", [2, 4])
@pytest.mark.parametrize("packing", PACKINGS)
def test_prepare_tiered_matches_reference(packing, gap):
    for lo, hi, n in FIXTURES:
        seeds = ref_seed_primes(math.isqrt(n))
        want = ref_specs.prepare_tiered(packing, lo, hi, seeds, pair_gap=gap, **KNOBS)
        got = specs.prepare_tiered(packing, lo, hi, seeds, pair_gap=gap, **KNOBS)
        _same(got, want, (packing, lo, hi))
        bucket = 2 * word_mark.next_pow2(got.m2.size)
        _same(got.with_spec_count(bucket), want.with_spec_count(bucket), (packing, lo, hi))
        assert got.with_spec_count(got.m2.size) is got
        with pytest.raises(ValueError, match="cannot shrink"):
            got.with_spec_count(got.m2.size - 1)
        _same(specs.marking_specs(packing, lo, hi, seeds),
              ref_specs.marking_specs(packing, lo, hi, seeds), (packing, lo, hi))
    with pytest.raises(ValueError, match="too large for word kernel"):
        # under 2^31 bits, over 32 * MAX_WORDS
        hi = {"plain": 2_100_000_000, "odds": 4_200_000_000, "wheel30": 7 * 10**9}
        specs.prepare_tiered(packing, 2, hi[packing], ref_seed_primes(100), **KNOBS)


@pytest.mark.parametrize("packing", PACKINGS)
def test_tiered_chain_matches_reference(packing):
    """A chain stepped forward over equal spans, across a jump, backwards
    and into a sliver, against the reference chain and from-scratch
    preparation, with its stride-only fields."""
    seeds = ref_seed_primes(2_000)
    steps = [(2, 50_002), (50_002, 100_002), (100_002, 150_002),
             (1_000_003, 1_040_003), (60_000, 68_192), (3_000_000, 3_000_040),
             (3_999_000, 4_000_001)]
    got = specs.TieredChain(packing, seeds, pair_gap=4, **KNOBS)
    want = ref_specs.TieredChain(packing, seeds, pair_gap=4, **KNOBS)
    spec_got, spec_want = specs.SpecChain(packing, seeds), ref_specs.SpecChain(packing, seeds)
    assert (got.periods, got.n_tier2) == (want.periods, want.n_tier2)
    for lo, hi in steps:
        a = got.prepare(lo, hi)
        _same(a, want.prepare(lo, hi), (packing, lo, hi))
        _same(a, ref_specs.prepare_tiered(packing, lo, hi, seeds, pair_gap=4, **KNOBS))
        _same(spec_got.specs(lo, hi), spec_want.specs(lo, hi), (packing, lo, hi))
    assert got.segments_prepared == len(steps)
    assert set(got.phase_seconds) == set(want.phase_seconds)


@pytest.mark.parametrize("packing", PACKINGS)
def test_prepare_segment_matches_reference(packing):
    """The backend's bucketed prepare: tier-2 tables padded to a power of
    two, as the reference's jax backend pads them."""
    from sieve.backends.jax_backend import prepare_segment as ref_prepare_segment
    from sieve_torch.backends.torch_words import prepare_segment

    for lo, hi, n in FIXTURES:
        seeds = ref_seed_primes(math.isqrt(n))
        got = prepare_segment(packing, lo, hi, seeds)
        _same(got, ref_prepare_segment(packing, lo, hi, seeds), (packing, lo, hi))
        assert got.m2.size == max(16, word_mark.next_pow2(got.m2.size))


def _ref_mark(ts, kind):
    return np.asarray(jax_mark.mark_words(
        ts.Wpad, kind, ts.periods, np.int32(ts.nbits), ts.patterns, ts.m2,
        ts.r2, ts.K2, ts.rcp2, ts.act2, ts.corr_idx, ts.corr_mask,
        np.uint32(ts.pair_mask))).astype(np.int64)


def _mark(ts, kind):
    return word_mark.mark_words(
        ts.Wpad, kind, ts.periods, ts.nbits, ts.patterns, ts.m2, ts.r2,
        ts.K2, ts.rcp2, ts.act2, ts.corr_idx, ts.corr_mask, ts.pair_mask,
        device="cpu").numpy()


# segments of at least 64 bits in every packing, incl. a multi-word-bucket one
MARK_SEGMENTS = [(49, 2_049, 10**4), (2, 130_000, 10**5), (65_536, 70_000, 10**5),
                 (2, 4 * 10**6 + 1, 4 * 10**6)]


@pytest.mark.parametrize("gap", [0, 2, 4])
@pytest.mark.parametrize("packing", PACKINGS)
def test_mark_words_matches_reference(packing, gap):
    """The four packed results of both word kernels on the same tables,
    padded to the reference's power-of-two spec bucket."""
    kind = _kind(packing, gap)
    for lo, hi, n in MARK_SEGMENTS:
        seeds = ref_seed_primes(math.isqrt(n))
        ref_ts = ref_specs.prepare_tiered(packing, lo, hi, seeds,
                                          pair_gap=gap or 2, **KNOBS)
        ref_ts = ref_ts.with_spec_count(word_mark.next_pow2(ref_ts.m2.size))
        ts = tiered_from_reference(dataclasses.asdict(ref_ts))
        _same(ts, ref_ts)
        got, want = _mark(ts, kind), _ref_mark(ref_ts, kind)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want, err_msg=f"{packing} [{lo}, {hi})")


def test_mark_words_batch_equals_rows():
    """Rows of one shape with different live tier-2 counts (the act mask
    inside a block) and corrections: the batch equals each row alone."""
    seeds = ref_seed_primes(2_000)
    segs = [(1_000_003, 1_065_539), (3_000_001, 3_065_537), (2, 65_538)]
    rows = [specs.prepare_tiered("odds", lo, hi, seeds, **KNOBS) for lo, hi in segs]
    S2 = max(word_mark.next_pow2(r.m2.size) for r in rows)
    rows = [r.with_spec_count(S2) for r in rows]
    assert len({r.act2.sum() for r in rows}) > 1 and len({r.Wpad for r in rows}) == 1
    from sieve_torch.backends.torch_words import stack_tables

    c_pad = word_mark.next_pow2(max(r.corr_idx.size for r in rows))
    got = word_mark.mark_words_batch(rows[0].Wpad, TWIN_KIND["odds"], rows[0].periods,
                                     *stack_tables(rows, rows[0].periods, c_pad))
    assert got.shape == (3, 4)
    for row, ts in zip(got.numpy(), rows):
        np.testing.assert_array_equal(row, _mark(ts, TWIN_KIND["odds"]))


# --- tier 2's sparse marking, whole words against the dense formula ---------

def _dense_words(Wpad, periods, patterns, m2, r2, act2):
    """The word kernel's words by the dense formula, int32 [B, Wpad]: tier
    1's patterns tiled and ANDed out, then for every live tier-2 spec
    t = (r - 32w) mod m over every word w, bit t cleared where t < 32."""
    B = m2.shape[0]
    words = np.full((B, Wpad), 0xFFFFFFFF, np.uint64)
    w32 = 32 * np.arange(Wpad, dtype=np.int64)
    for b in range(B):
        for pat, period in zip(patterns, periods):
            tiled = np.tile(pat[b].astype(np.uint32), Wpad // period + 1)[:Wpad]
            words[b] &= ~tiled.astype(np.uint64)
        for m, r, a in zip(m2[b], r2[b], act2[b]):
            if a:
                t = (int(r) - w32) % int(m)
                hit = t < 32
                words[b, hit] &= ~(np.uint64(1) << t[hit].astype(np.uint64))
    return words.astype(np.uint32).view(np.int32)


def _rows(rows):
    """Stacked (Wpad, periods, patterns, m2, r2, act2) of TieredSegments of
    one shape."""
    return (rows[0].Wpad, rows[0].periods,
            tuple(np.stack([ts.patterns[i] for ts in rows])
                  for i in range(len(rows[0].periods))),
            *(np.stack([getattr(ts, f) for ts in rows]) for f in ("m2", "r2", "act2")))


def _specs_per_chunk(L, plan):
    """For each chunk of a one-row plan, the spec columns with a hit in its
    windows."""
    start = word_mark._window_starts(plan, word_mark.torch.from_numpy(plan.table))
    return [set(np.flatnonzero((start[k0:k1] < L).any(dim=0).numpy()).tolist())
            for k0, k1 in plan.chunks]


# chunk 64 (windows of 2,048 bits) and 1000 (16,384 bits): each cuts every
# spec's hits at its windows' edges, and each chunk holds many specs
@pytest.mark.parametrize("chunk", [word_mark.TIER2_CHUNK, 1000, 64])
@pytest.mark.parametrize("packing", PACKINGS)
def test_marked_words_match_dense_formula(packing, chunk):
    """Every word of ``_marked_words`` (tiers 1 and 2, before the tail)
    against the dense formula, single rows, at chunk sizes that cut one
    spec's hits and that put several specs' hits in one chunk."""
    segs = MARK_SEGMENTS if chunk == word_mark.TIER2_CHUNK else MARK_SEGMENTS[:3]
    for lo, hi, n in segs:
        seeds = ref_seed_primes(math.isqrt(n))
        ts = specs.prepare_tiered(packing, lo, hi, seeds, **KNOBS)
        args = _rows([ts])
        got = word_mark._marked_words(*args, "cpu", chunk=chunk)
        assert got.dtype == word_mark.torch.int32
        np.testing.assert_array_equal(got.numpy(), _dense_words(*args),
                                      err_msg=f"{packing} [{lo}, {hi})")
    L = 32 * ts.Wpad
    plan = word_mark._tier2_plan(L, *args[3:], chunk)
    assert plan.per_window == sum(w * (c1 - c0) for w, c0, c1, _ in plan.groups)
    assert all((k1 - k0) * plan.per_window <= max(chunk, plan.per_window)
               for k0, k1 in plan.chunks)
    assert plan.row_bits >= L and plan.row_bits % 32 == 0
    held = _specs_per_chunk(L, plan)
    assert all(len(h) > 1 for h in held)                    # specs share a chunk
    if chunk < word_mark.TIER2_CHUNK:
        assert any(len(h & g) for h, g in zip(held, held[1:]))  # a spec cut


@pytest.mark.parametrize("chunk", [word_mark.TIER2_CHUNK, 64])
def test_marked_words_batch_match_dense_formula(chunk):
    """A batch whose rows differ in live specs (the act mask) and in tier-1
    patterns: each row's words equal the dense formula's."""
    seeds = ref_seed_primes(2_000)
    segs = [(1_000_003, 1_065_539), (3_000_001, 3_065_537), (2, 65_538)]
    rows = [specs.prepare_tiered("odds", lo, hi, seeds, **KNOBS) for lo, hi in segs]
    S2 = max(word_mark.next_pow2(r.m2.size) for r in rows)
    rows = [r.with_spec_count(S2) for r in rows]
    assert len({int((r.act2 != 0).sum()) for r in rows}) > 1
    args = _rows(rows)
    got = word_mark._marked_words(*args, "cpu", chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), _dense_words(*args))


def _edge_tables():
    """Hand-made tier-2 tables over Wpad = 64 (2,048 bits): r = 0 and
    r = m - 1 at m = TIER1_MAX + 1, a stride past the row with one hit and
    one with none (r >= 32 * Wpad), and a row of padding specs only."""
    m_edge = word_mark.TIER1_MAX + 1
    live = [(m_edge, 0), (m_edge, m_edge - 1), (97, 0), (2047, 2046), (4099, 5),
            (4099, 4098)]
    pad = (1 << 20, 0)
    m2 = np.array([[m for m, _ in live], [pad[0]] * 6, [m_edge, 131, *[pad[0]] * 4]],
                  np.int32)
    r2 = np.array([[r for _, r in live], [pad[1]] * 6, [3, 130, *[0] * 4]], np.int32)
    act2 = np.array([[0xFFFFFFFF] * 6, [0] * 6, [0xFFFFFFFF] * 2 + [0] * 4], np.uint32)
    return 64, (), (), m2, r2, act2


@pytest.mark.parametrize("chunk", [word_mark.TIER2_CHUNK, 1000, 7, 1])
def test_marked_words_edges_match_dense_formula(chunk):
    args = _edge_tables()
    got = word_mark._marked_words(*args, "cpu", chunk=chunk).numpy()
    want = _dense_words(*args)
    np.testing.assert_array_equal(got, want)
    assert (want[1] == -1).all()                       # padding row unmarked
    bits = np.unpackbits(got.view(np.uint8), bitorder="little").reshape(3, -1)
    # r = m - 1's last hit, the one-hit stride's, and none past the row
    assert bits[0, 64 + 65 * 30] == 0 and bits[0, 5] == 0 and bits[0, 2046] == 0


def test_tier2_hits_counter_on_a_card(monkeypatch):
    """On a card each call adds its hits to ``kernel.mark_words.tier2_hits``:
    the sum over live specs of ceil((32 * Wpad - r) / m)."""
    from sieve_torch.metrics import registry

    monkeypatch.setattr(word_mark, "_on_card", lambda device: True)
    seeds = ref_seed_primes(2_000)
    rows = [specs.prepare_tiered("odds", lo, hi, seeds, **KNOBS)
            for lo, hi in [(1_000_003, 1_065_539), (2, 65_538)]]
    S2 = max(word_mark.next_pow2(r.m2.size) for r in rows)
    rows = [r.with_spec_count(S2) for r in rows]
    Wpad, *_, m2, r2, act2 = args = _rows(rows)
    want = sum(-(-(32 * Wpad - int(r)) // int(m))
               for m, r, a in zip(m2.ravel(), r2.ravel(), act2.ravel()) if a)
    counter = registry().counter("kernel.mark_words.tier2_hits")
    before = counter.value
    for chunk in (word_mark.TIER2_CHUNK, 64):
        word_mark._marked_words(*args, "cpu", chunk=chunk)
        assert counter.value - before == want
        before = counter.value
    edge = _edge_tables()
    word_mark._marked_words(*edge, "cpu")
    # row 0: (65, 0) 32, (65, 64) 31, (97, 0) 22, (2047, 2046) 1, (4099, 5) 1,
    # (4099, 4098) 0; row 1 padding only; row 2: (65, 3) 32, (131, 130) 15
    assert counter.value - before == 32 + 31 + 22 + 1 + 1 + 0 + 32 + 15


def _fields(res):
    d = dataclasses.asdict(res)
    d.pop("elapsed_s")
    return d


@pytest.mark.parametrize("count_kind", ["twins", "cousins"])
@pytest.mark.parametrize("packing", PACKINGS)
def test_torch_worker_matches_jax_and_numpy(packing, count_kind):
    """Every backend-parity fixture (slivers included) through the port's
    torch worker, the reference's jax worker and its numpy worker."""
    from sieve_torch.backends import make_worker

    for lo, hi, n in FIXTURES:
        seeds = ref_seed_primes(math.isqrt(n))
        ref_cfg = RefConfig(n=n, packing=packing, count_kind=count_kind)
        got = make_worker(SieveConfig(n=n, backend="torch", device="cpu",
                                      packing=packing, count_kind=count_kind))
        assert got.name == "torch"
        res = _fields(got.process_segment(lo, hi, seeds, seg_id=3))
        assert res == _fields(JaxWorker(ref_cfg).process_segment(lo, hi, seeds, 3))
        assert res == _fields(RefNumpyWorker(ref_cfg).process_segment(lo, hi, seeds, 3))


@pytest.mark.parametrize("count_kind", KINDS)
@pytest.mark.parametrize("packing", PACKINGS)
def test_run_local_matches_reference(packing, count_kind):
    """The whole counting run on --backend torch against the reference's
    --backend jax: every SegmentResult field but the timings, and the
    host_phases keys."""
    kw = dict(n=10**6, packing=packing, n_segments=8, count_kind=count_kind,
              quiet=True)
    ref = ref_run_local(RefConfig(backend="jax", **kw))
    got = run_local(SieveConfig(backend="torch", device="cpu", **kw))
    assert (got.pi, got.twin_pairs, got.n_segments) == (ref.pi, ref.twin_pairs, 8)
    assert [_fields(s) for s in got.segments] == [_fields(s) for s in ref.segments]
    assert set(got.host_phases) == set(ref.host_phases)
    assert got.pi == PI[10**6]
    if count_kind == "twins":
        assert got.twin_pairs == TWINS[10**6]


@pytest.mark.parametrize("packing", PACKINGS)
def test_cpu_native_matches_numpy(packing):
    from sieve_torch.backends import make_worker

    rng = np.random.default_rng(11)
    cases = FIXTURES + [(lo, lo + int(rng.integers(2, 200_000)), 10**6)
                        for lo in rng.integers(2, 800_000, 6).tolist()]
    for count_kind in ("primes", "twins", "cousins"):
        cfg = SieveConfig(n=10**6, backend="cpu-native", packing=packing,
                          count_kind=count_kind)
        got = make_worker(cfg)
        ref = RefNumpyWorker(RefConfig(n=10**6, packing=packing, count_kind=count_kind))
        for lo, hi, n in cases:
            seeds = ref_seed_primes(math.isqrt(n))
            assert _fields(got.process_segment(lo, hi, seeds)) == _fields(
                ref.process_segment(lo, hi, seeds)), (packing, count_kind, lo, hi)


def test_cpu_native_builds_into_the_package():
    from sieve_torch.backends import cpu_native

    lib = cpu_native._build_and_load()
    assert cpu_native._build_and_load() is lib
    path = cpu_native.library_path()
    assert path.exists() and path.parent == cpu_native.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "sieve_torch"


@pytest.mark.parametrize("backend,ref_backend", [("torch", "jax"),
                                                 ("cpu-native", "cpu-native")])
def test_carried_config_maps_backend(backend, ref_backend):
    ref = RefConfig(n=10**6, backend=ref_backend, twins=True, n_segments=4)
    got = config_from_reference(ref.to_dict(), device="cpu")
    assert got.backend == backend and got.config_hash() == ref.config_hash()
    assert run_local(got).twin_pairs == TWINS[10**6]


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize("backend,extra", [("torch", ["--device", "cpu"]),
                                           ("cpu-native", [])])
def test_cli(backend, extra, capsys, monkeypatch):
    import torch

    from sieve_torch.cli import main

    rc, out = _stdout(main, ["--n", "1e6", "--backend", backend, "--twins",
                             "--segments", "8", *extra])
    assert rc == 0
    assert out[:2] == ["pi(1000000) = 78498", "twin pairs (p, p+2 <= 1000000) = 8169"]
    assert out[2].startswith(f"backend={backend} packing=odds segments=8 ")
    if backend == "torch":
        # the card is the default device, and there is no fall back
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        capsys.readouterr()
        rc, out = _stdout(main, ["--n", "1e6", "--backend", "torch", "--twins"])
        assert rc == 2 and not out
        assert "no CUDA device" in capsys.readouterr().err
