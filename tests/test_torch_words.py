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
