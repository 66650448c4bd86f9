"""The port's fused mark+reduce module against the JAX reference.

Same inputs through both packages, exact (tolerance 0: the arithmetic is
integer):
  - the prepared spec tables, per-tile cursors included
    (CudaChain/prepare_cuda vs PallasChain/prepare_pallas);
  - the kernel's plain version (mark_fused_reference) vs the Pallas kernel
    in interpret mode (mark_pallas_fused) on the very same tables,
    carried across by segment_from_reference: the four scalars and the
    need_bits words;
  - the constants the two packages must share.
The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against mark_fused_reference there.
"""

import dataclasses
import math

import numpy as np
import pytest

from sieve.kernels import jax_mark, pallas_mark
from sieve.backends import jax_backend
from sieve.seed import seed_primes
from sieve_torch.interop import segment_from_reference
from sieve_torch.kernels import cuda_mark, pairs
from sieve_torch.kernels.cuda_mark import (
    TILE_WORDS,
    CudaChain,
    mark_fused,
    mark_fused_reference,
    prepare_cuda,
    spec_counts,
    tile_offsets,
)
from tests.test_backends_parity import FIXTURES

PACKINGS = ["plain", "odds", "wheel30"]
GAPS = {"none": 2, "twins": 2, "cousins": 4}
# one multi-tile segment and one in-tile sliver (odd, non-word-aligned
# bounds) per packing, as the reference's fused-kernel tests use
SEGMENTS = {
    "odds": [(2_000_003, 6_000_001), (1_001, 33_001)],
    "wheel30": [(2, 3_000_001), (1_013, 37_017)],
    "plain": [(2, 500_002), (977, 40_001)],
}
# the group-D segment of the reference's parity tests (n = 3e7)
GROUP_D = ("odds", 2_000_003, 24_000_001, math.isqrt(30_000_000))


def _kind(packing, gapname):
    if gapname == "none":
        return pairs.TWIN_NONE
    table = pairs.TWIN_KIND if gapname == "twins" else pairs.COUSIN_KIND
    return table[packing]


def _assert_tables_equal(got, want, ctx):
    """Every field of a CudaSegment against a PallasSegment, dtype and
    value, plus the kernel's full argument tuple (per-tile cursors)."""
    assert [f.name for f in dataclasses.fields(got)] == [
        f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, tuple):
            assert len(a) == len(b), (f.name, ctx)
            for i, (x, y) in enumerate(zip(a, b)):
                assert x.dtype == y.dtype, (f.name, i, ctx)
                np.testing.assert_array_equal(x, y, err_msg=f"{f.name}[{i}] {ctx}")
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, (f.name, ctx)
            np.testing.assert_array_equal(a, b, err_msg=f"{f.name} {ctx}")
        else:
            assert a == b, (f.name, ctx)
    fa, fb = cuda_mark.fused_args(got), pallas_mark.fused_args(want)
    assert len(fa) == len(fb) == 28
    for i, (x, y) in enumerate(zip(fa, fb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (i, ctx)
        np.testing.assert_array_equal(x, y, err_msg=f"fused_args[{i}] {ctx}")


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


def test_constants_match_reference():
    for name in ("TWIN_NONE", "TWIN_PLAIN", "TWIN_ADJ", "TWIN_W30",
                 "COUSIN_PLAIN", "COUSIN_ADJ", "COUSIN_W30", "PAIR_SHIFT"):
        assert getattr(pairs, name) == getattr(jax_mark, name), name
    for name in ("TWIN_KIND", "COUSIN_KIND", "MIN_DEVICE_BITS"):
        assert getattr(pairs, name) == getattr(jax_backend, name), name
    for name in ("R_ROWS", "TILE_WORDS", "NA_PAD", "B_MAX",
                 "D_MIN", "D_LANES", "_FLAT_MAX_HITS"):
        assert getattr(cuda_mark, name) == getattr(pallas_mark, name), name
    for Wpad in (TILE_WORDS, 7 * TILE_WORDS, 1000 * TILE_WORDS):
        assert cuda_mark._flat_cutoff(Wpad) == pallas_mark._flat_cutoff(Wpad)


@pytest.mark.parametrize("count_kind", ["primes", "twins", "cousins"])
@pytest.mark.parametrize("packing", PACKINGS)
def test_pair_kind_matches_reference(packing, count_kind):
    from sieve.config import SieveConfig as RefConfig
    from sieve_torch.config import SieveConfig

    ref = RefConfig(n=100, packing=packing, count_kind=count_kind)
    got = SieveConfig(n=100, packing=packing, count_kind=count_kind)
    assert pairs.pair_kind(got) == jax_backend.pair_kind(ref)


# ---------------------------------------------------------------------------
# (a) prepared tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gap", [2, 4])
@pytest.mark.parametrize("packing", PACKINGS)
def test_prepare_matches_reference_fixtures(packing, gap):
    """prepare_cuda == prepare_pallas on the backend-parity fixtures."""
    for lo, hi, n in FIXTURES:
        seeds = seed_primes(math.isqrt(n))
        want = pallas_mark.prepare_pallas(packing, lo, hi, seeds, pair_gap=gap)
        got = prepare_cuda(packing, lo, hi, seeds, pair_gap=gap)
        _assert_tables_equal(got, want, (packing, lo, hi, gap))


def test_prepare_matches_reference_group_d():
    packing, lo, hi, limit = GROUP_D
    seeds = seed_primes(limit)
    want = pallas_mark.prepare_pallas(packing, lo, hi, seeds)
    got = prepare_cuda(packing, lo, hi, seeds)
    assert spec_counts(got)["D"] > 0
    assert spec_counts(got) == pallas_mark.spec_counts(want)
    _assert_tables_equal(got, want, GROUP_D)


@pytest.mark.parametrize("flat_min", ["4097", "5477"])
def test_prepare_matches_reference_flat(monkeypatch, flat_min):
    monkeypatch.setenv("SIEVE_PALLAS_FLAT_MIN", flat_min)
    seeds = seed_primes(5477)
    lo, hi = 2_000_003, 12_000_001
    want = pallas_mark.prepare_pallas("odds", lo, hi, seeds)
    got = prepare_cuda("odds", lo, hi, seeds)
    assert spec_counts(got)["flat_words"] > 0
    _assert_tables_equal(got, want, ("flat", flat_min))


@pytest.mark.parametrize("packing", PACKINGS)
def test_chain_matches_reference_chain(packing):
    """CudaChain == PallasChain == from scratch, over a chain of segments
    with a backward jump and an unaligned tail."""
    from sieve_torch.bitset import get_layout

    seeds = seed_primes(3000)  # strides past 4096 bits -> group D populated
    layout = get_layout(packing)
    bounds = [(2, 200_000), (200_000, 400_000), (600_000, 800_123),
              (400_000, 600_000)]
    W = max(-(-layout.nbits(lo, hi) // 32) for lo, hi in bounds)
    wpad = -(-(W + 1) // TILE_WORDS) * TILE_WORDS
    chain = CudaChain(packing, seeds, wpad)
    ref_chain = pallas_mark.PallasChain(packing, seeds, wpad)
    for lo, hi in bounds:
        got = chain.prepare(lo, hi)
        _assert_tables_equal(got, ref_chain.prepare(lo, hi), (packing, lo, hi))
        _assert_tables_equal(
            got, pallas_mark.prepare_pallas(packing, lo, hi, seeds, wpad=wpad),
            (packing, lo, hi, "scratch"))
    assert set(chain.phase_seconds) == set(ref_chain.phase_seconds)
    assert chain.segments_prepared == len(bounds)


def test_carried_segment_equals_prepared():
    lo, hi = SEGMENTS["wheel30"][0]
    seeds = seed_primes(math.isqrt(hi - 1))
    ps = pallas_mark.prepare_pallas("wheel30", lo, hi, seeds)
    carried = segment_from_reference(dataclasses.asdict(ps))
    _assert_tables_equal(carried, ps, "carried")
    _assert_tables_equal(prepare_cuda("wheel30", lo, hi, seeds), ps, "prepared")


def test_tile_offsets_cursors():
    Wpad = 3 * TILE_WORDS
    idx = np.array(
        [[5, TILE_WORDS - 1, TILE_WORDS, 2 * TILE_WORDS + 7, 0, 0]], np.int32
    )
    mask = np.array([[1, 1, 1, 1, 0, 0]], np.uint32)  # 2 pad entries
    off = tile_offsets(idx, mask, Wpad)
    assert off.tolist() == [[0, 2, 3, 4]]
    assert off.tolist() == pallas_mark.tile_offsets(idx, mask, Wpad).tolist()
    assert tile_offsets(
        np.zeros((1, 4), np.int32), np.zeros((1, 4), np.uint32), Wpad
    ).tolist() == [[0, 0, 0, 0]]


def test_prepare_rejects_oversized_segment():
    with pytest.raises(ValueError, match="too large"):
        prepare_cuda("plain", 2, 2 + (1 << 30), seed_primes(100))


# ---------------------------------------------------------------------------
# (b) the kernel's plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


def _kernel_pair(packing, lo, hi, gapname, seeds=None):
    if seeds is None:
        seeds = seed_primes(math.isqrt(hi - 1))
    kind = _kind(packing, gapname)
    ps = pallas_mark.prepare_pallas(packing, lo, hi, seeds, pair_gap=GAPS[gapname])
    want_s, want_w = pallas_mark.mark_pallas_fused(ps, kind, interpret=True,
                                                   need_bits=True)
    seg = segment_from_reference(dataclasses.asdict(ps))
    got_s, got_w = mark_fused_reference(seg, kind, need_bits=True)
    return seg, kind, (want_s, np.asarray(want_w)), (got_s, got_w)


# every packing x kind on the multi-tile segments; the slivers (unaligned
# boundary words) on every kind where their kernel shapes equal the
# multi-tile ones (plain: no extra interpret-mode compile) and on one kind
# elsewhere, each Pallas compile costing ~3 s
KERNEL_CASES = [("multi_tile", p, k) for p in PACKINGS
                for k in ("none", "twins", "cousins")] + [
    ("sliver", "plain", "none"), ("sliver", "plain", "twins"),
    ("sliver", "plain", "cousins"), ("sliver", "odds", "cousins"),
    ("sliver", "wheel30", "none"),
]


@pytest.mark.parametrize("which,packing,gapname", KERNEL_CASES)
def test_kernel_matches_pallas(which, packing, gapname):
    lo, hi = SEGMENTS[packing][0 if which == "multi_tile" else 1]
    seg, kind, want, got = _kernel_pair(packing, lo, hi, gapname)
    assert got[0] == want[0], (which, packing, gapname)
    assert got[1].dtype == np.uint32 and got[1].shape == want[1].shape
    np.testing.assert_array_equal(got[1], want[1])
    # without need_bits the same four scalars come back
    assert mark_fused_reference(seg, kind) == want[0]


def test_kernel_matches_pallas_flat_list(monkeypatch):
    """A non-empty flat crossing list next to a live group D."""
    monkeypatch.setenv("SIEVE_PALLAS_FLAT_MIN", "4097")
    lo, hi = 2_000_003, 12_000_001
    seg, _, want, got = _kernel_pair("odds", lo, hi, "twins", seeds=seed_primes(5477))
    counts = spec_counts(seg)
    assert counts["flat_words"] > 0 and counts["corr_words"] == 0
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_plain_version_chunking_is_exact():
    """Chunk boundaries carry the edge pair and boundary words exactly."""
    lo, hi = SEGMENTS["odds"][0]
    seg = prepare_cuda("odds", lo, hi, seed_primes(math.isqrt(hi - 1)), pair_gap=4)
    whole = mark_fused_reference(seg, pairs.COUSIN_ADJ, need_bits=True)
    for cw in (TILE_WORDS, 3 * TILE_WORDS):
        part = mark_fused_reference(seg, pairs.COUSIN_ADJ, need_bits=True,
                                    chunk_words=cw)
        assert part[0] == whole[0]
        np.testing.assert_array_equal(part[1], whole[1])


def test_plain_version_words_match_numpy_sieve():
    """need_bits words are final: the numpy reference sieve, packed."""
    from sieve_torch.backends.cpu_numpy import sieve_segment_flags

    lo, hi = 1_001, 33_001
    seeds = seed_primes(math.isqrt(hi - 1))
    seg = prepare_cuda("odds", lo, hi, seeds)
    _, words = mark_fused_reference(seg, pairs.TWIN_ADJ, need_bits=True)
    flags = sieve_segment_flags("odds", lo, hi, seeds)
    padded = np.zeros(seg.Wpad * 32, bool)
    padded[: flags.size] = flags
    want = np.packbits(padded, bitorder="little").view("<u4").reshape(-1, 128)
    np.testing.assert_array_equal(words, want)


def test_mark_fused_on_cpu_runs_plain_version():
    lo, hi = SEGMENTS["plain"][1]
    seg = prepare_cuda("plain", lo, hi, seed_primes(math.isqrt(hi - 1)))
    before = mark_fused.launches
    got = mark_fused(seg, pairs.TWIN_PLAIN, device="cpu")
    assert got == mark_fused_reference(seg, pairs.TWIN_PLAIN)
    assert mark_fused.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="unsupported device"):
        mark_fused(seg, pairs.TWIN_PLAIN, device="meta")
