"""The port's split marking kernel and its postlude against the JAX
reference.

Same inputs through both packages, exact (tolerance 0: the arithmetic is
integer):
  - the split kernel's plain version (mark_split_reference) against the
    Pallas split kernel in interpret mode (pallas_mark._build_call) on the
    very same tables: the raw words, padding past nbits included; and the
    port's kernel + postlude (mark_cuda_split) against the reference's
    postlude on the Pallas words;
  - the ported reduce_packed against jax_mark.reduce_packed on random
    words, every count kind;
  - the port's split path against its fused path on every segment;
  - the local run under SIEVE_PALLAS_FUSED=0 against the reference's.
The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against mark_split_reference there.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sieve.config import SieveConfig as RefConfig
from sieve.coordinator import run_local as ref_run_local
from sieve.kernels import jax_mark, pallas_mark
from sieve.seed import seed_primes
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.interop import segment_from_reference
from sieve_torch.kernels import pairs, reduce
from sieve_torch.kernels.cuda_mark import (
    fused_enabled,
    mark_cuda,
    mark_cuda_split,
    mark_fused_reference,
    mark_split,
    mark_split_reference,
    prepare_cuda,
    spec_counts,
)
from tests.oracles import PI, TWINS
from tests.test_torch_cuda_mark import GROUP_D, SEGMENTS, _kind

GAPS = {"none": 2, "twins": 2, "cousins": 4}
KINDS = ("none", "twins", "cousins")
# flat list: strides past 4097 bits leave group D for the host list
FLAT = ("odds", 2_000_003, 12_000_001, 5477)


def _words_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32).reshape(-1, 128)


def _pallas_split_words(ps):
    """The Pallas split kernel's raw words, as mark_pallas_split calls it."""
    SB, SC = ps.B[0].shape[1], ps.C[0].shape[1]
    ND = ps.D[0].shape[0] if ps.D[3].any() else 0
    call = pallas_mark._build_call(ps.Wpad, SB, SC, ND, interpret=True)
    return call(*(tuple(ps.A) + tuple(ps.B) + tuple(ps.C) + tuple(ps.D)))


def _ref_postlude(words, ps, kind):
    """The reference's XLA tail on the Pallas words, with the arguments
    mark_pallas_split gives it."""
    FC = ps.flat_idx.shape[1] if ps.flat_mask.any() else 0
    out = jax_mark.pack4(*pallas_mark._postlude(
        words, np.int32(ps.nbits), np.uint32(ps.pair_mask),
        ps.corr_idx[0], ps.corr_mask[0], kind,
        ps.flat_idx[0, :FC], ps.flat_mask[0, :FC]))
    return tuple(int(v) for v in np.asarray(out))


# (packing, lo, hi, seed limit or None, flat cutoff or None): a multi-tile
# segment per packing (wheel30's has group D live), an in-tile sliver with
# unaligned boundary words, and a non-empty flat list
SPLIT_CASES = {
    "odds": ("odds", *SEGMENTS["odds"][0], None, None),
    "wheel30_group_d": ("wheel30", *SEGMENTS["wheel30"][0], None, None),
    "plain": ("plain", *SEGMENTS["plain"][0], None, None),
    "odds_sliver": ("odds", *SEGMENTS["odds"][1], None, None),
    "odds_flat": (*FLAT, "4097"),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_words_match_pallas(monkeypatch, case):
    """(a) Raw words bit for bit, then kernel + postlude for every kind."""
    packing, lo, hi, limit, flat_min = SPLIT_CASES[case]
    if flat_min:
        monkeypatch.setenv("SIEVE_PALLAS_FLAT_MIN", flat_min)
    seeds = seed_primes(limit or math.isqrt(hi - 1))
    ps = pallas_mark.prepare_pallas(packing, lo, hi, seeds)
    seg = segment_from_reference(dataclasses.asdict(ps))
    counts = spec_counts(seg)
    if case == "wheel30_group_d":
        assert counts["D"] > 0
    if case == "odds_flat":
        assert counts["flat_words"] > 0
    if case == "odds_sliver":
        assert seg.Wpad == pallas_mark.TILE_WORDS
    want = _pallas_split_words(ps)
    got = _words_u32(mark_split_reference(seg))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, np.asarray(want))
    # the padding past nbits is marked too, not zeroed
    assert got.reshape(-1)[-(-seg.nbits // 32):].any()
    for gapname in KINDS:
        gap_ps = (ps if GAPS[gapname] == 2 else
                  pallas_mark.prepare_pallas(packing, lo, hi, seeds, pair_gap=4))
        kind = _kind(packing, gapname)
        gap_seg = segment_from_reference(dataclasses.asdict(gap_ps))
        assert mark_cuda_split(gap_seg, kind, device="cpu") == _ref_postlude(
            want, gap_ps, kind), (case, gapname)


def _random_case(rng, W):
    words = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    words[rng.random(W) < 0.5] |= np.uint32(1 << 31)
    real = np.sort(rng.choice(W, 12, replace=False)).astype(np.int32)
    # a real word-0 entry next to the (0, 0) padding, and one word listed
    # twice with different masks: duplicates resolve by min (flat) and max
    # (corrections), in the unsigned order
    fi = np.concatenate([[0], real, [real[3]], np.zeros(5, np.int32)]).astype(np.int32)
    fm = np.concatenate([rng.integers(1, 1 << 32, 14, dtype=np.uint64),
                         np.zeros(5, np.uint64)]).astype(np.uint32)
    ci = np.concatenate([real[:6], [real[2]], np.full(9, -1)]).astype(np.int32)
    cm = np.concatenate([rng.integers(1, 1 << 32, 7, dtype=np.uint64),
                         np.zeros(9, np.uint64)]).astype(np.uint32)
    return words, fi, fm, ci, cm


ALL_KINDS = [pairs.TWIN_NONE, *sorted(pairs.PAIR_SHIFT)]


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_reduce_packed_matches_reference(kind):
    """(b) Random words with bit 31 set, duplicate flat and correction
    indices, the -1 correction padding, and nbits from below one word to
    the full array (the clamped boundary slice)."""
    rng = np.random.default_rng(100 + kind)
    W = 256
    for nbits in (10, 32, 33, 1000, 32 * W - 37, 32 * W - 32, 32 * W):
        words, fi, fm, ci, cm = _random_case(rng, W)
        pmask = int(rng.integers(1, 1 << 32))
        want = jax_mark.reduce_packed(
            jnp.asarray(words), jnp.int32(nbits), kind, jnp.uint32(pmask),
            jnp.asarray(ci), jnp.asarray(cm), jnp.asarray(fi), jnp.asarray(fm))
        want = tuple(int(np.asarray(v).astype(np.uint32)) for v in want)
        t = lambda a: torch.from_numpy(a.astype(np.int64))
        got = reduce.reduce_packed(t(words), nbits, kind, pmask,
                                   t(ci), t(cm), t(fi), t(fm))
        assert tuple(int(v) for v in reduce.pack4(*got)) == want, (kind, nbits)
        # without patch lists, as the word kernel calls it
        want = jax_mark.reduce_packed(jnp.asarray(words), jnp.int32(nbits),
                                      kind, jnp.uint32(pmask))
        got = reduce.reduce_packed(t(words), nbits, kind, pmask)
        assert [int(v) & 0xFFFFFFFF for v in got] == [
            int(np.asarray(v).astype(np.uint32)) for v in want]


def test_negative_index_padding_lands_on_the_last_word():
    words = torch.tensor([5, 0xFFFFFFFF, 7, 0x80000001], dtype=torch.int64)
    ci = torch.tensor([2, -1], dtype=torch.int64)
    cm = torch.tensor([8, 0], dtype=torch.int64)
    count, _, first, last = reduce.reduce_packed(words, 128, pairs.TWIN_NONE,
                                                 0xFFFFFFFF, ci, cm)
    assert int(count) == 2 + 32 + 4 + 2 and int(first) == 5
    # the boundary slice starts at word 3, clamped to 2 as dynamic_slice
    # clamps it: the last 32 flags read as word 2, corrected
    assert int(last) == 7 | 8


# every segment of the fused tests: the multi-tile and sliver segments of
# each packing, the group-D segment and the flat list
SPLIT_VS_FUSED = [(p, lo, hi, None, None) for p in SEGMENTS for lo, hi in SEGMENTS[p]] + [
    (*GROUP_D, None), (*FLAT, "4097")]


@pytest.mark.parametrize("packing,lo,hi,limit,flat_min", SPLIT_VS_FUSED)
def test_split_vs_fused_parity(monkeypatch, packing, lo, hi, limit, flat_min):
    """(c) The port's split path (kernel + postlude) returns the fused
    path's (count, pairs, first, last) for every kind."""
    if flat_min:
        monkeypatch.setenv("SIEVE_PALLAS_FLAT_MIN", flat_min)
    seeds = seed_primes(limit or math.isqrt(hi - 1))
    for gapname in KINDS:
        seg = prepare_cuda(packing, lo, hi, seeds, pair_gap=GAPS[gapname])
        kind = _kind(packing, gapname)
        assert mark_cuda_split(seg, kind, device="cpu") == mark_fused_reference(
            seg, kind), (packing, lo, hi, gapname)


def test_mark_split_on_cpu_runs_plain_version(monkeypatch):
    lo, hi = SEGMENTS["plain"][1]
    seg = prepare_cuda("plain", lo, hi, seed_primes(math.isqrt(hi - 1)))
    before = mark_split.launches
    got = mark_split(seg, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (seg.Wpad,)
    assert torch.equal(got, mark_split_reference(seg))
    assert torch.equal(got, mark_split_reference(seg, chunk_words=4096))
    assert mark_split.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="unsupported device"):
        mark_split(seg, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mark_cuda_split(seg, pairs.TWIN_PLAIN, device="meta")
    # SIEVE_PALLAS_FUSED is read per call
    monkeypatch.delenv("SIEVE_PALLAS_FUSED", raising=False)
    assert fused_enabled()
    monkeypatch.setenv("SIEVE_PALLAS_FUSED", "0")
    assert not fused_enabled()
    assert mark_cuda(seg, pairs.TWIN_PLAIN, device="cpu") == mark_fused_reference(
        seg, pairs.TWIN_PLAIN)


@pytest.mark.parametrize("packing", ["odds", "wheel30"])
def test_run_local_split_matches_reference(monkeypatch, packing):
    """The local run under SIEVE_PALLAS_FUSED=0 in both packages: the
    whole result but the timings, and the split mode's host phases."""
    monkeypatch.setenv("SIEVE_PALLAS_FUSED", "0")
    n = 10**6
    kw = dict(n=n, packing=packing, n_segments=4, count_kind="twins", quiet=True)
    ref = ref_run_local(RefConfig(backend="tpu-pallas", **kw))
    got = run_local(SieveConfig(backend="cuda", device="cpu", **kw))
    assert (got.pi, got.twin_pairs, got.n_segments) == (PI[n], TWINS[n], 4)
    strip = lambda r: [dict(s.to_dict(), elapsed_s=0) for s in r.segments]
    assert strip(got) == strip(ref)
    assert got.host_phases["reduction_mode"] == ref.host_phases["reduction_mode"] == "split"
    assert set(got.host_phases) == set(ref.host_phases)
    assert got.host_phases["postlude_split_s"] > 0
