"""The arithmetic behind the kernels' bounds, and behind their register pass.

``chip_smoke.py`` judges each kernel against a bound counted from the
segment's data: ``_hits`` (the bits a group's live specs clear),
``_work`` (the fused function's integer work) and ``_split_bound`` (the
split function's, padding included). Here each count equals a brute-force
count over every bit, on small segments of each packing whose tables hold
all four groups: for every distinct stride m, a bincount of b % m over
the bits [0, N) gives how many bits each residue class holds, and each
live spec (m, r) clears the bits of its class. The brute force reads the
JAX package's tables (prepare_pallas), which the port's equal array for
array, so the bound is tied to the reference's data.

The register pass of fused_mark.cu derives two things on the device: a
thread's offset x % m from a multiply-high by (0xFFFFFFFF // m) + 1, for
x = 32 * tid < 2^15, and group A's shifted m-periodic pattern. Both
identities are checked here over every x the kernel gives them and every
stride the tables can send there.
"""

import math

import numpy as np
import pytest

import chip_smoke
from sieve.kernels import pallas_mark
from sieve.seed import seed_primes
from sieve_torch.kernels import pairs
from sieve_torch.kernels.cuda_mark import fused_inputs, prepare_cuda, spec_counts

# ~40,000 bits each, seeds to 5,000: groups A (not wheel30), B, C and D
# (strides 4,097-65,536, every first hit below nbits) are all populated
SEGMENTS = {
    "odds": (25_000_001, 25_080_001),
    "plain": (25_000_000, 25_040_000),
    "wheel30": (25_000_020, 25_150_020),
}
DEV = {"sms": 132, "max_sm_mhz": 1980.0}


def _clears(table, n_bits: int) -> int:
    """(bit, live spec) clears in [0, n_bits), counted bit by bit."""
    m = table[0].ravel().astype(np.int64)
    r = table[1].ravel().astype(np.int64) % m
    live = table[-1].ravel() != 0
    bits = np.arange(n_bits, dtype=np.int64)
    total = 0
    for mm in np.unique(m[live]):
        per_class = np.bincount(bits % mm, minlength=mm)
        total += int(per_class[r[live & (m == mm)]].sum())
    return total


@pytest.fixture(scope="module", params=sorted(SEGMENTS))
def segment(request):
    packing = request.param
    lo, hi = SEGMENTS[packing]
    seeds = seed_primes(math.isqrt(hi - 1))
    ref = pallas_mark.prepare_pallas(packing, lo, hi, seeds)
    seg = prepare_cuda(packing, lo, hi, seeds)
    counts = spec_counts(seg)
    assert counts["B"] and counts["C"] and counts["D"], counts
    assert counts["A"] or packing == "wheel30", counts
    return packing, ref, seg


def test_hits_match_brute_force(segment):
    """_hits of every group, below nbits and below 32 * Wpad."""
    _, ref, seg = segment
    for g in ("A", "B", "C", "D"):
        for n_bits in (seg.nbits, 32 * seg.Wpad):
            got = chip_smoke._hits(getattr(seg, g), n_bits)
            assert got == _clears(getattr(ref, g), n_bits), (g, n_bits)


@pytest.mark.parametrize("shift", [0, 2])
def test_work_matches_brute_force(segment, shift):
    """The fused function's work: a pattern AND per (word, live A spec),
    a clear per B-D hit below nbits, one op per flat and correction word,
    per word a popcount and, with a pair count, five ALU ops and a second
    popcount."""
    _, ref, seg = segment
    work = chip_smoke._work(seg, shift)
    words = -(-ref.nbits // 32)
    n_a = int(np.count_nonzero(ref.A[-1]))
    hits = {g: _clears(getattr(ref, g), ref.nbits) for g in ("B", "C", "D")}
    patches = (int(np.count_nonzero(ref.flat_mask))
               + int(np.count_nonzero(ref.corr_mask)))
    assert work["words"] == words
    assert work["A_ops"] == words * n_a
    assert work["hits"] == hits
    assert work["alu"] == (words * n_a + sum(hits.values()) + patches
                           + (5 * words if shift else 0))
    assert work["popc"] == words * (2 if shift else 1)


def test_split_bound_matches_brute_force(segment):
    """The split function's work counts the padding: every clear below
    32 * Wpad; its bytes are the group tables read once and the words
    written once."""
    _, ref, seg = segment
    x = fused_inputs(seg, "cpu")
    ms, by, work = chip_smoke._split_bound(seg, x, DEV)
    padded = 32 * ref.Wpad
    n_a = int(np.count_nonzero(ref.A[-1]))
    hits = {g: _clears(getattr(ref, g), padded) for g in ("B", "C", "D")}
    assert work["hits"] == hits
    assert work["alu"] == ref.Wpad * n_a + sum(hits.values())
    table_words = sum(np.asarray(a).size for g in ("A", "B", "C", "D")
                      for a in (getattr(ref, g)[0], getattr(ref, g)[1],
                                getattr(ref, g)[-1]))
    assert work["bytes"] == 4 * (table_words + ref.Wpad)
    ops_ms = work["alu"] / (DEV["sms"] * chip_smoke.INT32_LANES_PER_SM
                            * DEV["max_sm_mhz"] * 1e6) * 1e3
    bytes_ms = work["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert ms == pytest.approx(max(ops_ms, bytes_ms), rel=1e-12)
    assert by == ("operations" if ops_ms >= bytes_ms else "bytes")


def test_fused_bound_takes_the_larger_time(segment):
    _, _, seg = segment
    x = fused_inputs(seg, "cpu")
    shift = pairs.PAIR_SHIFT[pairs.TWIN_ADJ]
    for need_bits in (False, True):
        ms, by, work, alu_peak, popc_peak = chip_smoke._bound(seg, x, DEV, shift,
                                                              need_bits)
        ops_ms = max(work["alu"] / alu_peak, work["popc"] / popc_peak) * 1e3
        nbytes = 4 * (x.buf.numel() + 4 + (seg.Wpad if need_bits else 0))
        bytes_ms = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        assert ms == pytest.approx(max(ops_ms, bytes_ms), rel=1e-12)
        assert by == ("operations" if ops_ms >= bytes_ms else "bytes")


def test_register_pass_arithmetic(segment):
    """x // m == umulhi(x, (0xFFFFFFFF // m) + 1) for every thread offset
    x = 32 * tid (tid < 1024) and every stride 2 <= m <= 1024 (all of
    group A and group B; the kernel's register pass takes A and B strides
    below 96), and group A's pattern shifted by s < m is exactly the bits
    s, s + m, ... of a word."""
    _, ref, _ = segment
    x = 32 * np.arange(1024, dtype=np.uint64)
    strides = set(range(2, 1025))
    strides |= {int(m) for g in ("A", "B") for m in getattr(ref, g)[0].ravel()}
    for m in sorted(strides):
        magic = np.uint64(0xFFFFFFFF // m + 1)
        q = (x * magic) >> np.uint64(32)
        np.testing.assert_array_equal(q, x // np.uint64(m), err_msg=f"m={m}")
    for m in range(2, 32):
        pat = sum(1 << b for b in range(0, 32, m))
        for s in range(m):
            want = sum(1 << b for b in range(s, 32, m))
            assert (pat << s) & 0xFFFFFFFF == want, (m, s)
