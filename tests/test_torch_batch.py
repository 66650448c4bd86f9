"""The batched ``process_segments`` seam of the port against the reference.

The default loop (every worker) and the torch backend's grouped batches
equal the sequential ``process_segment`` results, field for field but
``elapsed_s``, across packings and pair kinds, with a sub-64-bit sliver
inside the batch (numpy path) and segments of several shapes (several
groups); the torch backend's batches equal the reference jax backend's
and form the same number of groups.
"""

import dataclasses
import math

import pytest

from sieve.backends import jax_backend as ref_jax_backend
from sieve.backends.cpu_numpy import CpuNumpyWorker as RefNumpyWorker
from sieve.config import SieveConfig as RefConfig
from sieve.seed import seed_primes as ref_seed_primes
from sieve_torch.backends import torch_words
from sieve_torch.backends.cpu_numpy import CpuNumpyWorker
from sieve_torch.backends.torch_words import TorchWorker
from sieve_torch.config import SieveConfig

PACKINGS = ["plain", "odds", "wheel30"]

# mixed spans and alignments: a sub-word sliver (numpy path inside a
# device batch), unaligned bounds, and two equal-span chunks that land in
# one group
SEGMENTS = [
    (2, 40),
    (1_000, 9_000),
    (9_000, 17_192),
    (60_000, 68_192),
    (68_192, 76_384),
]
SEEDS = ref_seed_primes(math.isqrt(max(hi for _, hi in SEGMENTS) - 1))


def _fields(res):
    d = dataclasses.asdict(res)
    d.pop("elapsed_s")
    return d


def _counting(monkeypatch, module, name="mark_words_batch"):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(args[0])
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("packing", PACKINGS)
def test_default_loop_matches_sequential(packing):
    cfg = SieveConfig(n=100_000, backend="cpu-numpy", packing=packing, quiet=True)
    w = CpuNumpyWorker(cfg)
    sids = [100 + i for i in range(len(SEGMENTS))]
    batched = w.process_segments(SEGMENTS, SEEDS, seg_ids=sids)
    assert len(batched) == len(SEGMENTS)
    for (lo, hi), sid, res in zip(SEGMENTS, sids, batched):
        assert _fields(res) == _fields(w.process_segment(lo, hi, SEEDS, seg_id=sid))
    # default seg_ids are positional; a length mismatch is a caller bug
    assert [r.seg_id for r in w.process_segments(SEGMENTS[:2], SEEDS)] == [0, 1]
    with pytest.raises(ValueError, match="seg_ids"):
        w.process_segments(SEGMENTS, SEEDS, seg_ids=[0])


@pytest.mark.parametrize("count_kind", ["primes", "twins", "cousins"])
@pytest.mark.parametrize("packing", PACKINGS)
def test_torch_batch_matches_sequential(monkeypatch, packing, count_kind):
    """Batched against sequential on the torch backend, against the
    reference's jax batches (same results, same number of groups) and its
    numpy backend."""
    kw = dict(n=100_000, packing=packing, count_kind=count_kind, quiet=True)
    w = TorchWorker(SieveConfig(backend="torch", device="cpu", **kw))
    calls = _counting(monkeypatch, torch_words)
    ref_calls = _counting(monkeypatch, ref_jax_backend)
    sids = [7 + i for i in range(len(SEGMENTS))]
    batched = w.process_segments(SEGMENTS, SEEDS, seg_ids=sids)
    ref = ref_jax_backend.JaxWorker(RefConfig(backend="jax", **kw))
    ref_batched = ref.process_segments(SEGMENTS, SEEDS, seg_ids=sids)
    # (9_000, 17_192) and the two 8,192-value chunks share a shape; the
    # (1_000, 9_000) chunk has other seeds in range and forms its own group
    assert len(calls) == len(ref_calls) >= 2
    assert sorted(calls) == sorted(ref_calls)  # the groups' Wpad
    numpy = RefNumpyWorker(RefConfig(backend="cpu-numpy", **kw))
    for (lo, hi), sid, got, want in zip(SEGMENTS, sids, batched, ref_batched):
        one = _fields(w.process_segment(lo, hi, SEEDS, seg_id=sid))
        assert _fields(got) == one == _fields(want), (lo, hi)
        assert one == _fields(numpy.process_segment(lo, hi, SEEDS, seg_id=sid))
    with pytest.raises(ValueError, match="seg_ids"):
        w.process_segments(SEGMENTS, SEEDS, seg_ids=[0])
    assert w.process_segments([], SEEDS) == []


def test_torch_batch_one_group_of_equal_chunks(monkeypatch):
    """Sixteen equal chunks above a prime-dense prefix: one batched call
    for all of them, results in input order."""
    w = TorchWorker(SieveConfig(n=2 * 10**6, backend="torch", device="cpu",
                                twins=True, quiet=True))
    seeds = ref_seed_primes(math.isqrt(2 * 10**6))
    segs = [(10**6 + i * 50_000, 10**6 + (i + 1) * 50_000) for i in range(16)]
    calls = _counting(monkeypatch, torch_words)
    batched = w.process_segments(segs, seeds, seg_ids=list(range(16, 0, -1)))
    assert len(calls) == 1
    for (lo, hi), sid, res in zip(segs, range(16, 0, -1), batched):
        assert (res.lo, res.hi, res.seg_id) == (lo, hi, sid)
        assert _fields(res) == _fields(w.process_segment(lo, hi, seeds, seg_id=sid))
