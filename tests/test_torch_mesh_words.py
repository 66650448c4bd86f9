"""The rounds path and the cold-plane worker on the port's word kernel.

``run_mesh(backend="torch", device="cpu")`` (every shard on the CPU)
against the reference's ``run_mesh(backend="jax")`` on the 8-device
virtual CPU mesh: pi, pairs and every SegmentResult field but the
timings, over workers 1-8 and rounds; the tiny-n fallback keeps the run's
backend; checkpoint and resume. Then ``MeshWorker`` against the numpy
backend, a batch larger than the mesh, and its refusals.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from sieve.backends.cpu_numpy import CpuNumpyWorker as RefNumpyWorker
from sieve.config import SieveConfig as RefConfig
from sieve.parallel.mesh import run_mesh as ref_run_mesh
from sieve.seed import seed_primes as ref_seed_primes
from sieve.seed import twin_reference
from sieve_torch.backends.mesh_backend import MeshWorker, mesh_device_count
from sieve_torch.config import SieveConfig
from sieve_torch.parallel.mesh import run_mesh
from tests.oracles import PI, TWINS


def _n_devices():
    import jax

    try:
        return len(jax.devices("cpu"))
    except RuntimeError:
        return 0


def _fields(res):
    d = dataclasses.asdict(res)
    d.pop("elapsed_s")
    return d


# (packing, count kind, workers, rounds, n)
MESH_CASES = [
    ("plain", "twins", 8, 1, 10**5),
    ("odds", "twins", 8, 1, 10**5),
    ("wheel30", "twins", 8, 1, 10**5),
    ("odds", "twins", 2, 1, 10**5),
    ("odds", "twins", 4, 4, 10**6),
    ("odds", "cousins", 4, 2, 10**6),
    ("wheel30", "primes", 1, 4, 10**6),
    ("plain", "cousins", 8, 2, 123_456),
]


@pytest.mark.parametrize("packing,kind,workers,rounds,n", MESH_CASES)
def test_run_mesh_matches_reference(packing, kind, workers, rounds, n):
    if _n_devices() < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    kw = dict(n=n, packing=packing, count_kind=kind, workers=workers,
              rounds=rounds, quiet=True)
    ref = ref_run_mesh(RefConfig(backend="jax", **kw))
    got = run_mesh(SieveConfig(backend="torch", device="cpu", **kw))
    assert (got.pi, got.twin_pairs, got.n_segments, got.backend) == (
        ref.pi, ref.twin_pairs, workers * rounds, "torch")
    assert [_fields(s) for s in got.segments] == [_fields(s) for s in ref.segments]
    assert set(got.host_phases) == set(ref.host_phases)
    assert got.host_phases["rounds_prepared"] == rounds
    assert got.pi == (PI[n] if n in PI else ref_seed_primes(n).size)
    if kind == "twins":
        assert got.twin_pairs == (TWINS[n] if n in TWINS else twin_reference(n))


def test_run_mesh_tiny_n_falls_back_on_its_backend(monkeypatch):
    from sieve_torch.kernels import word_mark

    calls = []
    real = word_mark.mark_words

    def counted(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr("sieve_torch.backends.torch_words.mark_words", counted)
    res = run_mesh(SieveConfig(n=200, backend="torch", device="cpu", workers=8,
                               twins=True, quiet=True))
    assert (res.pi, res.twin_pairs, res.n_segments, res.backend) == (
        46, twin_reference(200), 1, "torch")
    assert len(calls) == 1  # the local run's one segment, on the word kernel
    with pytest.raises(ValueError, match="cuda backend or the torch backend"):
        run_mesh(SieveConfig(n=10**5, backend="cpu-native", workers=2))


def test_run_mesh_checkpoint_resume(tmp_path):
    cfg = SieveConfig(n=10**5, backend="torch", device="cpu", workers=4, rounds=2,
                      twins=True, quiet=True, checkpoint_dir=str(tmp_path))
    first = run_mesh(cfg)
    assert (first.pi, first.twin_pairs) == (PI[10**5], TWINS[10**5])
    assert first.host_phases["rounds_prepared"] == 2
    # resume: everything restored from the ledger, nothing prepared
    again = run_mesh(SieveConfig(**{**cfg.to_dict(), "resume": True}))
    assert (again.pi, again.twin_pairs) == (PI[10**5], TWINS[10**5])
    assert again.host_phases["rounds_prepared"] == 0
    assert [_fields(s) for s in again.segments] == [_fields(s) for s in first.segments]
    # the ledger is the reference's: it resumes under the reference's jax run
    ref = ref_run_mesh(RefConfig(n=10**5, backend="jax", workers=4, rounds=2,
                                 twins=True, quiet=True, resume=True,
                                 checkpoint_dir=str(tmp_path)))
    assert [_fields(s) for s in ref.segments] == [_fields(s) for s in first.segments]


SEGMENTS = [(2, 40), (1_000, 9_000), (9_000, 17_192), (60_000, 68_192),
            (68_192, 76_384)]


@pytest.mark.parametrize("twins", [False, True])
@pytest.mark.parametrize("packing", ["plain", "odds", "wheel30"])
def test_mesh_worker_matches_cpu_reference(packing, twins):
    cfg = SieveConfig(n=100_000, backend="torch", device="cpu", packing=packing,
                      twins=twins, quiet=True)
    mesh = MeshWorker(cfg, n_devices=8)
    ref = RefNumpyWorker(RefConfig(n=100_000, packing=packing, twins=twins))
    seeds = ref_seed_primes(math.isqrt(max(hi for _, hi in SEGMENTS) - 1))
    sids = [100 + i for i in range(len(SEGMENTS))]
    got = mesh.process_segments(SEGMENTS, seeds, seg_ids=sids)
    for (lo, hi), sid, res in zip(SEGMENTS, sids, got):
        want = ref.process_segment(lo, hi, seeds, seg_id=sid)
        assert _fields(res) == _fields(want), (packing, twins, lo, hi)
    # the sliver went to the numpy backend; the rest to one launch per group
    assert mesh.launches == 2
    assert (mesh.devices, mesh.capacity, mesh.name) == (8, 8, "mesh")
    assert mesh.shards == [torch.device("cpu")] * 8


def test_mesh_pad_masking_batch_larger_than_mesh(monkeypatch):
    """9 equal-span chunks on 8 devices: 16 rows, seven pad rows copying
    row 0; none may leak into the output."""
    from sieve_torch.backends import mesh_backend

    rows = []
    real = mesh_backend.mark_words_batch

    def counted(*a, **k):
        rows.append(a[3].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(mesh_backend, "mark_words_batch", counted)
    cfg = SieveConfig(n=200_000, backend="torch", device="cpu", quiet=True)
    span = 1 << 13
    segs = [(60_000 + i * span, 60_000 + (i + 1) * span) for i in range(9)]
    seeds = ref_seed_primes(200_000)
    mesh = MeshWorker(cfg, n_devices=8)
    got = mesh.process_segments(segs, seeds)
    assert mesh.launches == 1 and rows == [2] * 8
    for (lo, hi), res in zip(segs, got):
        want = int(np.searchsorted(seeds, hi) - np.searchsorted(seeds, lo))
        assert res.count == want


def test_mesh_device_count_and_refusals(monkeypatch):
    cfg = SieveConfig(n=10**5, backend="torch", device="cuda")
    monkeypatch.delenv("SIEVE_MESH_COLD_DEVICES", raising=False)
    assert mesh_device_count("cpu") == 1
    monkeypatch.setenv("SIEVE_MESH_COLD_DEVICES", "3")
    assert mesh_device_count("cpu") == 3
    assert MeshWorker(SieveConfig(n=10**5, backend="torch", device="cpu")).devices == 3
    monkeypatch.delenv("SIEVE_MESH_COLD_DEVICES")
    # no card: the default device raises, nothing falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshWorker(cfg)
    # fewer cards than asked raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_device_count("cuda") == 1
    with pytest.raises(ValueError, match="does not fall back"):
        MeshWorker(cfg, n_devices=2)
