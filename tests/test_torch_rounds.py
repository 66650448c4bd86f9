"""The port's rounds path (run_mesh) against the JAX reference's.

``sieve_torch`` run_mesh with device="cpu" (every shard on the CPU, the
kernels' plain versions) against ``sieve`` run_mesh on tpu-pallas over
the 8-device virtual CPU mesh (Pallas in interpret mode): pi, pairs, the
segment count, every SegmentResult field but elapsed_s, and the
host_phases key set, exact, in both reduction modes, over workers
1/4/8, rounds 1/2/4, each packing and cousins. Then the cross-check, the
refusal to run shards anywhere but on their own cards, and the CLI.
"""

import contextlib
import io

import pytest
import torch

from sieve.config import SieveConfig as RefConfig
from sieve.parallel.mesh import run_mesh as ref_run_mesh
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.kernels import cuda_mark
from sieve_torch.parallel import mesh
from sieve_torch.parallel.mesh import MeshCrossCheckError, run_mesh
from tests.oracles import PI, TWINS


def _n_devices():
    import jax

    try:
        return len(jax.devices("cpu"))
    except RuntimeError:
        return 0


def _segments(res):
    return [dict(s.to_dict(), elapsed_s=0) for s in res.segments]


# (packing, count kind, SIEVE_PALLAS_FUSED, workers, rounds, n). At n=3e6
# only wheel30 has group D live (its bit stride is 8p), so its cases carry
# group D through both kernels.
MESH_CASES = [
    ("odds", "twins", "1", 4, 2, 10**6),
    ("odds", "twins", "0", 8, 1, 10**6),
    ("odds", "cousins", "0", 4, 4, 2 * 10**6),
    ("plain", "primes", "0", 8, 1, 10**6),
    ("plain", "cousins", "1", 8, 2, 10**6),
    ("wheel30", "twins", "1", 1, 4, 3 * 10**6),
    ("wheel30", "cousins", "0", 1, 2, 3 * 10**6),
    ("wheel30", "twins", "0", 4, 2, 3 * 10**6),
]


@pytest.mark.parametrize("packing,kind,fused,workers,rounds,n", MESH_CASES)
def test_run_mesh_matches_reference(monkeypatch, packing, kind, fused,
                                    workers, rounds, n):
    """(d) The whole result but the timings, segment for segment."""
    if _n_devices() < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    monkeypatch.setenv("SIEVE_PALLAS_FUSED", fused)
    kw = dict(n=n, packing=packing, count_kind=kind, workers=workers,
              rounds=rounds, quiet=True)
    ref = ref_run_mesh(RefConfig(backend="tpu-pallas", **kw))
    got = run_mesh(SieveConfig(backend="cuda", device="cpu", **kw))
    assert (got.pi, got.twin_pairs, got.n_segments) == (
        ref.pi, ref.twin_pairs, ref.n_segments)
    assert got.n_segments == workers * rounds
    assert _segments(got) == _segments(ref)
    assert set(got.host_phases) == set(ref.host_phases)
    mode = "fused" if fused == "1" else "split"
    assert got.host_phases["reduction_mode"] == ref.host_phases["reduction_mode"] == mode
    assert got.host_phases["rounds_prepared"] == rounds
    assert 1 <= got.host_phases["peak_resident_rounds"] <= 3  # window + 1
    if n in PI:
        assert got.pi == PI[n]
    if n in TWINS and kind == "twins":
        assert got.twin_pairs == TWINS[n]


@pytest.mark.parametrize("fused", ["1", "0"])
def test_run_mesh_group_d_odds(monkeypatch, fused):
    """The reference's group-D case for odds (dryrun_multichip's n=3e7:
    seeds to 5477, strides past 4096 bits), against the port's numpy
    backend on the same plan."""
    monkeypatch.setenv("SIEVE_PALLAS_FUSED", fused)
    kw = dict(n=30_000_000, packing="odds", twins=True, quiet=True)
    got = run_mesh(SieveConfig(backend="cuda", device="cpu", workers=4,
                               rounds=2, **kw))
    want = run_local(SieveConfig(backend="cpu-numpy", n_segments=8, **kw))
    assert (got.pi, got.twin_pairs) == (want.pi, want.twin_pairs) == (1_857_859, 152_891)
    assert _segments(got) == _segments(want)


def test_run_mesh_small_range_falls_back_to_local():
    res = run_mesh(SieveConfig(n=200, device="cpu", workers=8, twins=True))
    assert (res.pi, res.twin_pairs, res.n_segments) == (46, 15, 1)
    with pytest.raises(ValueError, match="conflicts"):
        run_mesh(SieveConfig(n=10**5, device="cpu", workers=2, n_segments=3))
    with pytest.raises(ValueError, match="segment-size"):
        run_mesh(SieveConfig(n=10**5, device="cpu", workers=2, segment_values=5000))
    with pytest.raises(ValueError, match="cuda backend"):
        run_mesh(SieveConfig(n=10**5, backend="cpu-numpy", workers=2))


def _corrupting(monkeypatch, pos):
    real = mesh._collective_merge

    def corrupt(results, gap_ok, dev0):
        out = real(results, gap_ok, dev0).clone()
        out[pos] ^= 1
        return out

    monkeypatch.setattr(mesh, "_collective_merge", corrupt)


@pytest.mark.parametrize("pos,match", [(0, "count merge"), (1, "straddle twin")])
def test_corrupted_merge_raises(monkeypatch, pos, match):
    """(e) A merged total that disagrees with the per-shard results."""
    _corrupting(monkeypatch, pos)
    cfg = SieveConfig(n=10**5, device="cpu", workers=4, rounds=2, twins=True)
    with pytest.raises(MeshCrossCheckError, match=match):
        run_mesh(cfg)


def test_corrupted_shard_word_raises(monkeypatch):
    """(e) A shard whose first word the host sees differently from the
    merge: the straddle recount disagrees."""
    cfg = SieveConfig(n=10**5, device="cpu", workers=4, rounds=1, twins=True)
    clean = run_mesh(cfg)
    # a shard whose left neighbour's last candidate is prime: flipping the
    # shard's first flag flips the straddle the host counts
    segs = clean.segments
    i = next(i for i in range(1, 4) if segs[i - 1].last_word >> 31)
    _corrupting(monkeypatch, 2 + 2 * 4 + i)   # first32 of shard i
    with pytest.raises(MeshCrossCheckError, match="straddle twin"):
        run_mesh(cfg)


def test_workers_need_their_own_cards(monkeypatch):
    """(h) No shard runs on the CPU, and none on fewer cards than shards."""
    def no_prep(*a, **k):
        raise AssertionError("a shard was prepared")

    monkeypatch.setattr(mesh, "seed_primes", no_prep)
    before = (cuda_mark.mark_fused.launches, cuda_mark.mark_split.launches)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_mesh(SieveConfig(n=10**6, workers=2, device="cuda"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="does not fall back"):
        run_mesh(SieveConfig(n=10**6, workers=2, device="cuda"))
    with pytest.raises(ValueError, match="does not fall back"):
        run_mesh(SieveConfig(n=10**6, workers=1, rounds=4, device="cuda:1"))
    assert mesh.shard_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert mesh.shard_devices("cuda", 1) == [torch.device("cuda", 0)]
    assert (cuda_mark.mark_fused.launches, cuda_mark.mark_split.launches) == before


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_rounds(capsys, tmp_path):
    """(i) The rounds path through the command line, with a checkpoint and
    its resume."""
    import json

    from sieve_torch.cli import main

    rc, out = _stdout(main, ["--n", "1e6", "--device", "cpu", "--rounds", "4",
                             "--twins"])
    assert rc == 0
    assert out[:2] == ["pi(1000000) = 78498",
                       "twin pairs (p, p+2 <= 1000000) = 8169"]
    assert out[2].startswith("backend=cuda packing=odds segments=4 ")
    rc, out = _stdout(main, ["--n", "1e6", "--device", "cpu", "--workers", "4",
                             "--rounds", "2", "--count-kind", "cousins",
                             "--packing", "wheel30"])
    assert rc == 0 and "segments=8 " in out[-1]
    # a mismatched --segments is refused with the reference's message
    assert main(["--n", "1e6", "--device", "cpu", "--rounds", "4",
                 "--segments", "3"]) == 2
    assert "conflicts" in capsys.readouterr().err
    ck = ["--n", "1e6", "--device", "cpu", "--rounds", "4", "--twins", "--json",
          "--checkpoint-dir", str(tmp_path)]
    for extra, prepared in (([], 4), (["--resume"], 0)):
        rc, out = _stdout(main, ck + extra)
        got = json.loads(out[-1])
        assert rc == 0 and (got["pi"], got["twin_pairs"]) == (PI[10**6], TWINS[10**6])
        assert got["host_phases"]["rounds_prepared"] == prepared
