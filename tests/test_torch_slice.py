"""The port's counting run as a whole against the JAX reference.

``sieve_torch`` run_local on the cuda backend (device="cpu": the kernel's
plain PyTorch version) against ``sieve`` run_local on tpu-pallas (Pallas
in interpret mode): the whole SieveResult but the timings, exact, for
every packing and count kind, plus the oracle values. Then the pieces
around the kernel: per-segment worker parity against the reference numpy
backend, the carried config and its hash, the plan, and the CLI.
"""

import contextlib
import dataclasses
import io
import math

import numpy as np
import pytest

from sieve.backends.cpu_numpy import CpuNumpyWorker as RefNumpyWorker
from sieve.config import SieveConfig as RefConfig
from sieve.coordinator import run_local as ref_run_local
from sieve.segments import plan_segments as ref_plan_segments
from sieve.seed import seed_primes as ref_seed_primes
from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import run_local
from sieve_torch.interop import config_from_reference
from tests.oracles import PI, TWINS
from tests.test_backends_parity import FIXTURES

PACKINGS = ["plain", "odds", "wheel30"]
KINDS = ["primes", "twins", "cousins"]
# timings differ run to run; the backend names differ by design
SKIP_KEYS = {"elapsed_s", "values_per_sec", "backend"}


def _pairs_oracle(n, gap):
    s = np.ones(n + 1, bool)
    s[:2] = False
    for p in range(2, math.isqrt(n) + 1):
        if s[p]:
            s[p * p :: p] = False
    primes = np.flatnonzero(s)
    primes = primes[primes + gap <= n]
    return int(np.count_nonzero(s[primes + gap]))


def _strip_result(res):
    d = dataclasses.asdict(res)
    for k in SKIP_KEYS:
        d.pop(k)
    for s in d["segments"]:
        s.pop("elapsed_s")
    ph = d.pop("host_phases") or {}
    return d, {k: (v if isinstance(v, str) else None) for k, v in ph.items()}


@pytest.mark.parametrize("count_kind", KINDS)
@pytest.mark.parametrize("packing", PACKINGS)
def test_run_local_matches_reference(packing, count_kind):
    n = 10**6
    ref = ref_run_local(RefConfig(n=n, backend="tpu-pallas", packing=packing,
                                  n_segments=8, count_kind=count_kind,
                                  quiet=True))
    got = run_local(SieveConfig(n=n, backend="cuda", device="cpu",
                                packing=packing, n_segments=8,
                                count_kind=count_kind, quiet=True))
    assert _strip_result(got) == _strip_result(ref)
    assert got.backend == "cuda" and ref.backend == "tpu-pallas"
    assert got.host_phases["reduction_mode"] == "fused"
    assert got.host_phases["postlude_fused_s"] > 0
    assert got.pi == PI[n]
    if count_kind == "primes":
        assert got.twin_pairs is None
    elif count_kind == "twins":
        assert got.twin_pairs == TWINS[n]
    else:
        assert got.twin_pairs == _pairs_oracle(n, 4)


def _strip(res):
    d = dataclasses.asdict(res)
    d.pop("elapsed_s")
    return d


def _port_worker(backend, packing, n, count_kind):
    from sieve_torch.backends import make_worker

    return make_worker(SieveConfig(n=n, backend=backend, device="cpu",
                                   packing=packing, count_kind=count_kind))


@pytest.mark.parametrize("count_kind", ["twins", "cousins"])
@pytest.mark.parametrize("backend", ["cuda", "cpu-numpy"])
@pytest.mark.parametrize("packing", PACKINGS)
def test_worker_fixture_parity(packing, backend, count_kind):
    """Every backend-parity fixture (p^2 at a boundary, a prime at lo,
    straddling pairs, sub-64-bit slivers, multi-tile) against the
    reference's numpy worker."""
    for lo, hi, n in FIXTURES:
        seeds = ref_seed_primes(math.isqrt(n))
        ref = RefNumpyWorker(RefConfig(n=n, packing=packing,
                                       count_kind=count_kind))
        got = _port_worker(backend, packing, n, count_kind)
        assert _strip(got.process_segment(lo, hi, seeds)) == _strip(
            ref.process_segment(lo, hi, seeds)), (packing, lo, hi)


@pytest.mark.parametrize("packing", PACKINGS)
def test_worker_randomized_parity(packing):
    rng = np.random.default_rng(7)
    n = 10**6
    seeds = ref_seed_primes(math.isqrt(n))
    ref = RefNumpyWorker(RefConfig(n=n, packing=packing, twins=True))
    got = _port_worker("cuda", packing, n, "twins")
    for _ in range(10):
        lo = int(rng.integers(2, n - 10))
        hi = int(rng.integers(lo + 2, min(lo + 200_000, n + 1) + 1))
        assert _strip(got.process_segment(lo, hi, seeds)) == _strip(
            ref.process_segment(lo, hi, seeds)), (packing, lo, hi)


def test_group_d_segment_parity():
    """The n=3e7 group-D segment through the port's worker."""
    n = 30_000_000
    lo, hi = 2_000_003, 24_000_001
    seeds = ref_seed_primes(math.isqrt(n))
    ref = RefNumpyWorker(RefConfig(n=n, packing="odds", twins=True))
    got = _port_worker("cuda", "odds", n, "twins")
    assert _strip(got.process_segment(lo, hi, seeds)) == _strip(
        ref.process_segment(lo, hi, seeds))


@pytest.mark.parametrize("n,segs", [(10**5, 1), (10**5, 7), (999_999, 8), (5, 3)])
def test_plan_matches_reference(n, segs):
    from sieve_torch.segments import plan_segments

    got = [dataclasses.astuple(s) for s in plan_segments(n, segs, n_workers=3)]
    want = [dataclasses.astuple(s) for s in ref_plan_segments(n, segs, n_workers=3)]
    assert got == want


@pytest.mark.parametrize("kw", [
    {"n": 10**9, "packing": "odds"},
    {"n": 10**9, "packing": "wheel30", "twins": True, "n_segments": 5},
    {"n": 10**6, "packing": "plain", "count_kind": "cousins", "segment_values": 4096},
    {"n": 12345, "count_kind": "twins", "n_segments": 3, "backend": "cpu-numpy"},
])
def test_carried_config_hash(kw):
    """(d) A config carried across keeps the reference's ledger key."""
    ref = RefConfig(**{"backend": "tpu-pallas", **kw})
    got = config_from_reference(ref.to_dict(), device="cpu")
    assert got.config_hash() == ref.config_hash()
    assert got.backend == {"tpu-pallas": "cuda"}.get(ref.backend, ref.backend)
    assert (got.count_kind, got.twins, got.pair_gap) == (
        ref.count_kind, ref.twins, ref.pair_gap)
    assert got.device == "cpu"
    # backend and device stay out of the hash
    assert SieveConfig(**{**got.to_dict(), "device": "cuda",
                          "backend": "cpu-numpy"}).config_hash() == got.config_hash()


@pytest.mark.parametrize("field,value", [
    ("profile_dir", "prof"),
])
def test_carried_config_rejects_later_slices(field, value):
    """No field of the reference is refused any more: ``profile_dir`` (a
    torch.profiler trace in the port) carries over, out of the ledger key
    as in the reference."""
    ref = RefConfig(**{"n": 1000, "backend": "tpu-pallas", field: value})
    got = config_from_reference(ref.to_dict(), device="cpu")
    assert getattr(got, field) == value
    assert got.config_hash() == ref.config_hash() == RefConfig(n=1000).config_hash()


@pytest.mark.parametrize("field,value", [
    ("backend", "cpu-cluster"),
    ("chaos", "kill:1@s2,stall:any@s3:0.5"),
    ("chaos_kill", "0@2"),
    ("multihost", True),
    ("trace_file", "t.json"),
    ("metrics_file", "m.jsonl"),
    ("coordinator_addr", "10.0.0.7:9000"),
])
def test_carried_config_takes_distributed_fields(field, value):
    """The cluster, chaos, multihost and observability fields carry over
    as they are; the ledger key stays the reference's."""
    ref = RefConfig(**{"n": 1000, "backend": "tpu-pallas", field: value})
    got = config_from_reference(ref.to_dict(), device="cpu")
    assert getattr(got, field) == value
    assert got.config_hash() == ref.config_hash()
    if field.startswith("chaos"):
        assert [dataclasses.astuple(d) for d in got.chaos_directives()] == [
            dataclasses.astuple(d) for d in ref.chaos_directives()]


def test_config_rejects_unported_parts():
    with pytest.raises(ValueError, match="unknown kind"):
        SieveConfig(n=1000, chaos="frob:1@s2")
    with pytest.raises(ValueError, match="backend"):
        SieveConfig(n=1000, backend="tpu-pallas")


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


@pytest.mark.parametrize("argv", [
    ["--n", "1e5", "--twins", "--segments", "4"],
    ["--n", "1e5", "--count-kind", "cousins", "--packing", "wheel30"],
    ["--n", "100000", "--packing", "plain", "--segment-size", "30000"],
])
def test_cli_output_matches_reference(argv):
    from sieve.cli import main as ref_main
    from sieve_torch.cli import main

    rc, got = _stdout(main, argv + ["--device", "cpu"])
    ref_rc, want = _stdout(ref_main, argv + ["--backend", "cpu-numpy", "--quiet"])
    assert rc == ref_rc == 0
    assert got[:-1] == want[:-1]  # pi and pair lines
    assert got[-1].startswith("backend=cuda ")
    assert want[-1].split()[1:3] == got[-1].split()[1:3]  # packing, segments


def test_cli_json_and_unported_flags(capsys):
    import json

    from sieve_torch.cli import main

    assert main(["--n", "1e5", "--device", "cpu", "--json", "--twins"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert (out["pi"], out["twin_pairs"], out["backend"]) == (PI[10**5], TWINS[10**5], "cuda")
    assert "segments" not in out
    # --workers and --rounds run the rounds path; --checkpoint-dir the ledger
    for flag in ("--workers", "--rounds"):
        assert main(["--n", "1e5", "--device", "cpu", "--json", flag, "2"]) == 0
        out = json.loads(capsys.readouterr().out)
        assert (out["pi"], out["n_segments"]) == (PI[10**5], 2)
        assert out["host_phases"]["reduction_mode"] == "fused"


@pytest.mark.parametrize("packing", PACKINGS)
def test_bitset_matches_reference(packing):
    """The copied layouts: candidate maps, packing and pair counts."""
    from sieve import bitset as ref
    from sieve_torch import bitset

    got, want = bitset.get_layout(packing), ref.get_layout(packing)
    rng = np.random.default_rng(3)
    for lo in [2, 3, 7, 30, 31, 49, 1_000_003] + rng.integers(2, 10**9, 20).tolist():
        hi = lo + int(rng.integers(1, 5000))
        assert got.nbits(lo, hi) == want.nbits(lo, hi)
        assert got.first_candidate(lo) == want.first_candidate(lo)
        for gap in (2, 4):
            assert got.extra_pairs(lo, hi, gap) == want.extra_pairs(lo, hi, gap)
    flags = rng.random(1000) < 0.4
    words = bitset.pack_words(flags)
    np.testing.assert_array_equal(words, ref.pack_words(flags))
    np.testing.assert_array_equal(bitset.unpack_words(words, 1000), flags)
    assert bitset.popcount_words(words) == int(flags.sum())
    for n in (1, 31, 32, 33, 1000):
        assert bitset.boundary_words(flags[:n]) == ref.boundary_words(flags[:n])
    lo = 1_000_003
    f = flags[: got.nbits(lo, lo + 3000)]
    for gap in (2, 4):
        assert got.pairs_internal(f, lo, lo + 3000, gap) == want.pairs_internal(
            f, lo, lo + 3000, gap)
