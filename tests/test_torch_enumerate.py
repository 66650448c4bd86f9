"""The port's prime enumeration and ``--emit-primes`` against the reference's.

Counterparts of tests/test_enumerate.py: the same windows per packing go
through ``sieve.enumerate.primes_in_range`` and
``sieve_torch.enumerate.primes_in_range`` and must give equal arrays,
including windows across the internal ``_SLICE`` cut and at ``MAX_HI``,
checked again against a Miller-Rabin oracle independent of every sieve;
the refusals raise the same errors with the same messages; and the CLI's
``--emit-primes`` writes the same bytes as the reference's, as text and
as ``--json``.
"""

import json

import numpy as np
import pytest

from sieve import enumerate as ref_enum
from sieve.cli import main as ref_main
from sieve.seed import seed_primes as ref_seed_primes
from sieve_torch import enumerate as enum
from sieve_torch.bitset import get_layout
from sieve_torch.cli import main

PACKINGS = ("plain", "odds", "wheel30")
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _is_prime(n: int) -> bool:
    # deterministic Miller-Rabin for n < 3.3e24 (bases 2..37)
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _collect(mod, packing, lo, hi, **kw):
    chunks = list(mod.primes_in_range(packing, lo, hi, **kw))
    return [c.tolist() for c in chunks]


def _both(packing, lo, hi, **kw):
    got = _collect(enum, packing, lo, hi, **kw)
    want = _collect(ref_enum, packing, lo, hi, **kw)
    assert got == want  # the same chunks, not only the same primes
    return [v for c in got for v in c]


def test_constants_equal_the_reference():
    assert (enum.MAX_SPAN, enum.MAX_HI, enum._SLICE) == (
        ref_enum.MAX_SPAN, ref_enum.MAX_HI, ref_enum._SLICE)


@pytest.mark.parametrize("packing", PACKINGS)
@pytest.mark.parametrize("lo,hi", [(2, 10_001), (2, 3), (2, 8), (90, 100),
                                   (7919, 7920), (999_900, 1_000_100), (1, 2),
                                   (0, 1), (0, 2), (0, 3), (10_000, 10_000)])
def test_windows_equal_the_reference(packing, lo, hi):
    got = _both(packing, lo, hi)
    oracle = ref_seed_primes(max(hi, 2))
    assert got == oracle[(oracle >= lo) & (oracle < hi)].tolist()


@pytest.mark.parametrize("packing", PACKINGS)
def test_across_the_slice_cut(packing):
    lo, hi = enum._SLICE - 60, enum._SLICE + 60
    assert _both(packing, lo, hi) == [v for v in range(lo, hi) if _is_prime(v)]


def test_window_wider_than_one_slice():
    got = _both("odds", 10, 2**24 + 1000)
    assert got[0] == 11 and len(got) == ref_seed_primes(2**24 + 999).size - 4


@pytest.mark.parametrize("packing", PACKINGS)
def test_window_ending_at_max_hi(packing):
    lo, hi = enum.MAX_HI - 200, enum.MAX_HI
    assert _both(packing, lo, hi) == [v for v in range(lo, hi) if _is_prime(v)]


@pytest.mark.parametrize("lo,hi", [(2, 2 * 10**9 + 10),
                                   (ref_enum.MAX_HI - 10, ref_enum.MAX_HI + 1)])
def test_refusals_equal_the_reference(lo, hi):
    with pytest.raises(ValueError) as want:
        ref_enum.primes_in_range("odds", lo, hi)
    with pytest.raises(ValueError) as got:
        enum.primes_in_range("odds", lo, hi)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("packing", PACKINGS)
def test_bounds_and_flags_fn_seam(packing):
    """``bounds`` cuts the slices; ``flags_fn`` serves some of them and
    ``None`` falls back to the local marking, as in the reference."""
    bounds = [2, 1_000, 5_000, 20_001]
    layout = get_layout(packing)
    served = {}

    def flags_fn(mod):
        def fn(slo, shi):
            if slo == 1_000:
                served.setdefault(mod, []).append((slo, shi))
                flags = np.zeros(layout.nbits(slo, shi), dtype=bool)
                return flags  # a deliberately empty slice: the seam is used
            return None
        return fn

    got = _collect(enum, packing, 2, 20_001, bounds=bounds, flags_fn=flags_fn(enum))
    want = _collect(ref_enum, packing, 2, 20_001, bounds=bounds,
                    flags_fn=flags_fn(ref_enum))
    assert got == want
    assert served[enum] == served[ref_enum] == [(1_000, 5_000)]
    flat = [v for c in got for v in c]
    assert not [v for v in flat if 1_000 <= v < 5_000]


@pytest.mark.parametrize("argv", [
    ["--emit-primes", "90:100"],
    ["--emit-primes", "2:30", "--json"],
    ["--emit-primes", "1:10", "--packing", "wheel30"],
    ["--emit-primes", "999900:1000100", "--packing", "plain"],
    ["--emit-primes", "999900:1000100", "--json", "--packing", "wheel30"],
    ["--emit-primes", "24:28"],
    ["--emit-primes", "24:28", "--json"],
    ["--emit-primes", f"{2**24 - 100}:{2**24 + 100}", "--json"],
])
def test_emit_primes_bytes_equal_the_reference(argv, capsys):
    assert ref_main(argv) == 0
    want = capsys.readouterr().out
    assert main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    if "--json" in argv:
        json.loads(got)


def test_emit_primes_needs_no_n_and_refuses_bad_windows(capsys):
    assert main(["--emit-primes", "90:100"]) == 0
    assert capsys.readouterr().out == "97\n"
    assert main([]) == 2
    assert "--n is required" in capsys.readouterr().err
    for bad in ("90", "a:b", "1:2:3"):
        assert ref_main(["--emit-primes", bad]) == 2
        want = capsys.readouterr().err.split("error: ", 1)[1]
        assert main(["--emit-primes", bad]) == 2
        assert capsys.readouterr().err.split("error: ", 1)[1] == want
