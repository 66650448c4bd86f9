"""The plain reference against published counts, and its control."""

import math

import pytest

from benchmark import check
from benchmark.reference import common, control, packing

# pi(10^k) and twin pairs below 10^k (OEIS A006880, A007508)
PI = {10: 4, 100: 25, 10**3: 168, 10**4: 1229, 10**5: 9592, 10**6: 78498,
      10**7: 664579, 10**8: 5761455, 10**9: 50847534}
TWINS = {10**3: 35, 10**4: 205, 10**5: 1224, 10**6: 8169, 10**7: 58980}


@pytest.mark.parametrize("n", sorted(PI))
def test_prime_pi(n):
    assert common.prime_pi(n) == PI[n]


@pytest.mark.parametrize("n", sorted(TWINS))
@pytest.mark.parametrize("k", [1, 3, 8, 64])
@pytest.mark.parametrize("chunk", [1000, 1 << 24])
def test_segments_merge_to_published_counts(n, k, chunk):
    odds = packing("odds")
    seeds = common.seed_primes(math.isqrt(n))
    segs = [odds.summarize(lo, hi, seeds, 2, chunk=chunk)
            for lo, hi in common.plan(n, k)]
    assert sum(s["count"] for s in segs) == PI[n]
    straddle = sum(odds.straddles(a, b, n, 2) for a, b in zip(segs, segs[1:]))
    assert sum(s["twin_count"] for s in segs) + straddle == TWINS[n]
    for s in segs:
        assert odds.boundary_words(s["lo"], s["hi"], seeds) == (
            s["first_word"], s["last_word"], s["nbits"])


@pytest.mark.parametrize("n,k", [(10**6, 64), (10**7, 7), (10**9, 1), (10**11, 64)])
def test_plan_is_the_ports(n, k):
    from sieve_torch.segments import plan_segments

    assert common.plan(n, k) == [(s.lo, s.hi) for s in plan_segments(n, k)]


def test_reference_check_passes_itself():
    config = {"n": 10**7, "packing": "odds", "count_kind": "twins"}
    ref = check.reference(config, 8, seed=5)
    odds = packing("odds")
    seeds = common.seed_primes(math.isqrt(10**7))
    segs = [odds.summarize(lo, hi, seeds, 2) for lo, hi in ref["plan"]]
    numbers = check.compare([{"pi": PI[10**7], "pairs": TWINS[10**7],
                              "segments": segs}], ref)
    assert check.verdict(numbers, 1, 0), numbers


@pytest.mark.parametrize("workload", ["twins_1e11.local", "torch_twins_1e9.local"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails(workload, seed):
    """The control at a size a test run holds: not correct on any seed."""
    from pathlib import Path

    from benchmark import control as control_run, spec

    root = Path(check.__file__).resolve().parents[1]
    cell = spec.cell(spec.load(root), workload, root)
    config = dict(cell.config, n=10**7)
    segments = int(cell.traffic.get("rounds") or cell.traffic["segments"])
    numbers, correct = control_run.run(config, segments, seed)
    assert not correct
    assert numbers["seg_count_err"] >= 1


def test_control_drops_the_largest_live_seed():
    seeds = common.seed_primes(31622)
    assert control.dropped_seed(seeds, 10**9 + 1) == 31607
    # 31607 * q for the primes q in [31607, 10^9 / 31607] (31607 and
    # 31627) are then counted as primes
    base = packing("odds").summarize(999_000_001, 10**9 + 1, seeds, 2)
    ctl = control.summarize("odds", 999_000_001, 10**9 + 1, seeds, 2)
    assert ctl["count"] - base["count"] == 2
