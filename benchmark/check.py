"""The comparison that decides ``correct``: every job the window ran,
held against the plain reference (benchmark/reference/).

Each job's answer is its segment list (lo, hi, count, twin_count,
first_word, last_word, nbits) and its merged pi and pair count. The
numbers compared, each with the limit 0 (integer arithmetic, exact):

- ``plan_err``: segments whose bounds differ from the reference's plan,
  or that are missing or extra;
- ``word_err``: first and last words that differ from the reference's,
  over every segment of every job (they carry the straddling pairs);
- ``seg_count_err`` and ``seg_pairs_err``: the largest gap in a segment's
  prime and pair count, over the segments the reference sieved whole (a
  sample drawn from the seed, as many as ``FLAG_BUDGET`` flags allow, at
  least one) in every job;
- ``pi_err``: the largest gap of a job's pi(N) from the Lucy-Hedgehog
  count;
- ``pairs_err``: the largest gap of a job's pair count from the
  reference's own merge when it sieved every segment, else from the
  published count that the configuration names. With neither, the
  check cannot judge the pairs, and the run is not correct.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.reference import common, packing

# flags the reference sieves whole in one run: one segment of the 10^11
# configuration (7.8e8 flags) takes seconds of one core, and the check
# has to stay well inside the window's length
FLAG_BUDGET = 1_000_000_000
FIELDS = ("count", "twin_count", "first_word", "last_word", "nbits")


def sample(plan: list[tuple[int, int]], seed: int) -> list[int]:
    """Segments sieved whole: a seeded draw, as many as FLAG_BUDGET holds
    (every segment when the whole run fits), at least one."""
    order = np.random.default_rng(seed).permutation(len(plan)).tolist()
    picked, flags = [], 0
    for i in order:
        lo, hi = plan[i]
        if picked and flags + (hi - lo) // 2 > FLAG_BUDGET:
            break
        picked.append(i)
        flags += (hi - lo) // 2
    return sorted(picked)


def reference(config: dict, n_segments: int, seed: int) -> dict:
    """What the jobs must answer: the plan, the segments sieved whole, every
    segment's edge words, pi(N) and the pair count (or None)."""
    n, gap = int(config["n"]), gap_of(config)
    mod = packing(config["packing"])
    plan = common.plan(n, n_segments)
    seeds = common.seed_primes(math.isqrt(n))
    whole = {i: mod.summarize(*plan[i], seeds, gap) for i in sample(plan, seed)}
    words = [mod.boundary_words(lo, hi, seeds) for lo, hi in plan]
    pairs = None
    if gap == 0:
        pairs = 0
    elif len(whole) == len(plan):
        segs = [whole[i] for i in range(len(plan))]
        pairs = sum(s["twin_count"] for s in segs) + sum(
            mod.straddles(a, b, n, gap) for a, b in zip(segs, segs[1:]))
    elif config.get("published", {}).get("n") == n:
        pairs = config["published"]["pairs"]
    return {"plan": plan, "whole": whole, "words": words,
            "pi": common.prime_pi(n), "pairs": pairs}


def gap_of(config: dict) -> int:
    return {"primes": 0, "twins": 2, "cousins": 4}[config["count_kind"]]


def compare(jobs: list[dict], ref: dict, only: list[int] | None = None
            ) -> dict[str, int | None]:
    """The numbers compared (module docstring) over ``jobs``, each a dict
    with ``pi``, ``pairs`` and ``segments`` (dicts with lo, hi and
    FIELDS). ``only`` restricts the comparison to those segments of the
    plan (the control answers no others). A number is None where no job
    gave one to compare."""
    plan, whole, words = ref["plan"], ref["whole"], ref["words"]
    idx = range(len(plan)) if only is None else only
    want = {plan[i] for i in idx}
    out = {"plan_err": 0, "word_err": 0, "seg_count_err": None,
           "seg_pairs_err": None, "pi_err": None, "pairs_err": None}

    def worst(key: str, gap: int) -> None:
        out[key] = gap if out[key] is None else max(out[key], gap)

    for job in jobs:
        segs = {(s["lo"], s["hi"]): s for s in job["segments"]}
        out["plan_err"] += len(want - set(segs)) + (
            len(set(segs) - want) if only is None else 0) + (
            len(job["segments"]) - len(segs))           # duplicates
        for i in idx:
            s = segs.get(plan[i])
            if s is None:
                continue
            first, last, _ = words[i]
            out["word_err"] += (s["first_word"] != first) + (s["last_word"] != last)
            if i in whole:
                worst("seg_count_err", abs(s["count"] - whole[i]["count"]))
                worst("seg_pairs_err", abs(s["twin_count"] - whole[i]["twin_count"]))
        if job.get("pi") is not None:
            worst("pi_err", abs(job["pi"] - ref["pi"]))
        if job.get("pairs") is not None and ref["pairs"] is not None:
            worst("pairs_err", abs(job["pairs"] - ref["pairs"]))
    return out


LIMITS = {"plan_err": 0, "word_err": 0, "seg_count_err": 0,
          "seg_pairs_err": 0, "pi_err": 0, "pairs_err": 0}


def verdict(numbers: dict[str, int | None], jobs: int, failed: int) -> bool:
    """Correct: at least one job, none failed, and every number compared
    is present and within its limit."""
    return jobs > 0 and failed == 0 and all(
        v is not None and v <= LIMITS[k] for k, v in numbers.items())
