"""The check's control at a cell's own size: the reference's control
(benchmark/reference/control.py) answers in the program's place, and the
check (benchmark/check.py) judges it as it judges a run. It has to come
out not correct.

    python3 benchmark/control.py --workload <name> --seeds 1 2 3

For each seed it prints the numbers compared, each with its limit, and
the verdict as one JSON line. The control answers the segments the
reference sieves whole (drawn from the seed), and nothing else, so only
the numbers of those segments are compared. The benchmark's own runs
never run it. It needs no card.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from benchmark import check, spec  # noqa: E402
from benchmark.reference import common, control  # noqa: E402


def run(config: dict, segments: int, seed: int) -> tuple[dict, bool]:
    """The control's numbers for one seed, and the check's verdict."""
    ref = check.reference(config, segments, seed)
    only = sorted(ref["whole"])
    gap = check.gap_of(config)
    seeds = common.seed_primes(math.isqrt(int(config["n"])))
    job = {"pi": None, "pairs": None, "segments": [
        control.summarize(config["packing"], *ref["plan"][i], seeds, gap)
        for i in only]}
    numbers = check.compare([job], ref, only=only)
    judged = {k: v for k, v in numbers.items() if v is not None}
    return judged, check.verdict(judged, 1, 0)


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    cell = spec.cell(spec.load(root), args.workload, root)
    config = cell.config
    mix = cell.traffic
    segments = int(mix.get("rounds") or mix["segments"])
    for seed in args.seeds:
        numbers, correct = run(config, segments, seed)
        print(json.dumps({"workload": cell.name, "n": config["n"], "seed": seed,
                          "correct": correct,
                          "checked": {k: {"value": v, "limit": check.LIMITS[k]}
                                      for k, v in numbers.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
