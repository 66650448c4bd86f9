"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checked``: each number the check compared with
its limit. The line before it, ``setup_parts``, splits the set-up; the
last lines of standard error repeat the numbers compared.

The process imports torch and numpy, then the port (``sieve_torch``),
never JAX or the JAX package, starts no process, and joins every thread
it starts. It exits non-zero without a result when torch sees fewer CUDA
cards than the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

T_TORCH = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, is where imports start
sys.path[0] = str(ROOT)


def main(argv: list[str]) -> int:
    from benchmark import harness, spec

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees {have}",
              file=sys.stderr)
        return 2
    age = harness.interpreter_age_s()
    now = time.perf_counter()
    parts = {"interpreter_s": None if age is None else age - (now - T_START),
             "import_torch_s": T_TORCH - T_START,
             "harness_and_card_check_s": now - T_TORCH}
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              T_TORCH, parts=parts)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
