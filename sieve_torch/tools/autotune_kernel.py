"""Autotune the fused kernel's knobs on the card at hand: the port of the
reference's ``tools/autotune_kernel.py``.

Sweeps SIEVE_PALLAS_DMIN (the C/D split point) and SIEVE_PALLAS_FLAT_MIN
(the kernel-exit cutoff) by coordinate descent and writes the winning
values to the port's tuned file, which sieve_torch/kernels/cuda_mark.py
loads at import (resolution per knob: explicit env var > tuned file >
built-in default). The tuned file is SIEVE_TUNED_JSON when that is set,
else ``tuned_cuda.json`` at the repository's root; the TPU's
``tuned.json`` is never read or written. There is no SIEVE_PALLAS_ROWS
axis: the CUDA tile is fixed at 128 rows (``cuda_mark.R_ROWS``).

Each trial runs in a FRESH interpreter (D_MIN is read at module import)
via ``--measure`` self-invocation, timing the warm fused mark+reduce
(``mark_fused``: the tables' copy, the kernel and the 16-byte fetch) on
one odds segment, best of 3: by CUDA events on a card, by the host clock
with ``--device cpu`` (the plain version; rankings there say nothing of
the card). The parent rejects any knob setting whose (count, pairs,
first, last) result differs from the baseline's, so a fast-but-wrong
configuration can never be written.

Usage: python -m sieve_torch.tools.autotune_kernel [span] [lo] [--device D]

    span  window size in values (default 1e9 on a card, 3e6 on the CPU)
    lo    window start (default 2; use 999000000000 for the depth regime)
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

from sieve_torch.tools import REPO

KNOBS = {
    "SIEVE_PALLAS_DMIN": [4096, 8192, 16384],
    # 0 = the crossings-proportional auto cutoff; explicit values bracket
    # it for depth-regime windows
    "SIEVE_PALLAS_FLAT_MIN": [0, 1 << 22, 1 << 24, 1 << 26],
}
DEFAULTS = {
    "SIEVE_PALLAS_DMIN": 4096,
    "SIEVE_PALLAS_FLAT_MIN": 0,
}


def measure(span: int, lo: int, device: str) -> None:
    """Child mode: knobs arrive via env; print one JSON line and exit."""
    import torch

    from sieve_torch.backends.cuda import resolve_device
    from sieve_torch.kernels.cuda_mark import mark_fused, prepare_cuda
    from sieve_torch.kernels.pairs import TWIN_ADJ
    from sieve_torch.seed import seed_primes

    dev = resolve_device(device)
    hi = lo + span
    seeds = seed_primes(math.isqrt(hi - 1))
    seg = prepare_cuda("odds", lo, hi, seeds)
    res = mark_fused(seg, TWIN_ADJ, device=dev)  # build/load + warm
    best = float("inf")
    for _ in range(3):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(dev)
            start.record()
            out = mark_fused(seg, TWIN_ADJ, device=dev)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = mark_fused(seg, TWIN_ADJ, device=dev)
            sec = time.perf_counter() - t0
        best = min(best, sec)
        if out != res:
            raise RuntimeError(f"nondeterministic kernel result: {out} != {res}")
    print(json.dumps({"seconds": best, "result": list(res)}))


def run_trial(knobs: dict, span: int, lo: int, device: str) -> dict | None:
    env = dict(os.environ)
    env.update({k: str(v) for k, v in knobs.items()})
    # a pre-existing tuned file must not leak into the trial being measured
    env["SIEVE_TUNED_JSON"] = os.devnull
    proc = subprocess.run(
        [sys.executable, "-m", "sieve_torch.tools.autotune_kernel", "--measure",
         str(span), str(lo), "--device", device],
        env=env, cwd=REPO, capture_output=True, text=True,
    )
    if proc.returncode != 0:
        print(f"    trial {knobs} FAILED:\n{proc.stderr.strip()[-500:]}",
              file=sys.stderr)
        return None
    return json.loads(proc.stdout.strip().splitlines()[-1])


def tuned_path() -> str:
    """Where the sweep writes: SIEVE_TUNED_JSON, else tuned_cuda.json at
    the repository's root (the file cuda_mark.py loads)."""
    from sieve_torch import env

    return env.env_str("SIEVE_TUNED_JSON") or os.path.join(REPO, "tuned_cuda.json")


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("span", nargs="?", default=None)
    p.add_argument("lo", nargs="?", default="2")
    p.add_argument("--device", default="cuda",
                   help="cuda (the fused kernel; the card must exist) or cpu")
    args = p.parse_args(argv)
    if args.measure:
        measure(int(float(args.span)), int(float(args.lo)), args.device)
        return 0

    from sieve_torch.backends.cuda import resolve_device

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    span = (int(float(args.span)) if args.span is not None
            else (10**9 if on_card else 3 * 10**6))
    lo = int(float(args.lo))
    if on_card:
        import torch

        where = torch.cuda.get_device_name(dev)
    else:
        where = "cpu: the plain version on the host clock, rankings are rough"
    print(f"autotune: span={span:.0e} lo={lo} ({where})")

    best = dict(DEFAULTS)
    base = run_trial(best, span, lo, str(dev))
    if base is None:
        print("baseline trial failed; nothing written", file=sys.stderr)
        return 1
    best_s = base["seconds"]
    oracle = base["result"]
    trials = [{**best, "ms": best_s * 1e3}]
    print(f"baseline {best}: {best_s * 1e3:.1f} ms  result={oracle}")

    for name, candidates in KNOBS.items():
        for val in candidates:
            if val == best[name]:
                continue
            trial = {**best, name: val}
            out = run_trial(trial, span, lo, str(dev))
            if out is None:
                continue
            if out["result"] != oracle:
                print(f"  {name}={val}: REJECTED (result {out['result']} "
                      f"!= {oracle})")
                trials.append({**trial, "ms": None})
                continue
            print(f"  {name}={val}: {out['seconds'] * 1e3:.1f} ms")
            trials.append({**trial, "ms": out["seconds"] * 1e3})
            if out["seconds"] < best_s:
                best_s = out["seconds"]
                best = trial
        print(f"--> {name} = {best[name]}")

    path = tuned_path()
    payload = {
        **{k: int(v) for k, v in best.items()},
        "_meta": {
            "span": span,
            "lo": lo,
            "platform": dev.type,
            "device": where if on_card else "cpu",
            "best_ms": round(best_s * 1e3, 4),
            "result": oracle,
            "trials": trials,
        },
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    print(f"wrote {path}: {json.dumps({k: best[k] for k in sorted(best)})}")
    if not on_card:
        print("note: host-clock timings of the plain version rank the knobs "
              "on the CPU, not on the card; re-run on the card before "
              "trusting these numbers")
    return 0


if __name__ == "__main__":
    sys.exit(main())
