"""Device time of the fused kernel, of the split kernel, and of the split
postlude alone, on one odds segment [lo, lo + span): k launches back to
back on one stream inside one pair of CUDA events, k in (1, 3), best of
3; the slope over k is the time of one launch.

Usage: python -m sieve_torch.tools.profile_kernel [span] [lo] [--device D]

    span  window size in values (default 1e9)
    lo    window start (default 2) — the 10^12-depth regime is:

              python -m sieve_torch.tools.profile_kernel 1e9 999000000000

          (the full 78,498-seed set, ND = 609 live group-D rows)

Prints the segment's tables (Wpad, the group widths, ND, ``spec_counts``),
its (count, pairs, first, last) from the fused kernel (twins, odds) and
the split kernel + postlude (they must agree: exit 1 if not), then the
times. The port of the reference's tools/profile_kernel.py: the reference
chains k calls with perturbed inputs so that XLA cannot merge them; CUDA
launches are never merged, so the port launches the same inputs k times.
With ``--device cpu`` the kernels' plain versions run and the times are
host-clock times of the CPU, labelled so.
"""

from __future__ import annotations

import argparse
import math
import sys

from sieve_torch.backends.cuda import resolve_device
from sieve_torch.tools import best_of, clock_name, slope

KS = (1, 3)
REPS = 3


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("span", nargs="?", default="1e9")
    p.add_argument("lo", nargs="?", default="2")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    span, lo = int(float(args.span)), int(float(args.lo))
    hi = lo + span
    dev = resolve_device(args.device)

    from sieve_torch.kernels.cuda_mark import (
        _split_words,
        fused_inputs,
        fused_reduce,
        launch_fused,
        prepare_cuda,
        spec_counts,
        split_reduce,
    )
    from sieve_torch.kernels.pairs import TWIN_ADJ
    from sieve_torch.kernels.reduce import _postlude
    from sieve_torch.seed import seed_primes

    seeds = seed_primes(math.isqrt(hi - 1))
    seg = prepare_cuda("odds", lo, hi, seeds)
    SB, SC = seg.B[0].shape[1], seg.C[0].shape[1]
    ND = seg.D[0].shape[0] if seg.D[3].any() else 0
    print(f"[{lo:.3e}, {hi:.3e}) Wpad={seg.Wpad} SB={SB} SC={SC} ND={ND} "
          f"tiers={spec_counts(seg)} seeds={seeds.size} device={dev}")
    x = fused_inputs(seg, dev)
    kind = TWIN_ADJ
    fused = tuple(int(v) for v in fused_reduce(x, kind).cpu().tolist())
    split = tuple(int(v) for v in split_reduce(x, kind).cpu().tolist())
    print(f"segment (count, pairs, first, last) = {fused}")
    if split != fused:
        print(f"FAIL: split kernel + postlude {split} != fused kernel {fused}")
        return 1
    clock = clock_name(dev)

    def chain(what: str, fn) -> float:
        times = {k: best_of(fn, k, REPS, dev) for k in KS}
        for k in KS:
            print(f"{what} k={k}: {times[k] * 1e3:10.4f} ms ({clock})")
        return slope(times)

    # on the card the bare launch (fused_reduce adds a cast of its result)
    kt = chain("fused kernel", (lambda: launch_fused(x, kind)) if dev.type == "cuda"
               else (lambda: fused_reduce(x, kind)))
    print(f"--> fused kernel time: {kt * 1e3:10.4f} ms "
          f"({2 * seg.nbits / kt:.3e} values/s, {clock})")
    st = chain("split kernel", lambda: _split_words(x))
    print(f"--> split kernel time: {st * 1e3:10.4f} ms ({clock})")

    words = _split_words(x)
    ci, cm = x.part("corr_idx").long(), x.part("corr_mask").long() & 0xFFFFFFFF
    fi, fm = x.part("flat_idx").long(), x.part("flat_mask").long() & 0xFFFFFFFF
    pt = chain("postlude", lambda: _postlude(words, x.nbits, x.pair_mask,
                                             ci, cm, kind, fi, fm))
    print(f"--> postlude time: {pt * 1e3:10.4f} ms ({clock})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
