"""Command line of the PyTorch port: a counting run.

Examples:
    python -m sieve_torch --n 1e9 --backend cuda --packing odds --twins
    python -m sieve_torch --n 1e11 --rounds 64 --twins
    python -m sieve_torch --n 1e10 --rounds 8 --checkpoint-dir ck [--resume]
    python -m sieve_torch --n 1e9 --backend torch --rounds 4 --twins

``--workers`` > 1 or ``--rounds`` > 1 on the cuda or torch backend runs
the rounds path (sieve_torch/parallel/mesh.py), one shard per card;
anything else is the local run. Runs on the card unless ``--device cpu``
is given, which runs the cuda kernels' plain PyTorch versions, or the
torch backend's ops, on the CPU. SIEVE_PALLAS_FUSED=0 selects the split
kernel and its postlude. The output lines are the reference CLI's.
"""

from __future__ import annotations

import argparse
import json
import sys

from sieve_torch.config import BACKENDS, COUNT_KINDS, PACKINGS, SieveConfig


def _parse_n(text: str) -> int:
    """Accept 1000000, 1e9, 10**12 style values."""
    try:
        return int(text)
    except ValueError:
        pass
    if "**" in text:
        base, exp = text.split("**")
        return int(base) ** int(exp)
    val = float(text)
    n = int(val)
    if n != val:
        raise argparse.ArgumentTypeError(f"--n must be an integer, got {text}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sieve_torch",
        description="Segmented Sieve of Eratosthenes on an NVIDIA GPU "
                    "(PyTorch port)",
    )
    p.add_argument("--n", type=_parse_n, required=True,
                   help="sieve [2, N] inclusive (1e9 ok)")
    p.add_argument("--backend", choices=BACKENDS, default="cuda")
    p.add_argument("--device", default="cuda",
                   help="torch device of the cuda and torch backends: "
                        "cuda (the card) or cpu")
    p.add_argument("--segments", type=int, default=None, dest="n_segments")
    p.add_argument("--segment-values", "--segment-size", type=int, default=None,
                   dest="segment_values",
                   help="values per segment (alternative to --segments)")
    p.add_argument("--packing", choices=PACKINGS, default="odds")
    p.add_argument("--twins", action="store_true", help="also count twin-prime pairs")
    p.add_argument("--count-kind", choices=COUNT_KINDS, default=None,
                   dest="count_kind",
                   help="pair reduction: primes (count only), twins (p, p+2), "
                        "cousins (p, p+4); --twins is shorthand for twins")
    p.add_argument("--workers", type=int, default=1,
                   help="shards per round of the rounds path, one per card")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--rounds", type=int, default=1,
                   help="dispatch rounds (failure-recovery granularity)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--json", action="store_true", dest="json_output")
    return p


def config_from_args(args: argparse.Namespace) -> SieveConfig:
    count_kind = args.count_kind
    if count_kind is None:
        count_kind = "twins" if args.twins else "primes"
    elif args.twins and count_kind == "cousins":
        raise ValueError("--twins conflicts with --count-kind cousins")
    return SieveConfig(
        n=args.n,
        backend=args.backend,
        packing=args.packing,
        n_segments=args.n_segments,
        segment_values=args.segment_values,
        twins=args.twins,
        count_kind=count_kind,
        workers=args.workers,
        checkpoint_dir=args.checkpoint_dir,
        resume=args.resume,
        rounds=args.rounds,
        quiet=args.quiet,
        json_output=args.json_output,
        device=args.device,
    )


def _dispatch(config: SieveConfig) -> int:
    if config.backend in ("cuda", "torch") and (
            config.workers > 1 or config.rounds > 1):
        from sieve_torch.parallel.mesh import run_mesh

        result = run_mesh(config)
    else:
        from sieve_torch.coordinator import run_local

        result = run_local(config)
    if config.json_output:
        out = result.to_dict()
        out.pop("segments", None)
        print(json.dumps(out))
    else:
        print(f"pi({result.n}) = {result.pi}")
        if result.twin_pairs is not None:
            gap = config.pair_gap or 2
            name = "cousin" if config.count_kind == "cousins" else "twin"
            print(f"{name} pairs (p, p+{gap} <= {result.n}) = "
                  f"{result.twin_pairs}")
        print(
            f"backend={result.backend} packing={result.packing} "
            f"segments={result.n_segments} elapsed={result.elapsed_s:.3f}s "
            f"({result.values_per_sec:.3e} values/s)"
        )
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _dispatch(config_from_args(args))
    except (ValueError, RuntimeError) as e:
        # NotImplementedError is a RuntimeError: unported parts say which slice
        print(f"sieve_torch: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
