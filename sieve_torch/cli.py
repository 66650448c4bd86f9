"""Command line of the PyTorch port: a counting run.

Examples:
    python -m sieve_torch --n 1e9 --backend cuda --packing odds --twins
    python -m sieve_torch --n 1e11 --rounds 64 --twins
    python -m sieve_torch --n 1e10 --rounds 8 --checkpoint-dir ck [--resume]
    python -m sieve_torch --n 1e9 --backend torch --rounds 4 --twins
    SIEVE_CLUSTER_WORKER_BACKEND=cuda \
        python -m sieve_torch --n 1e10 --twins --backend cpu-cluster --workers 2
    python -m sieve_torch --n 1e10 --twins --workers 2 --rounds 8 --multihost \
        --dist-coordinator 127.0.0.1:29500 --dist-processes 2 --dist-process-id 0
    python -m sieve_torch --emit-primes 999999900:1000000000 [--json]

``--workers`` > 1 or ``--rounds`` > 1 on the cuda or torch backend runs
the rounds path (sieve_torch/parallel/mesh.py), one shard per card;
anything else is the local run. ``--backend cpu-cluster`` coordinates
worker processes over TCP (sieve_torch/cluster.py); ``--role worker`` is
such a worker. ``--multihost`` makes this process one rank of the rounds
path across processes (sieve_torch/parallel/dist.py); ``--workers`` is
then the global shard count and only rank 0 prints. Runs on the card
unless ``--device cpu`` is given, which runs the cuda kernels' plain
PyTorch versions, or the torch backend's ops, on the CPU.
``--emit-primes LO:HI`` prints the primes of a window instead (``--n`` is
then not needed); like the reference it marks on the host with numpy.
SIEVE_PALLAS_FUSED=0 selects the split kernel and its postlude. The flags
and output lines are the reference CLI's; the reference's ``--jax-*``
spellings of the ``--dist-*`` flags are accepted too.
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
    p.add_argument("--n", type=_parse_n, default=None,
                   help="sieve [2, N] inclusive (1e9 ok)")
    p.add_argument("--emit-primes", default=None, metavar="LO:HI",
                   help="print the primes in [LO, HI] inclusive (one per "
                        "line; --json for a JSON array) instead of counting")
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
                   help="shards per round of the rounds path, one per card; "
                        "worker processes of cpu-cluster")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of the rounds path across processes on "
                        "torch.distributed; --workers is the GLOBAL shard "
                        "count (world size x local shards)")
    p.add_argument("--dist-coordinator", "--jax-coordinator", default=None,
                   help="host:port of rank 0's store for --multihost")
    p.add_argument("--dist-processes", "--jax-processes", type=int, default=None,
                   help="world size for --multihost")
    p.add_argument("--dist-process-id", "--jax-process-id", type=int, default=None,
                   help="this process's rank for --multihost")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--rounds", type=int, default=1,
                   help="dispatch rounds (failure-recovery granularity)")
    p.add_argument("--trace", default=None, dest="trace_file", metavar="FILE",
                   help="write host-side spans as Chrome trace-event JSON "
                        "(Perfetto, chrome://tracing); on cpu-cluster the "
                        "merged timeline, one track per worker")
    p.add_argument("--metrics-file", default=None, dest="metrics_file",
                   metavar="FILE",
                   help="append every metrics event as JSONL (per-segment "
                        "ones included, whatever --quiet says)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-segment stderr lines (the run summary "
                        "and robustness events still print)")
    p.add_argument("--json", action="store_true", dest="json_output")
    p.add_argument("--chaos", default=None,
                   help="fault-injection schedule, e.g. 'kill:1@s4,stall:2@s7:3.0,"
                        "drop_hb:any@s9,disconnect:0@s2' (see sieve_torch/chaos.py)")
    p.add_argument("--chaos-kill-worker", default=None, dest="chaos_kill",
                   help="'k@s' kills worker k at segment s ('any@s': whichever "
                        "worker draws it); shorthand for --chaos 'kill:k@s<s>'")
    p.add_argument("--role", choices=("auto", "coordinator", "worker"),
                   default="auto",
                   help="cpu-cluster role (a worker connects to --coordinator-addr)")
    p.add_argument("--coordinator-addr", default="127.0.0.1:7621")
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
        multihost=args.multihost,
        trace_file=args.trace_file,
        metrics_file=args.metrics_file,
        chaos=args.chaos,
        chaos_kill=args.chaos_kill,
        coordinator_addr=args.coordinator_addr,
    )


def _join_group(args: argparse.Namespace, config: SieveConfig) -> None:
    """``--multihost``: join the process group at the address, world size
    and rank the flags give, before any device work."""
    if config.backend not in ("cuda", "torch"):
        raise ValueError("--multihost runs the rounds path: --backend cuda or torch")
    if None in (args.dist_coordinator, args.dist_processes, args.dist_process_id):
        raise ValueError("--multihost needs --dist-coordinator, --dist-processes "
                         "and --dist-process-id")
    from sieve_torch.parallel.dist import init_group, local_shards
    from sieve_torch.parallel.mesh import shard_devices

    nlocal = local_shards(config.workers, args.dist_processes)
    init_group(args.dist_coordinator, args.dist_processes, args.dist_process_id,
               shard_devices(config.device, nlocal))


def _run(args: argparse.Namespace, config: SieveConfig) -> int:
    from sieve_torch import metrics, trace

    file_sink = None
    if config.metrics_file:
        file_sink = metrics.FileSink(config.metrics_file)
        metrics.add_sink(file_sink)
    if config.trace_file:
        trace.enable()
    try:
        if config.multihost:
            _join_group(args, config)
        return _dispatch(args, config)
    finally:
        if config.multihost:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
        if config.trace_file:
            trace.disable()
            trace.save(config.trace_file)
        if file_sink is not None:
            metrics.remove_sink(file_sink)
            file_sink.close()


def _dispatch(args: argparse.Namespace, config: SieveConfig) -> int:
    if args.role == "worker":
        from sieve_torch.cluster import serve_worker

        serve_worker(config)
        return 0
    if config.backend == "cpu-cluster":
        from sieve_torch.cluster import run_cluster

        result = run_cluster(config)
        dropped = (result.host_phases or {}).get("telemetry_dropped_events")
        if dropped:
            print(f"sieve_torch: warning: worker telemetry truncated ({dropped} "
                  "trace events dropped by the ship ring); the merged --trace "
                  "timeline is incomplete — raise SIEVE_TELEMETRY_RING to keep "
                  "more events per worker", file=sys.stderr)
    elif config.backend in ("cuda", "torch") and (
            config.workers > 1 or config.rounds > 1 or config.multihost):
        from sieve_torch.parallel.mesh import run_mesh

        result = run_mesh(config)
    else:
        from sieve_torch.coordinator import run_local

        result = run_local(config)
    if config.multihost:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            return 0  # every rank holds the same result; rank 0 prints it
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


def _emit_primes(args: argparse.Namespace) -> int:
    from sieve_torch.enumerate import primes_in_range

    try:
        lo_s, hi_s = args.emit_primes.split(":")
        lo, hi = _parse_n(lo_s), _parse_n(hi_s)
    except (ValueError, argparse.ArgumentTypeError):
        raise ValueError(f"--emit-primes expects LO:HI, got {args.emit_primes!r}")
    chunks = primes_in_range(args.packing, lo, hi + 1)
    if args.json_output:
        # stream the array chunk by chunk: the max span's output is GBs
        sys.stdout.write("[")
        first = True
        for c in chunks:
            if c.size:
                if not first:
                    sys.stdout.write(", ")
                sys.stdout.write(", ".join(map(str, c.tolist())))
                first = False
        sys.stdout.write("]\n")
    else:
        for c in chunks:
            sys.stdout.write("\n".join(map(str, c.tolist())))
            if c.size:
                sys.stdout.write("\n")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.emit_primes is not None:
            return _emit_primes(args)
        if args.n is None:
            print("sieve_torch: error: --n is required (or use --emit-primes)",
                  file=sys.stderr)
            return 2
        return _run(args, config_from_args(args))
    except (ValueError, RuntimeError) as e:
        # NotImplementedError is a RuntimeError: unported parts say which slice
        print(f"sieve_torch: error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
