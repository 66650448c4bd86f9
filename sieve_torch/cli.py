"""Command line of the PyTorch port: a counting run.

Examples:
    python -m sieve_torch --n 1e9 --backend cuda --packing odds --twins
    python -m sieve_torch --n 1e11 --rounds 64 --twins
    python -m sieve_torch --n 1e10 --rounds 8 --checkpoint-dir ck [--resume]
    python -m sieve_torch --n 1e9 --backend torch --rounds 4 --twins
    python -m sieve_torch --n 1e10 --twins --segments 5 --profile-dir prof
    SIEVE_CLUSTER_WORKER_BACKEND=cuda \
        python -m sieve_torch --n 1e10 --twins --backend cpu-cluster --workers 2
    python -m sieve_torch --n 1e10 --twins --workers 2 --rounds 8 --multihost \
        --dist-coordinator 127.0.0.1:29500 --dist-processes 2 --dist-process-id 0
    python -m sieve_torch --emit-primes 999999900:1000000000 [--json]
    python -m sieve_torch serve --n 1e10 --segments 16 --checkpoint-dir ck \
        --addr 127.0.0.1:0 [--cold-backend mesh] [--procs 2]
    python -m sieve_torch route --addr 127.0.0.1:0 \
        --shard 2:5000000000=HOST:PORT --shard 5000000000:10000000001=HOST:PORT
    python -m sieve_torch observe --router HOST:PORT --scrapes 3 \
        --observe-dir obs

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
SIEVE_PALLAS_FUSED=0 selects the split kernel and its postlude.
``--profile-dir DIR`` runs a cuda or torch run under torch.profiler and
writes its Chrome trace into DIR (the card's kernels included). The flags
and output lines are the reference CLI's; the reference's ``--jax-*``
spellings of the ``--dist-*`` flags are accepted too.

``serve`` runs the query server (sieve_torch/service/server.py) over a
checkpoint dir's ledger, or cold-only without one; it prints one JSON
``{"event": "serving", "addr": ...}`` line once it listens and drains on
SIGTERM or the ``shutdown`` op. Its flags are the reference's, except
that ``--backend`` defaults to ``cuda`` and ``--device`` places it: a
device backend on a card that is not there exits 2 at start, before the
server listens.

``route`` fronts range shards (each a replica set of ``serve`` processes,
every shard but the first started with ``--range-lo``) with one router
(sieve_torch/service/router.py), and ``observe`` scrapes a router and its
replicas into a snapshot ring (sieve_torch/service/observe.py). Both are
host code: they load no torch, and their flags and printed lines are the
reference's.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time

from sieve_torch import env
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
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run (host ops "
                        "and, on a card, its kernels) into this directory "
                        "as Chrome trace JSON (cuda and torch backends)")
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
        profile_dir=args.profile_dir,
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


def _profiler(config: SieveConfig):
    """``--profile-dir`` on the device backends: a torch.profiler session
    around the dispatch, host ops always and the card's kernels when the
    run's device is a CUDA device, written by tensorboard_trace_handler
    (one ``<host>_<pid>.<ms>.pt.trace.json`` per process, so ranks do not
    collide). Other backends ignore the flag, as the reference's do. A
    profiler that cannot trace the card raises instead of tracing the
    host alone."""
    if not config.profile_dir or config.backend not in ("cuda", "torch"):
        return contextlib.nullcontext()
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                supported_activities, tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.device(config.device).type == "cuda":
        from sieve_torch.backends.cuda import resolve_device

        resolve_device(config.device)  # no card: say so before profiling
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("--profile-dir: torch.profiler cannot trace "
                               "CUDA activity in this build (no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(config.profile_dir))


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
        with _profiler(config):
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


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sieve_torch serve",
        description="Persistent query server: pi / count / nth_prime / "
                    "primes over the RPC plane (sieve_torch/service/)",
    )
    p.add_argument("--addr", default="127.0.0.1:7723",
                   help="listen address host:port (port 0 picks a free one; "
                        "the chosen address is printed as a JSON line)")
    p.add_argument("--n", type=_parse_n, required=True,
                   help="the sieved range [2, N] the checkpoint dir covers "
                        "(must match the sieving run for its config hash)")
    p.add_argument("--packing", choices=PACKINGS, default="odds")
    p.add_argument("--segments", type=int, default=None, dest="n_segments")
    p.add_argument("--segment-size", type=int, default=None,
                   dest="segment_values")
    p.add_argument("--checkpoint-dir", default=None,
                   help="sieved checkpoint dir to index (omit for a "
                        "cold-only server)")
    p.add_argument("--backend", choices=[b for b in BACKENDS
                                         if b != "cpu-cluster"],
                   default="cuda",
                   help="cold-tier compute backend for uncovered ranges")
    p.add_argument("--device", default="cuda",
                   help="torch device of the cuda and torch backends: "
                        "cuda (the card) or cpu")
    p.add_argument("--cold-backend", choices=("loop", "mesh"), default=None,
                   dest="cold_backend",
                   help="cold-plane dispatch: 'mesh' runs each drain slice "
                        "as ONE word-kernel dispatch over every card (falls "
                        "back typed to the loop worker when the mesh can't "
                        "init or a launch fails); 'loop' is the "
                        "single-worker path (default "
                        "SIEVE_SVC_COLD_BACKEND/loop)")
    p.add_argument("--queue-limit", type=int, default=None,
                   help="admission queue bound (default SIEVE_SVC_QUEUE/64; "
                        "beyond it requests get a typed overloaded reply)")
    p.add_argument("--service-workers", type=int, default=None,
                   help="handler threads (default SIEVE_SVC_WORKERS/4)")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="default per-request deadline "
                        "(default SIEVE_SVC_DEADLINE_S/30)")
    p.add_argument("--refresh-s", type=float, default=None,
                   help="ledger live-follow poll period (default "
                        "SIEVE_SVC_REFRESH_S/2.0; 0 disables the follower)")
    p.add_argument("--drain-s", type=float, default=None,
                   help="graceful-drain budget after SIGTERM/shutdown "
                        "(default SIEVE_SVC_DRAIN_S/5.0)")
    p.add_argument("--persist-cold", action="store_true",
                   help="write cold chunk results back into the checkpoint "
                        "dir's ledger (this server becomes its designated "
                        "writer; covered_hi grows under read traffic). "
                        "Default OFF / SIEVE_SVC_PERSIST_COLD")
    p.add_argument("--range-lo", type=_parse_n, default=None, dest="range_lo",
                   help="serve as a range SHARD covering [RANGE_LO, N]: "
                        "count/primes below RANGE_LO are rejected typed, "
                        "counts anchor at RANGE_LO instead of 2, and pi "
                        "(a global-prefix op) is refused "
                        "(default SIEVE_SVC_RANGE_LO/2)")
    p.add_argument("--allow-chaos", action="store_true",
                   help="accept wire-injected chaos messages (default OFF: "
                        "a refused injection gets a typed bad_request and "
                        "a service_chaos_refused event)")
    p.add_argument("--chaos", default=None,
                   help="service fault schedule, e.g. 'svc_stall:any@s3:2.0,"
                        "svc_shed:any@s5,backend_down:any@s7:1.0' (segment "
                        "number = request sequence number)")
    p.add_argument("--trace", default=None, dest="trace_file", metavar="FILE",
                   help="write rpc.query / queue-wait / materialize / cold "
                        "spans as Chrome trace-event JSON on shutdown")
    p.add_argument("--debug-dir", default=None, dest="debug_dir",
                   help="flight-recorder bundle directory: edge triggers "
                        "(SLO burn, breaker open, crash) freeze a "
                        "timestamped postmortem bundle here (default "
                        "SIEVE_SVC_DEBUG_DIR; without a dir the recorder "
                        "still runs and serves the debug wire op inline)")
    p.add_argument("--prof-hz", type=float, default=None, dest="prof_hz",
                   help="continuous-profiler sampling rate (default "
                        "SIEVE_PROF_HZ/19; 0 disables the sampler — the "
                        "profile wire op then answers null)")
    p.add_argument("--metrics-file", default=None, dest="metrics_file")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-request stderr event lines")
    p.add_argument("--procs", type=int, default=None,
                   help="serving processes SO_REUSEPORT-bound to ONE port "
                        "(each runs its own event loop and worker pool over "
                        "the shared mmap'd segment store; process 0 is the "
                        "designated writer for persist-cold and store "
                        "compaction). Default SIEVE_SVC_PROCS/1")
    # set by the --procs supervisor when it re-execs itself as child i
    p.add_argument("--proc-index", type=int, default=None,
                   help=argparse.SUPPRESS)
    return p


def _probe_device(config: SieveConfig) -> None:
    """A device backend on the card needs the card now: without one the
    server would listen, answer hot queries, and degrade every cold one."""
    if config.backend in ("cuda", "torch") and config.device != "cpu":
        from sieve_torch.backends.cuda import resolve_device

        resolve_device(config.device)


def _serve(argv: list[str]) -> int:
    args = build_serve_parser().parse_args(argv)
    procs = args.procs if args.procs is not None \
        else env.env_int("SIEVE_SVC_PROCS", 1)
    config = SieveConfig(
        n=args.n,
        backend=args.backend,
        device=args.device,
        packing=args.packing,
        n_segments=args.n_segments,
        segment_values=args.segment_values,
        checkpoint_dir=args.checkpoint_dir,
        trace_file=args.trace_file,
        metrics_file=args.metrics_file,
        quiet=args.quiet,
        chaos=args.chaos,
    )
    _probe_device(config)
    if procs > 1 and args.proc_index is None:
        # supervisor: spawn N SO_REUSEPORT children on one port and
        # babysit them; this process never serves traffic itself
        return _serve_supervisor(argv, args, procs)

    from sieve_torch import metrics, trace
    from sieve_torch.service import ServiceSettings, SieveService

    overrides = {}
    if args.queue_limit is not None:
        overrides["queue_limit"] = args.queue_limit
    if args.service_workers is not None:
        overrides["workers"] = args.service_workers
    if args.deadline_s is not None:
        overrides["default_deadline_s"] = args.deadline_s
    if args.refresh_s is not None:
        overrides["refresh_s"] = args.refresh_s
    if args.drain_s is not None:
        overrides["drain_s"] = args.drain_s
    if args.allow_chaos:
        overrides["wire_chaos"] = True
    if args.range_lo is not None:
        overrides["range_lo"] = args.range_lo
    if args.persist_cold:
        if not args.checkpoint_dir:
            raise ValueError("--persist-cold needs --checkpoint-dir (the "
                             "ledger is the write-back target)")
        overrides["persist_cold"] = True
    if args.debug_dir is not None:
        overrides["debug_dir"] = args.debug_dir
    if args.prof_hz is not None:
        overrides["prof_hz"] = args.prof_hz
    if args.cold_backend is not None:
        overrides["cold_backend"] = args.cold_backend
    if procs > 1:
        # child of the --procs supervisor: everyone binds the SAME port
        # via SO_REUSEPORT; only process 0 writes, the rest follow
        overrides["procs"] = procs
        overrides["proc_index"] = args.proc_index or 0
        overrides["reuse_port"] = True
    settings = ServiceSettings.from_env(**overrides)

    file_sink = None
    if config.metrics_file:
        file_sink = metrics.FileSink(config.metrics_file)
        metrics.add_sink(file_sink)
    if config.trace_file:
        trace.enable()
    service = SieveService(config, settings, addr=args.addr)
    try:
        service.start()
        # one parseable line, so a wrapper finds the bound port when
        # --addr uses port 0
        print(json.dumps({
            "event": "serving",
            "addr": service.addr,
            "covered_hi": service.index.covered_hi,
            "total_primes": service.index.total_primes,
            "segments": len(service.index.segments),
            "proc": settings.proc_index,
            "procs": settings.procs,
        }), flush=True)
        import signal

        # SIGTERM = graceful drain: answer queued work, shed new queries
        # typed, exit 0 within --drain-s. SIGINT stays the fast path.
        signal.signal(signal.SIGTERM, lambda *_: service.drain())
        service.drain_event.wait()  # serve until SIGTERM/shutdown
        drained = service.wait_drained(settings.drain_s)
        # the stats subset per-process observers need when N procs share
        # one port (the kernel picks which process answers a connection)
        final = service.stats()
        print(json.dumps({
            "event": "drained",
            "clean": drained,
            "proc": settings.proc_index,
            "stats": {k: final[k]
                      for k in ("requests", "draining_replies",
                                "materialized", "cold_computes",
                                "cold_dispatches", "lru_hits",
                                "store_hits")},
            "store": final["store"] and {
                k: final["store"][k]
                for k in ("gen", "writer", "hits", "demotions", "torn")},
        }), flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        service.stop()
        if config.trace_file:
            trace.disable()
            trace.save(config.trace_file)
        if file_sink is not None:
            metrics.remove_sink(file_sink)
            file_sink.close()
    return 0


def _serve_supervisor(argv: list[str], args, procs: int) -> int:
    """``serve --procs N``: N serving processes, ONE port.

    Python threads share one GIL, so the supervisor spawns N full server
    processes that bind the same TCP port with SO_REUSEPORT; the kernel
    load-balances connections across them, and the mmap'd segment store
    shares their hot tiers through the page cache. On port 0 the
    supervisor first reserves a concrete port (bound, never listening)
    and pins every child to it; children are re-execs of this command
    line with --proc-index i. Their serving lines fold into one
    supervisor line; everything else is forwarded verbatim. SIGTERM and
    SIGINT fan out as SIGTERM (graceful drain); the exit code is 0 only
    if every child drained cleanly.
    """
    import signal
    import socket
    import subprocess

    from sieve_torch.rpc import parse_addr

    if not hasattr(socket, "SO_REUSEPORT"):
        print(json.dumps({"event": "error",
                          "detail": "--procs needs SO_REUSEPORT, which "
                                    "this platform lacks"}), flush=True)
        return 2
    host, port = parse_addr(args.addr)
    reserve = None
    if port == 0:
        reserve = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        reserve.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        reserve.bind((host, 0))
        port = reserve.getsockname()[1]
    addr = f"{host}:{port}"

    # child argv = this argv with addr pinned and proc identity added
    base: list[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--addr", "--procs", "--proc-index"):
            skip = True
            continue
        if a.startswith(("--addr=", "--procs=", "--proc-index=")):
            continue
        base.append(a)

    children: list[subprocess.Popen] = []
    forwarders: list[threading.Thread] = []
    serving: list[threading.Event] = []
    first_line: list[dict | None] = [None] * procs

    def _forward(i: int, proc: subprocess.Popen) -> None:
        assert proc.stdout is not None
        for line in proc.stdout:
            line = line.rstrip("\n")
            if first_line[i] is None:
                try:
                    doc = json.loads(line)
                except ValueError:
                    doc = None
                if doc is not None and doc.get("event") == "serving":
                    first_line[i] = doc
                    serving[i].set()
                    continue
            # one write per line: print() writes the text and its newline
            # apart, and the forwarders of several children interleave
            sys.stdout.write(line + "\n")
            sys.stdout.flush()

    try:
        for i in range(procs):
            cmd = [sys.executable, "-m", "sieve_torch", "serve", *base,
                   "--addr", addr, "--procs", str(procs),
                   "--proc-index", str(i)]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
            children.append(p)
            serving.append(threading.Event())
            forwarders.append(threading.Thread(
                target=_forward, args=(i, children[i]), daemon=True,
                name=f"serve-fwd-{i}"))
            forwarders[-1].start()
        for i, ev in enumerate(serving):
            while not ev.wait(0.2):
                if children[i].poll() is not None:
                    raise RuntimeError(f"proc {i} exited "
                                       f"rc={children[i].returncode} "
                                       "before serving")
        if reserve is not None:
            reserve.close()  # every child holds the port now
            reserve = None
        doc0 = first_line[0] or {}
        print(json.dumps({
            "event": "serving",
            "addr": addr,
            "covered_hi": doc0.get("covered_hi"),
            "total_primes": doc0.get("total_primes"),
            "segments": doc0.get("segments"),
            "procs": procs,
            "supervisor": True,
        }), flush=True)

        stop = threading.Event()

        def _fan_out(*_sig) -> None:
            stop.set()
            for p in children:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)

        signal.signal(signal.SIGTERM, _fan_out)
        signal.signal(signal.SIGINT, _fan_out)
        while not stop.is_set():
            if any(p.poll() is not None for p in children):
                _fan_out()  # one child died: drain the rest, report
                break
            stop.wait(0.2)
        rcs = [p.wait() for p in children]
        # every child's last lines (its own "drained") are still in its
        # pipe: forward them before this process's line, or they are lost
        # when it exits under its daemon forwarders
        for t in forwarders:
            t.join(10)
        print(json.dumps({"event": "drained", "supervisor": True,
                          "clean": all(rc == 0 for rc in rcs),
                          "rcs": rcs}), flush=True)
        return 0 if all(rc == 0 for rc in rcs) else 1
    finally:
        if reserve is not None:
            reserve.close()
        for p in children:
            if p.poll() is None:
                p.kill()


def build_route_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sieve_torch route",
        description="Range-shard router: one RPC front door over shard "
                    "replica sets (sieve_torch/service/router.py). Speaks the "
                    "same wire protocol as serve on both sides, so "
                    "existing clients need zero changes.",
    )
    p.add_argument("--addr", default="127.0.0.1:7733",
                   help="listen address host:port (port 0 picks a free one; "
                        "the chosen address is printed as a JSON line)")
    p.add_argument("--shard", action="append", default=None, metavar="LO:HI=ADDRS",
                   help="one shard covering [LO, HI) backed by comma-"
                        "separated replica addresses, e.g. "
                        "--shard 2:1e6=127.0.0.1:7723,127.0.0.1:7724 "
                        "(repeat per shard; shards must tile the range "
                        "contiguously). Alternative to --shard-map")
    p.add_argument("--shard-map", default=None, metavar="FILE",
                   help="JSON shard map file: {\"shards\": [{\"lo\", \"hi\", "
                        "\"addrs\"}, ...]}")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="default per-request deadline; the REMAINING budget "
                        "is forwarded to every downstream shard call "
                        "(default 30)")
    p.add_argument("--timeout-s", type=float, default=None,
                   help="downstream socket timeout (default 60)")
    p.add_argument("--probe-ttl-s", type=float, default=None,
                   help="shard health-probe cache TTL; 0 re-probes every "
                        "selection (default 2.0)")
    p.add_argument("--rounds", type=int, default=None,
                   help="failover sweeps across each shard's replicas "
                        "before giving up (default 2)")
    p.add_argument("--drain-s", type=float, default=None,
                   help="graceful-drain budget after SIGTERM/shutdown "
                        "(default 5.0)")
    p.add_argument("--allow-chaos", action="store_true",
                   help="accept wire-injected chaos messages (default OFF)")
    p.add_argument("--chaos", default=None,
                   help="router fault schedule, e.g. 'svc_shard_down:1@s3:"
                        "2.0' (segment number = router request sequence; "
                        "worker = shard index, any = every shard)")
    p.add_argument("--trace", default=None, dest="trace_file", metavar="FILE",
                   help="write rpc.route / route.scatter spans as Chrome "
                        "trace-event JSON on shutdown")
    p.add_argument("--debug-dir", default=None, dest="debug_dir",
                   help="flight-recorder bundle directory: a shard going "
                        "dark (router_shard_down) or a crash freezes a "
                        "timestamped postmortem bundle here")
    p.add_argument("--prof-hz", type=float, default=None, dest="prof_hz",
                   help="continuous-profiler sampling rate (default "
                        "SIEVE_PROF_HZ/19; 0 disables the sampler)")
    p.add_argument("--metrics-file", default=None, dest="metrics_file")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-request stderr event lines")
    return p


def _route(argv: list[str]) -> int:
    args = build_route_parser().parse_args(argv)

    from sieve_torch import metrics, trace
    from sieve_torch.service import RouterSettings, ShardMap, SieveRouter

    if bool(args.shard) == bool(args.shard_map):
        raise ValueError("route needs exactly one of --shard (repeatable) "
                         "or --shard-map FILE")
    if args.shard_map:
        shardmap = ShardMap.from_json(args.shard_map)
    else:
        shardmap = ShardMap.from_flags(args.shard)

    overrides = {}
    if args.deadline_s is not None:
        overrides["default_deadline_s"] = args.deadline_s
    if args.timeout_s is not None:
        overrides["timeout_s"] = args.timeout_s
    if args.probe_ttl_s is not None:
        overrides["probe_ttl_s"] = args.probe_ttl_s
    if args.rounds is not None:
        overrides["rounds"] = args.rounds
    if args.drain_s is not None:
        overrides["drain_s"] = args.drain_s
    if args.allow_chaos:
        overrides["wire_chaos"] = True
    if args.quiet:
        overrides["quiet"] = True
    if args.debug_dir is not None:
        overrides["debug_dir"] = args.debug_dir
    if args.prof_hz is not None:
        overrides["prof_hz"] = args.prof_hz
    settings = RouterSettings.from_env(**overrides)

    file_sink = None
    if args.metrics_file:
        file_sink = metrics.FileSink(args.metrics_file)
        metrics.add_sink(file_sink)
    if args.trace_file:
        trace.enable()
    router = SieveRouter(shardmap, settings, addr=args.addr,
                         chaos_spec=args.chaos or "")
    try:
        router.start()
        # one parseable line so wrappers can find the bound port when
        # --addr uses port 0
        print(json.dumps({
            "event": "routing",
            "addr": router.addr,
            "range": [shardmap.lo, shardmap.hi],
            "shards": [s.to_dict() for s in shardmap],
        }), flush=True)
        import signal

        signal.signal(signal.SIGTERM, lambda *_: router.drain())
        router.drain_event.wait()  # route until SIGTERM/shutdown
        drained = router.wait_drained(settings.drain_s)
        print(json.dumps({
            "event": "drained",
            "clean": drained,
            "stats": {k: router.stats()[k]
                      for k in ("requests", "draining_replies")},
        }), flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        router.stop()
        if args.trace_file:
            trace.disable()
            trace.save(args.trace_file)
        if file_sink is not None:
            metrics.remove_sink(file_sink)
            file_sink.close()
    return 0


def build_observe_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sieve_torch observe",
        description="Capacity observatory daemon: scrape a router and "
                    "every advertised shard replica on a cadence, persist "
                    "a CRC'd ring of downsampled fleet snapshots, and run "
                    "the EWMA anomaly engine (fleet_anomaly / "
                    "scaling_advice events; sieve_torch/service/observe.py)",
    )
    p.add_argument("--router", required=True, metavar="ADDR",
                   help="router host:port to scrape (shard replicas are "
                        "discovered from its health reply)")
    p.add_argument("--observe-dir", default=None,
                   help="directory for the snapshot ring (fleet_ring.bin) "
                        "and anomaly-triggered fleet debug bundles; "
                        "omitted = in-memory trends only")
    p.add_argument("--scrape-s", type=float, default=None,
                   help="seconds between scrape cycles (default 1.0)")
    p.add_argument("--timeout-s", type=float, default=None,
                   help="per-endpoint RPC timeout (default 5.0)")
    p.add_argument("--scrapes", type=int, default=0, metavar="N",
                   help="stop after N scrape cycles (0 = run until "
                        "SIGTERM; N > 0 runs the cycles inline and exits "
                        "— the smoke-test mode)")
    p.add_argument("--chaos", default=None,
                   help="observer fault schedule, e.g. "
                        "'svc_scrape_gap:any@s3' (segment number = the "
                        "observer's scrape counter; worker = target index "
                        "in discovery order, any = every target)")
    p.add_argument("--metrics-file", default=None, dest="metrics_file")
    p.add_argument("--quiet", action="store_true",
                   help="suppress per-scrape stderr event lines")
    return p


def _observe(argv: list[str]) -> int:
    args = build_observe_parser().parse_args(argv)

    from sieve_torch import metrics
    from sieve_torch.chaos import ChaosSchedule, parse_chaos
    from sieve_torch.service.observe import FleetObserver, ObserverSettings

    overrides: dict = {}
    if args.scrape_s is not None:
        overrides["scrape_s"] = args.scrape_s
    if args.timeout_s is not None:
        overrides["timeout_s"] = args.timeout_s
    if args.observe_dir is not None:
        overrides["observe_dir"] = args.observe_dir
    if args.quiet:
        overrides["quiet"] = True
    settings = ObserverSettings.from_env(**overrides)
    chaos = ChaosSchedule(parse_chaos(args.chaos or ""))

    file_sink = None
    if args.metrics_file:
        file_sink = metrics.FileSink(args.metrics_file)
        metrics.add_sink(file_sink)
    obs = FleetObserver(args.router, settings, chaos=chaos)
    try:
        print(json.dumps({
            "event": "observing",
            "router": args.router,
            "observe_dir": settings.observe_dir,
            "scrape_s": settings.scrape_s,
        }), flush=True)
        if args.scrapes > 0:
            # bounded inline mode: deterministic for smoke tests and cron
            for _ in range(args.scrapes):
                obs.scrape_once()
                if _ < args.scrapes - 1:
                    time.sleep(settings.scrape_s)
        else:
            import signal

            stop = threading.Event()
            signal.signal(signal.SIGTERM, lambda *_: stop.set())
            signal.signal(signal.SIGINT, lambda *_: stop.set())
            obs.start()
            stop.wait()
        print(json.dumps({"event": "observed", **obs.stats()}),
              flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        obs.stop()
        if file_sink is not None:
            metrics.remove_sink(file_sink)
            file_sink.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    for name, sub in (("serve", _serve), ("route", _route),
                      ("observe", _observe)):
        if argv and argv[0] == name:
            try:
                return sub(argv[1:])
            except (ValueError, RuntimeError, ImportError) as e:
                print(f"sieve_torch: error: {e}", file=sys.stderr)
                return 2
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
