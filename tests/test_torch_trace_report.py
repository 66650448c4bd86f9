"""The port's trace_report (sieve_torch/tools/trace_report.py) against the
reference's (tools/trace_report.py).

Every case renders one file — a ``--trace`` file, a flight-recorder
bundle, an exemplar file, or a broken one — through both packages'
``main`` in this process and requires byte-equal stdout and stderr and
the same exit code. The files come from the port's own runs on the CPU
(its CLI, its tracer, its query server, its cluster, its recorders) and
from the reference's, and a few are written by hand. Each case also keeps
the reference test's own checks of the rendered text. These are the
ported cases of the reference's trace_report tests: the
``report``/``phase_breakdown`` cases of test_observability.py and its
``test_trace_report_cli``; test_service.py's span rendering and
test_lanes.py's per-lane rows; test_failover.py's refresh line,
test_mesh_cold.py's cold-mesh row and test_router.py's router block;
test_fleet_obs.py's malformed-JSON exit and routed-report guards;
test_debug.py's bundle errors and single bundle; test_profile.py's
embedded profile; and the ``cluster_report`` halves of test_chaos.py and
test_multihost.py. The cluster cases hold nothing that depends on which
worker took which segment.
"""

import contextlib
import io
import json
import shutil
import threading
import time
from pathlib import Path

import pytest

import sieve.debug as ref_debug
import sieve.profile as ref_profile
import sieve.service.exemplar as ref_exemplar
import sieve.service.server as ref_server
import sieve.trace as ref_trace
import sieve_torch.tools.trace_report as port_tr
import tools.trace_report as ref_tr
from sieve.cli import main as ref_cli
from sieve.config import SieveConfig as RefConfig
from sieve.service import ServiceClient as RefClient
from sieve_torch import debug, profile, trace
from sieve_torch.cli import main as port_cli
from sieve_torch.cluster import run_cluster
from sieve_torch.config import SieveConfig
from sieve_torch.service import ServiceClient, ServiceSettings, SieveService
from sieve_torch.service import exemplar
from tests.test_torch_cluster import _free_addr, _kw, _port_worker, _reap
from tests.test_torch_service import cfg_kw, settings_kw, write_ledger

def render(argv):
    """Both packages' trace_report ``main`` on ``argv``: (exit code,
    stdout, stderr) must be equal; returns the port's."""
    got = []
    for mod in (ref_tr, port_tr):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mod.main([str(a) for a in argv])
        got.append((rc, out.getvalue(), err.getvalue()))
    assert got[1] == got[0]
    return got[1]


def _quiet(fn, argv):
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = fn(argv)
    assert rc == 0, err.getvalue()
    return buf.getvalue()


def _write(path: Path, events) -> Path:
    path.write_text(json.dumps({"traceEvents": events}))
    return path


# --- test_observability: the CLI's --trace file, report, phase_breakdown ------


@pytest.mark.parametrize("writer", ["port-cpu-numpy", "port-cuda-plain",
                                    "port-rounds", "ref-cpu-numpy"])
def test_cli_trace_file_renders_alike(writer, tmp_path):
    path = tmp_path / "run.trace.json"
    argv = ["--n", "1e5", "--segments", "4", "--twins", "--quiet", "--json",
            "--trace", str(path)]
    if writer == "ref-cpu-numpy":
        _quiet(ref_cli, argv + ["--backend", "cpu-numpy"])
    elif writer == "port-cpu-numpy":
        _quiet(port_cli, argv + ["--backend", "cpu-numpy"])
    elif writer == "port-cuda-plain":
        _quiet(port_cli, argv + ["--backend", "cuda", "--device", "cpu"])
    else:  # the rounds path: round.* spans, a device-idle window
        _quiet(port_cli, ["--n", "1e6", "--rounds", "4", "--twins", "--quiet",
                          "--json", "--device", "cpu", "--trace", str(path)])
    rc, text, err = render([path])
    assert rc == 0 and err == ""
    assert "per-phase breakdown" in text
    names = {e["name"] for e in port_tr.load_events(str(path))}
    if writer == "port-rounds":
        assert {"round.dispatch", "round.stack"} <= names
        assert "device-idle timeline" in text
    else:  # the backend's span: marking on the host, or the device call
        mark = "segment.device" if writer == "port-cuda-plain" else "segment.mark"
        assert {mark, "run.merge"} <= names
        assert mark in text
    for top in ("3", "1"):
        assert render([path, "--top", top])[0] == 0
    # the pure functions agree too
    spans = port_tr.load_events(str(path))
    assert port_tr.phase_breakdown(spans) == ref_tr.phase_breakdown(
        ref_tr.load_events(str(path)))
    assert port_tr.report(spans, top=4) == ref_tr.report(spans, top=4)
    assert port_tr.wall_span_us(spans) == ref_tr.wall_span_us(spans)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_rounds_host_phases_match_trace_spans(backend, tmp_path):
    """test_observability.py's acceptance on the port's rounds path: the
    span sums of the saved trace, by both packages' phase_breakdown,
    reproduce ``host_phases``."""
    from sieve_torch.parallel.mesh import run_mesh

    tr = trace.get_tracer()
    tr.enable()
    try:
        res = run_mesh(SieveConfig(n=10**6, backend=backend, device="cpu",
                                   workers=4, rounds=2, twins=True, quiet=True))
    finally:
        tr.disable()
    path = tmp_path / "mesh.trace.json"
    tr.save(str(path))
    agg = port_tr.phase_breakdown(port_tr.load_events(str(path)))
    assert agg == ref_tr.phase_breakdown(ref_tr.load_events(str(path)))
    hp = res.host_phases
    for key, span_name in {
        "prep_s": "prep.round",
        "prep_wait_s": "round.prep_wait",
        "stack_s": "round.stack",
        "dispatch_s": "round.dispatch",
        "drain_s": "round.drain",
        "device_idle_s": "round.device_idle",
    }.items():
        got = agg.get(span_name, {"total_us": 0.0})["total_us"] / 1e6
        assert got == pytest.approx(hp[key], rel=0.01, abs=1e-4), key
    assert render([path])[0] == 0


@pytest.mark.parametrize("tracer", [trace.Tracer, ref_trace.Tracer],
                         ids=["port", "ref"])
def test_trace_report_cli_top(tracer, tmp_path):
    tr = tracer()
    tr.enable()
    with tr.span("round.device_idle", round=0):
        time.sleep(0.002)
    with tr.span("round.dispatch", round=0):
        pass
    tr.disable()
    path = tmp_path / "t.json"
    tr.save(str(path))
    rc, out, _ = render([path, "--top", "3"])
    assert rc == 0
    assert "device-idle timeline" in out
    assert "round.dispatch" in out


# --- test_service / test_lanes: a served burst's spans ------------------------


@pytest.fixture(scope="module")
def ledger_dir(tmp_path_factory):
    return write_ledger(tmp_path_factory.mktemp("tr_ledger"))


@pytest.fixture(scope="module")
def served_traces(ledger_dir, tmp_path_factory):
    """The same queries (hot, cold, a bad request) on the reference's
    server and on the port's (cuda backend, the plain kernel on the CPU),
    each package's tracer on; each trace saved to a file."""
    root = tmp_path_factory.mktemp("tr_served")
    shutil.copytree(ledger_dir, root / "ref")
    shutil.copytree(ledger_dir, root / "port")
    ref = ref_server.SieveService(
        RefConfig(**cfg_kw(str(root / "ref"), backend="cpu-numpy")),
        ref_server.ServiceSettings(**settings_kw()))
    port = SieveService(
        SieveConfig(**cfg_kw(str(root / "port"), backend="cuda", device="cpu")),
        ServiceSettings(**settings_kw()))
    files = {}
    with ref, port:
        for name, svc, mod, client in (
                ("ref", ref, ref_trace, RefClient),
                ("port", port, trace, ServiceClient)):
            tr = mod.get_tracer()
            tr.enable()
            try:
                with client(svc.addr, timeout_s=30) as cli:
                    cli.pi(30_000)  # hot
                    cli.pi(svc.index.covered_hi + 70_000)  # cold
                    cli.query("pi", x="bad")
            finally:
                tr.disable()
            files[name] = root / f"{name}.trace.json"
            tr.save(str(files[name]))
    return files


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_service_spans_render_alike(served_traces, writer, tmp_path):
    path = served_traces[writer]
    rc, text, _ = render([path])
    assert rc == 0
    spans = port_tr.load_events(str(path))
    assert {"rpc.query", "query.queue_wait", "query.cold"} <= {
        e["name"] for e in spans}
    assert "query service" in text
    assert "queue-wait" in text and "cold compute" in text
    assert "index" in text
    assert port_tr.service_report(spans) == ref_tr.service_report(spans)
    # per-lane rows (test_lanes.py)
    assert "lane" in text and "wait p95 ms" in text
    rows = [ln.strip() for ln in text.splitlines()]
    assert any(r.startswith("hot") for r in rows)
    assert any(r.startswith("cold") for r in rows)
    # pre-lane traces (no lane arg) skip the block instead of crashing
    stripped = _write(tmp_path / "stripped.json",
                      [dict(e, args={}) for e in spans])
    rc, text, _ = render([stripped])
    assert rc == 0 and "wait p95 ms" not in text


# --- hand-written spans: refresh line, cold mesh row, router block ----------

HAND_SPANS = {
    # test_failover.py: the ledger follower's refreshes
    "refresh": ([
        {"name": "service.refresh", "ph": "X", "ts": 1000, "dur": 500,
         "args": {"outcome": "swapped", "covered_hi": 50_001,
                  "prev_covered_hi": 25_000}},
        {"name": "service.refresh", "ph": "X", "ts": 3000, "dur": 200,
         "args": {"outcome": "failed", "reason": "chaos"}},
        {"name": "rpc.query", "ph": "X", "ts": 5000, "dur": 400,
         "args": {"op": "pi", "outcome": "ok", "source": "index"}},
    ], ["ledger follow", "1 refresh(es) swapped", "covered_hi=50001"]),
    # test_mesh_cold.py: the cold mesh row nests in cold compute
    "cold_mesh": ([
        {"name": "rpc.query", "ph": "X", "ts": 0.0, "dur": 9_000.0,
         "args": {"op": "pi", "outcome": "ok", "source": "cold"}},
        {"name": "query.cold", "ph": "X", "ts": 100.0, "dur": 8_000.0,
         "args": {}},
        {"name": "query.cold_mesh", "ph": "X", "ts": 200.0, "dur": 6_000.0,
         "args": {"chunks": 5, "devices": 8, "launch": 1}},
    ], ["cold mesh", "1 SPMD launches, 5 chunks, 8 devices",
        "nested in cold compute"]),
    # test_router.py: the router block
    "router": ([
        {"name": "rpc.route", "ph": "X", "ts": 0.0, "dur": 900.0,
         "args": {"op": "pi", "outcome": "ok", "shards": 2}},
        {"name": "route.scatter", "ph": "X", "ts": 10.0, "dur": 400.0,
         "args": {"shard": 0, "op": "count", "outcome": "ok"}},
        {"name": "route.scatter", "ph": "X", "ts": 450.0, "dur": 420.0,
         "args": {"shard": 1, "op": "count", "outcome": "unavailable"}},
    ], ["shard router (rpc.route requests):", "unavailable=1"]),
}


@pytest.mark.parametrize("case", sorted(HAND_SPANS))
def test_hand_written_spans_render_alike(case, tmp_path):
    spans, wanted = HAND_SPANS[case]
    rc, text, _ = render([_write(tmp_path / "t.json", spans)])
    assert rc == 0
    for w in wanted:
        assert w in text
    for k in (len(spans), 2, 1):
        assert port_tr.service_report(spans[:k]) == ref_tr.service_report(spans[:k])
        assert port_tr.router_report(spans[:k]) == ref_tr.router_report(spans[:k])
    if case == "refresh":  # refresh-only traces still render the line
        assert "ledger follow" in "\n".join(port_tr.service_report(spans[:2]))
    if case == "router":  # pre-router traces skip the block entirely
        pre = [{"name": "rpc.query", "ph": "X", "ts": 0.0, "dur": 1.0, "args": {}}]
        assert port_tr.router_report(pre) == [] == ref_tr.router_report(pre)


# --- test_fleet_obs: named errors and the routed view -------------------------

BAD_TRACES = {
    "truncated": ('{"traceEvents": [{"name": "x"', "malformed or truncated"),
    "no_key": ('{"hello": 1}', "no 'traceEvents' key"),
    "not_objects": ('{"traceEvents": [1, 2]}', "must be a list of objects"),
    "binary": (b"\xff\xfe\x00junk", "not a text JSON file"),
    "missing": (None, "No such file"),
    "no_spans": ('[{"name": "m", "ph": "M"}]', "no span events in trace"),
}


@pytest.mark.parametrize("case", sorted(BAD_TRACES))
def test_bad_trace_exits_named(case, tmp_path):
    body, wanted = BAD_TRACES[case]
    path = tmp_path / "trace.json"
    if isinstance(body, bytes):
        path.write_bytes(body)
    elif body is not None:
        path.write_text(body)
    rc, out, err = render([path])
    assert rc == 1 and out == ""
    assert wanted in err
    if case != "no_spans":
        assert "trace_report: error:" in err


def test_routed_report_guards_and_correlation(tmp_path):
    assert "no rpc.route spans" in port_tr.routed_report([])
    assert port_tr.routed_report([]) == ref_tr.routed_report([])
    base = "r1/1.0"
    events = [
        {"name": "process_name", "ph": "M", "pid": 2_000_001,
         "args": {"name": "shard0 127.0.0.1:9"}},
        {"name": "rpc.route", "ph": "X", "ts": 1.0, "dur": 500.0,
         "pid": 1, "args": {"op": "pi", "outcome": "ok", "ctx": base}},
        {"name": "rpc.query", "ph": "X", "ts": 2.0, "dur": 100.0,
         "pid": 2_000_001,
         "args": {"op": "pi", "outcome": "ok", "ctx": f"{base}/s0.1.0"}},
        {"name": "clock.align", "ph": "i", "ts": 3.0, "pid": 2_000_001,
         "args": {"offset_s": 0.001, "rtt_s": 0.0004, "err_s": 0.0002}},
    ]
    rc, out, _ = render(["--routed", _write(tmp_path / "routed.json", events)])
    assert rc == 0
    assert "shard0" in out
    assert "1/1" in out or "100" in out  # the route is correlated


# --- test_debug / test_profile: flight-recorder bundles ----------------------


def test_bundle_named_errors(tmp_path):
    plain = tmp_path / "not_bundle.json"
    plain.write_text('{"hello": 1}')
    rc, _, err = render([plain, "--bundle"])
    assert rc == 1 and "no recognised 'bundle' version key" in err
    empty = tmp_path / "emptydir"
    empty.mkdir()
    rc, _, err = render([empty, "--bundle"])
    assert rc == 1 and "fleet_bundle.json" in err
    trunc = tmp_path / "trunc.json"
    trunc.write_text('{"bundle": "sieve-debug/1", ')
    rc, _, err = render([trunc, "--bundle"])
    assert rc == 1 and "malformed or truncated" in err


@pytest.mark.parametrize("mod", [debug, ref_debug], ids=["port", "ref"])
def test_single_bundle_renders_alike(mod, tmp_path):
    rec = mod.FlightRecorder("service", debug_dir=str(tmp_path / "dbg"),
                             cooldown_s=0.0)
    rec.emit({"event": "service_shed", "op": "pi"})
    rec.emit({"event": "service_error", "op": "pi", "error": "boom"})
    b = rec.trigger("breaker_open", reason="cold plane errors")
    rc, out, _ = render([b["path"], "--bundle"])  # a bundle DIR is accepted
    assert rc == 0
    assert "debug bundle" in out and "breaker_open" in out
    assert "service_shed" in out
    # the file itself, and a fleet bundle made of two of them
    bundle_file = Path(b["path"]) / "bundle.json"
    assert render([bundle_file, "--bundle"])[0] == 0
    doc = json.loads(bundle_file.read_text())
    fleet = {"bundle": "sieve-fleet-debug/1", "processes": 3,
             "router": {"addr": "127.0.0.1:1", "bundle": doc},
             "replicas": [{"shard": 0, "addr": "127.0.0.1:2", "bundle": doc},
                          {"shard": 1, "addr": "127.0.0.1:3", "error": "timeout"}]}
    fdir = tmp_path / "fleet"
    fdir.mkdir()
    (fdir / "fleet_bundle.json").write_text(json.dumps(fleet))
    rc, out, _ = render([fdir, "--bundle"])
    assert rc == 0 and "NO BUNDLE (timeout)" in out


def _spin(evt):
    """Busy-wait target: a deterministic non-idle leaf for sample_once."""
    while not evt.is_set():
        pass


@pytest.mark.parametrize("pkg", [(profile, debug), (ref_profile, ref_debug)],
                         ids=["port", "ref"])
def test_bundle_profile_top_n_renders_alike(pkg, tmp_path):
    prof_mod, debug_mod = pkg
    p = prof_mod.StackProfiler("service", hz=0)
    evt = threading.Event()
    t = threading.Thread(target=_spin, args=(evt,), name="svc-worker-hot-0",
                         daemon=True)
    t.start()
    try:
        deadline = time.time() + 5
        while time.time() < deadline and not any(
                r["stack"].endswith("test_torch_trace_report._spin")
                for r in p.snapshot()["stacks"]):
            p.sample_once()
    finally:
        evt.set()
        t.join(10)
    assert not t.is_alive()
    rec = debug_mod.FlightRecorder("service", debug_dir=str(tmp_path),
                                   cooldown_s=0.0, profiler=p)
    b = rec.trigger("breaker_open", reason="test")
    rc, out, _ = render([b["path"], "--bundle"])
    assert rc == 0
    assert "top self-time" in out
    assert "test_torch_trace_report._spin" in out


# --- exemplar files -----------------------------------------------------------


@pytest.mark.parametrize("mod", [exemplar, ref_exemplar], ids=["port", "ref"])
def test_exemplar_file_renders_alike(mod, tmp_path):
    s = mod.ExemplarSampler("router", ring=8, file_bytes=600,
                            debug_dir=str(tmp_path))
    for i in range(6):
        s.keep({"ts": float(i), "ctx": f"run/{i}.0", "op": "pi",
                "outcome": "ok" if i % 3 else "error", "ms": 1.5 + i,
                "reason": "baseline" if i % 3 else "error",
                "spans": [{"name": "rpc.route", "dur": 900.0 + i}],
                "downstream": [{"shard": 0, "addr": "127.0.0.1:9", "op": "pi",
                                "ms": 0.5, "reason": "slow", "spans": []}]})
    s.flush()
    s.close()
    rc, out, _ = render([tmp_path, "--exemplars", "--top", "4"])
    assert rc == 0
    kept = port_tr.load_exemplar_file(str(tmp_path))  # both generations
    assert 0 < len(kept) < 6  # the 600-byte file rotated
    assert out.startswith(f"exemplars: {len(kept)} kept")
    assert "shard 0" in out
    rc, _, err = render([tmp_path / "nothing", "--exemplars"])
    assert rc == 1 and "trace_report: error:" in err


# --- test_multihost / test_chaos: the cluster view ---------------------------

CLUSTER_HEADINGS = ("cluster timeline:", "per-worker utilization",
                    "rpc-wait vs compute", "straggler ranking",
                    "membership timeline", "max clock-alignment error")


def _cluster_checks(path):
    rc, text, _ = render(["--cluster", path])
    assert rc == 0
    for h in CLUSTER_HEADINGS:
        assert h in text
    events = port_tr.load_all(str(path))
    assert port_tr.cluster_report(events, top=3) == ref_tr.cluster_report(events, top=3)
    return text


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_cli_cluster_trace_renders_alike(writer, tmp_path):
    """test_multihost.py's CLI case: ``--trace`` on cpu-cluster writes the
    merged timeline (spawned workers), rendered with ``--cluster``."""
    path = tmp_path / "cluster.trace.json"
    out = _quiet(port_cli if writer == "port" else ref_cli, [
        "--n", "1e5", "--backend", "cpu-cluster", "--workers", "2",
        "--segments", "8", "--quiet", "--json", "--coordinator-addr",
        "127.0.0.1:0", "--trace", str(path)])
    assert json.loads(out)["pi"] == 9_592
    _cluster_checks(path)


@pytest.mark.parametrize("chaos", [None, "kill:any@s2,drop_hb:any@s4"],
                         ids=["external", "chaos"])
def test_run_cluster_merged_trace_renders_alike(chaos, tmp_path, monkeypatch):
    """test_multihost.py's external-worker case and test_chaos.py's
    composed faults on the port: two worker processes with their own
    clocks (the chaos case kills one of them mid-run), the coordinator's
    merged trace rendered with ``--cluster``."""
    monkeypatch.setenv("SIEVE_CLUSTER_NO_SPAWN", "1")
    monkeypatch.setenv("SIEVE_WORKER_BACKOFF_S", "0.05")
    addr = _free_addr()
    procs = [_port_worker(addr, i, SIEVE_CLUSTER_WORKER_BACKEND="cpu-numpy")
             for i in range(2)]
    tr = trace.get_tracer()
    tr.enable()
    try:
        res = run_cluster(SieveConfig(device="cpu", **_kw(
            coordinator_addr=addr, chaos=chaos)))
    finally:
        tr.disable()
        _reap(procs)
    assert res.pi == 9_592
    path = tmp_path / "cluster.trace.json"
    tr.save(str(path))
    text = _cluster_checks(path)
    if chaos:
        assert "left" in text
