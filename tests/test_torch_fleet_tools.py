"""The port's fleet tools (``sieve_torch/tools/fleet_{top,debug,profile}.py``)
against the reference's ``tools/fleet_*.py``.

The ports of the reference's tests of these tools (test_fleet_obs.py,
test_debug.py, test_mesh_cold.py) run the port's tools over the port's
fabric: in-process shard servers and router, and for the postmortem
drill ``python -m sieve_torch serve`` and ``route`` processes. Then parity:
both tools are handed the same replies, recorded once from a live port
fabric and served by a stand-in client to both, and must render the same
text, print the same JSON, write the same files and exit with the same
code; the flame diff of two captures prints the same table. Last, a
fresh interpreter runs each port tool and loads none of ``torch``,
``jax``, ``sieve`` or the repository's ``tools``.
"""

import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import tools.fleet_debug as ref_fleet_debug
import tools.fleet_profile as ref_fleet_profile
import tools.fleet_top as ref_fleet_top
from sieve.coordinator import run_local as ref_run_local
from sieve_torch.debug import FLEET_BUNDLE_VERSION
from sieve_torch.service import ServiceClient
from sieve_torch.service.client import CallTimeout
from sieve_torch.tools import fleet_debug, fleet_profile, fleet_top
from sieve_torch.tools.trace_report import main as trace_report_main
from tests.test_torch_router import (
    N,
    REF,
    Fabric,
    fresh_copy,
    o_count,
    o_pi,
    split_ledger,
)

REPO = Path(__file__).resolve().parent.parent
PROC_WAIT_S = 60


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet_tools_src")
    ref_run_local(REF.cfg(str(root / "src")))
    return split_ledger(root / "src", root)


def _wait(cond, timeout_s=10.0, what="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# --- the reference's tests, on the port's tools ------------------------------


def test_fleet_top_snapshot_schema_and_render(split, tmp_path):
    with Fabric(split, tmp_path) as f:
        assert f.cli.is_prime(101)
        assert f.cli.pi(N - 5) == o_pi(N - 5)
        snap = fleet_top.fleet_snapshot(f.router.addr, timeout_s=10)
        assert sorted(snap) == ["router", "shards", "ts"]
        assert snap["router"]["error"] is None
        assert len(snap["shards"]) == 2
        for sh in snap["shards"]:
            assert len(sh["replicas"]) == 1
            rep = sh["replicas"][0]
            assert rep["health"]["status"] in ("ok", "degraded")
            assert "slo" in rep["stats"]
            assert rep["metrics"]["service.requests"]["value"] >= 0
        frame1 = fleet_top.render(snap)
        assert "router" in frame1 and "contiguous" in frame1
        assert frame1.count("s0 ") + frame1.count("s1 ") >= 2
        time.sleep(0.05)
        assert f.cli.is_prime(103)
        snap2 = fleet_top.fleet_snapshot(f.router.addr, timeout_s=10)
        frame2 = fleet_top.render(snap2, prev=snap)
        assert "/s" in frame2  # second frame shows rates, not totals
        # no SLOs configured: burn renders "-", never a fake 0 (the
        # hot-frame column rides to the right of it)
        hdr = [ln for ln in frame2.splitlines() if "slo burn" in ln][0]
        assert "hot frame" in hdr
        col = hdr.index("slo burn")
        rows = [ln for ln in frame2.splitlines()
                if ln.lstrip().startswith(("s0 ", "s1 "))]
        assert rows and all(
            ln[col:col + len("slo burn")].strip() == "-" for ln in rows)


def test_fleet_top_unreachable_router_renders_error():
    snap = fleet_top.fleet_snapshot("127.0.0.1:1", timeout_s=0.2)
    assert snap["router"]["health"] is None
    assert "UNREACHABLE" in fleet_top.render(snap)


def _fake_snap(replica_health, shard_status="ok", router_health={"ok": 1}):
    rep = {"addr": "127.0.0.1:2", "health": replica_health,
           "stats": {}, "metrics": {}, "error": None}
    return {
        "ts": 1.0,
        "router": {"addr": "127.0.0.1:1", "health": router_health,
                   "stats": {}, "metrics": {}, "error": None},
        "shards": [{"shard": 0, "lo": 2, "hi": 100,
                    "status": shard_status, "replicas": [rep]}],
    }


def test_fleet_top_json_exit_codes(monkeypatch, capsys):
    snap = _fake_snap({"status": "ok"})
    monkeypatch.setattr(fleet_top, "fleet_snapshot", lambda a, timeout_s: snap)
    assert fleet_top.main(["127.0.0.1:1", "--json"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out)["shards"][0]["status"] == "ok"  # machine-readable
    # a DOWN replica row flips the exit code
    snap = _fake_snap(None)
    assert fleet_top.main(["127.0.0.1:1", "--json"]) == 1
    # so does a router-side down shard, and an unreachable router
    snap = _fake_snap({"status": "ok"}, shard_status="down")
    assert fleet_top.main(["127.0.0.1:1", "--json"]) == 1
    snap = _fake_snap({"status": "ok"}, router_health=None)
    assert fleet_top.main(["127.0.0.1:1", "--json"]) == 1


def test_fleet_top_cold_cell():
    _cold_cell = fleet_top._cold_cell
    assert _cold_cell(None) == "-"
    assert _cold_cell({}) == "-"
    assert _cold_cell({"cold_backend": "loop"}) == "loop"
    assert _cold_cell(
        {"cold_backend": "mesh", "mesh_devices": 8, "mesh_fanout": 3}
    ) == "mesh/8x3"
    assert _cold_cell(
        {"cold_backend": "loop (mesh failed)"}
    ) == "loop (mesh failed)"


def _spawn(argv, env):
    """``python -m sieve_torch <argv>``; its first stdout line, parsed."""
    p = subprocess.Popen([sys.executable, "-m", "sieve_torch", *argv],
                         env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    return p, json.loads(p.stdout.readline())


def test_fleet_debug_e2e_burn_crash_merge_and_render(split, tmp_path, capsys):
    d0, d1, E = split
    dbg = [tmp_path / "dbg0", tmp_path / "dbg1", tmp_path / "dbgr"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(SIEVE_SVC_SLO_MS_PI="0.0001", SIEVE_SVC_SLO_MS_COUNT="0.0001",
               SIEVE_METRICS_SAMPLE_S="0.05", OMP_NUM_THREADS="1")
    procs, addrs = [], []
    try:
        for i, (d, extra) in enumerate((
            (d0, ["--chaos", "svc_crash:any@s1"]),
            (d1, ["--range-lo", str(E)]),
        )):
            p, head = _spawn(
                ["serve", "--addr", "127.0.0.1:0", "--n", str(N), "--segments", "4",
                 "--packing", "wheel30", "--checkpoint-dir", fresh_copy(d, tmp_path),
                 "--refresh-s", "0", "--quiet", "--allow-chaos", "--device", "cpu",
                 "--debug-dir", str(dbg[i]), *extra], env)
            procs.append(p)
            assert head["event"] == "serving"
            addrs.append(head["addr"])

        # shard 0's first query trips svc_crash: the worker dies, the
        # request gets no reply, and the crash bundle freezes
        with ServiceClient(addrs[0], timeout_s=3) as direct:
            with pytest.raises((CallTimeout, ConnectionError)):
                direct.pi(1000)

        rp, rhead = _spawn(
            ["route", "--addr", "127.0.0.1:0",
             "--shard", f"2:{E}={addrs[0]}", "--shard", f"{E}:{N + 1}={addrs[1]}",
             "--quiet", "--allow-chaos", "--debug-dir", str(dbg[2])], env)
        procs.append(rp)
        assert rhead["event"] == "routing"
        raddr = rhead["addr"]

        with ServiceClient(raddr, timeout_s=30) as cli:
            q = 0
            # exact answers on both shards; every completed op burns the
            # absurd 0.1us SLO, freezing slo_burn bundles per replica
            for i in range(6):
                x = (97 * (i + 1)) % N
                assert cli.is_prime(x) == bool(o_count(x, x + 1))
                q += 1
            assert cli.pi(N - 1) == o_pi(N - 1)  # 2-shard scatter
            q += 1
            # shard 0 dark for 0.2s at request q+1, which targets shard
            # 1: exact result, shard_down bundle on the router
            cli.inject_chaos(f"svc_shard_down:0@s{q + 1}:0.2")
            lo = E + 10
            assert cli.count(lo, lo + 100) == o_count(lo, lo + 100)
            q += 1
            time.sleep(0.25)
            assert cli.pi(1000) == o_pi(1000)  # shard 0 back, still exact

        _wait(lambda: list(dbg[0].glob("bundle-crash-*")),
              what="replica crash bundle")
        _wait(lambda: list(dbg[0].glob("bundle-slo_burn-*"))
              and list(dbg[1].glob("bundle-slo_burn-*")),
              what="slo_burn bundles on both replicas")
        _wait(lambda: list(dbg[2].glob("bundle-shard_down-*")),
              what="router shard_down bundle")

        # fleet-wide collection: router + both replicas, ONE document
        fleet = fleet_debug.collect(raddr, timeout_s=10)
        assert fleet["bundle"] == FLEET_BUNDLE_VERSION
        assert fleet["processes"] == 3
        assert fleet["router"]["bundle"]["role"] == "router"
        assert sorted(r["shard"] for r in fleet["replicas"]) == [0, 1]
        pids = {fleet["router"]["bundle"]["pid"]} | {
            r["bundle"]["pid"] for r in fleet["replicas"]
        }
        assert len(pids) == 3  # three distinct OS processes merged
        for rep in fleet["replicas"]:
            assert rep["bundle"]["role"] == "service"
            assert rep["bundle"]["recorder"]["bundles"] >= 1
            assert rep["bundle"]["history"], "sampler env reached subprocs"

        out_dir = tmp_path / "fleet"
        assert fleet_debug.main(
            [raddr, "--out", str(out_dir), "--timeout", "10"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["event"] == "fleet_bundle"
        assert line["processes"] == 3 and line["unreachable"] == []
        bundle_path = out_dir / "fleet_bundle.json"
        assert bundle_path.is_file() and Path(line["path"]) == bundle_path

        # the postmortem renders without error and names the trauma
        assert trace_report_main([str(bundle_path), "--bundle"]) == 0
        rendered = capsys.readouterr().out
        assert "fleet debug bundle" in rendered
        assert "3 processes captured" in rendered
        assert "router" in rendered and "replica" in rendered
        assert "metrics history" in rendered
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=PROC_WAIT_S)


# --- parity: the same recorded replies through both tools -------------------


class _Client:
    """A stand-in for one endpoint's client: its recorded replies."""

    def __init__(self, replies: dict):
        self._replies = replies

    def _get(self, op):
        return copy.deepcopy(self._replies[op])

    def health(self):
        return self._get("health")

    def stats(self):
        return self._get("stats")

    def metrics(self):
        return self._get("metrics")

    def profile(self):
        return self._get("profile")

    def debug(self):
        return self._get("debug")

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


class _Recorded:
    """Every endpoint's replies, recorded once; an endpoint without a
    record refuses the connection, as a dead process would."""

    def __init__(self, replies: dict):
        self.replies = replies

    def client(self, addr, timeout_s=None, **_kw):
        if addr not in self.replies:
            raise ConnectionRefusedError(111, "Connection refused")
        return _Client(self.replies[addr])

    def pool(self, timeout_s=None, **_kw):
        rec = self

        class _Pool:
            connects = 0
            reconnects = 0

            def get(self, addr):
                return rec.client(addr)

            def invalidate(self, addr):
                pass

            def __enter__(self):
                return self

            def __exit__(self, *exc):
                pass

        return _Pool()


OPS = ("health", "stats", "metrics", "profile", "debug")


@pytest.fixture(scope="module")
def recorded(split, tmp_path_factory):
    """(router address, replies of the router and both shard servers) of a
    live port fabric after a few exact queries."""
    tmp = tmp_path_factory.mktemp("fleet_tools_rec")
    with Fabric(split, tmp) as f:
        assert f.cli.pi(N - 5) == o_pi(N - 5)
        lo = f.E + 10
        assert f.cli.count(lo, lo + 50) == o_count(lo, lo + 50)
        addrs = [f.router.addr] + [s.addr for s in f.svcs]
        replies = {}
        for a in addrs:
            with ServiceClient(a, timeout_s=10) as c:
                replies[a] = {op: getattr(c, op)() for op in OPS}
    return f.router.addr, replies


def _patch(monkeypatch, rec: _Recorded):
    """Both packages' tools talk to ``rec``; the clock and the wall time
    are frozen, so the timestamps they print agree."""
    for mod in (ref_fleet_top, fleet_top, ref_fleet_debug, fleet_debug,
                ref_fleet_profile, fleet_profile):
        if hasattr(mod, "ServiceClient"):
            monkeypatch.setattr(mod, "ServiceClient", rec.client)
        monkeypatch.setattr(mod, "ClientPool", rec.pool)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "frozen")


def _both(capsys, ref_main, port_main, argv_ref, argv_port=None):
    rc_ref = ref_main(argv_ref)
    out_ref = capsys.readouterr().out
    rc_port = port_main(argv_port or argv_ref)
    out_port = capsys.readouterr().out
    return (rc_ref, out_ref), (rc_port, out_port)


@pytest.mark.parametrize("down", [None, "replica", "router"])
@pytest.mark.parametrize("mode", ["--once", "--json"])
def test_fleet_top_parity_on_recorded_replies(recorded, monkeypatch, capsys,
                                              mode, down):
    raddr, replies = recorded
    replies = dict(replies)
    if down == "replica":
        replies.pop(list(replies)[-1])  # shard 1's server: a DOWN row
    elif down == "router":
        replies.pop(raddr)
    _patch(monkeypatch, _Recorded(replies))
    ref, port = _both(capsys, ref_fleet_top.main, fleet_top.main, [raddr, mode])
    assert port == ref
    rc, out = port
    # --json fails on any DOWN row, --once only on an unreachable router
    assert rc == int(down == "router" or (mode == "--json" and down is not None))
    if mode == "--json":
        snap = json.loads(out)
        assert snap["ts"] == 1_700_000_000.0
        assert (snap["router"]["health"] is None) == (down == "router")
    elif down != "router":
        assert "slo burn" in out and "hot frame" in out


def test_fleet_top_observe_dir_parity(recorded, monkeypatch, capsys, tmp_path):
    """The sparkline columns from an observer's ring: the port's observer
    writes the ring, both tools read it."""
    from sieve_torch.service.observe import RING_FILE, SnapshotRing

    raddr, replies = recorded
    shard_addr = list(replies)[1]
    ring = SnapshotRing(str(tmp_path / RING_FILE))
    for i in range(5):
        ring.append({"scrape": i + 1, "targets": [
            {"addr": shard_addr, "signals": {"hot_qps": float(i * i),
                                             "shed_rate": 0.5 * i}},
            {"addr": raddr, "gap": True}]})
    _patch(monkeypatch, _Recorded(replies))
    ref, port = _both(capsys, ref_fleet_top.main, fleet_top.main,
                      [raddr, "--once", "--observe-dir", str(tmp_path)])
    assert port == ref
    assert port[0] == 0 and "hot trend" in port[1]
    assert any(ch in port[1] for ch in "▁▂▃▄▅▆▇█")


@pytest.mark.parametrize("down", [None, "replica"])
def test_fleet_debug_parity_on_recorded_replies(recorded, monkeypatch, capsys,
                                                tmp_path, down):
    raddr, replies = recorded
    replies = dict(replies)
    if down:
        replies.pop(list(replies)[-1])
    _patch(monkeypatch, _Recorded(replies))
    outs = {}
    for name, main in (("ref", ref_fleet_debug.main), ("port", fleet_debug.main)):
        d = tmp_path / name
        rc = main([raddr, "--out", str(d)])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line.pop("path") == str(d / "fleet_bundle.json")
        outs[name] = (rc, line, json.loads((d / "fleet_bundle.json").read_text()))
    assert outs["port"] == outs["ref"]
    rc, line, bundle = outs["port"]
    assert rc == (1 if down else 0)
    assert line["processes"] == (2 if down else 3)
    assert bundle["bundle"] == FLEET_BUNDLE_VERSION


@pytest.mark.parametrize("down", [None, "replica"])
def test_fleet_profile_parity_on_recorded_replies(recorded, monkeypatch, capsys,
                                                  tmp_path, down):
    raddr, replies = recorded
    replies = dict(replies)
    if down:
        replies.pop(list(replies)[-1])
    _patch(monkeypatch, _Recorded(replies))
    outs = {}
    for name, main in (("ref", ref_fleet_profile.main),
                       ("port", fleet_profile.main)):
        d = tmp_path / name
        rc = main([raddr, "--out", str(d), "--top", "5"])
        text = capsys.readouterr().out.replace(str(d), "<out>")
        outs[name] = (rc, text, (d / "fleet_profile.collapsed").read_text(),
                      json.loads((d / "fleet_profile.json").read_text()))
    assert outs["port"] == outs["ref"]
    rc, text, _collapsed, doc = outs["port"]
    assert rc == (1 if down else 0)
    summary = json.loads(text.strip().splitlines()[-1])
    assert summary["event"] == "fleet_profile"
    assert summary["unreachable"] == (["shard1"] if down else [])
    assert doc["profile"] == fleet_profile.FLEET_PROFILE_VERSION


def test_fleet_profile_diff_parity(tmp_path, capsys):
    def capture(path, stacks):
        path.write_text(json.dumps({"merged": {
            k: [v, "worker"] for k, v in stacks.items()}}))
        return str(path)

    old = capture(tmp_path / "a.json", {"router;rpc;loop;server._handle": 2,
                                        "shard0;rpc;loop;select": 30,
                                        "shard1;rpc;worker;index.count": 8})
    new = capture(tmp_path / "b.json", {"router;rpc;loop;server._handle": 25,
                                        "shard0;rpc;loop;select": 30,
                                        "shard1;rpc;worker;index.count": 3})
    ref, port = _both(capsys, ref_fleet_profile.main, fleet_profile.main,
                      ["--diff", old, new, "--top", "10"])
    assert port == ref
    assert port[0] == 0
    assert json.loads(port[1].strip().splitlines()[-1])["top_delta"] == "server._handle"


# --- a fresh interpreter: no torch, no jax, no sieve, no tools ---------------


_PROBE = """
import contextlib, io, json, runpy, sys
runs = json.loads(sys.argv[1])
rcs, out = [], io.StringIO()
for argv in runs:
    sys.argv = list(argv)
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module(argv[0], run_name="__main__")
        except SystemExit as e:
            rcs.append(e.code)
print(json.dumps({"rcs": rcs, "out": out.getvalue(), "after": sorted(sys.modules)}))
"""


def test_fleet_tools_load_no_torch_no_jax_no_sieve_no_tools(tmp_path):
    dead = "127.0.0.1:1"
    diff = tmp_path / "c.json"
    diff.write_text(json.dumps({"merged": {"router;a": [3, "loop"]}}))
    runs = [
        ["sieve_torch.tools.fleet_top", dead, "--json", "--timeout", "0.2"],
        ["sieve_torch.tools.fleet_top", dead, "--once", "--timeout", "0.2"],
        ["sieve_torch.tools.fleet_debug", dead, "--out", str(tmp_path / "d"),
         "--timeout", "0.2"],
        ["sieve_torch.tools.fleet_profile", dead, "--out", str(tmp_path / "p"),
         "--timeout", "0.2"],
        ["sieve_torch.tools.fleet_profile", "--diff", str(diff), str(diff)],
    ]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(runs)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["rcs"] == [1, 1, 1, 1, 0]
    assert "UNREACHABLE" in got["out"]
    # the modules each tool ran as __main__ leave no entry; their imports do
    assert {"sieve_torch.profile", "sieve_torch.debug", "sieve_torch.service.client",
            "sieve_torch.tools.trace_report"} <= set(got["after"])
    loaded = [m for m in got["after"]
              if m.split(".")[0] in ("torch", "jax", "jaxlib", "sieve", "tools")]
    assert not loaded, f"the fleet tools loaded {loaded}"
