"""The port stands alone: no JAX, nothing of ``sieve``, no silent CPU.

  - a fresh interpreter runs ``python -m sieve_torch --n 1e5 --device cpu``
    on the cuda backend and on the torch backend, and ``--emit-primes`` (the
    entry point, through runpy), and imports every module of the package,
    the ``analysis`` and ``service`` subpackages included, and neither ``jax``
    nor ``sieve`` is loaded afterwards; no source file of the package (nor
    chip_smoke.py) names them in an import; the same holds for a cluster
    worker (``--role worker`` on the cuda backend) and for a
    ``--multihost`` rank, each in its own interpreter;
  - a fresh interpreter runs ``python -m sieve_torch serve --device cpu``
    (cold-only), answers queries through the port's ``ServiceClient`` and
    shuts down over the wire, and has loaded neither afterwards;
  - a fresh interpreter imports the fabric (shards, router, observer) and
    runs ``route --help`` and ``observe --help``, and has loaded neither
    ``torch`` nor ``jax`` nor ``sieve``: a router or observer process pays
    no torch start and opens no CUDA context;
  - the measurement tools (``sieve_torch/tools/``) import nothing of the
    repository's ``tools`` either: a fresh interpreter runs
    ``python -m sieve_torch.tools.trace_report FILE`` and loads none of
    ``torch``, ``jax``, ``sieve`` or ``tools``, and another runs
    ``profile_prepare`` and loads neither ``jax`` nor ``sieve``;
  - the static gates ``check_concurrency``, ``check_env_vars`` and
    ``check_event_schema``, each run as ``python -m`` in a fresh
    interpreter, exit 0 and load none of ``torch``, ``jax``, ``sieve`` or
    ``tools``; the service, chaos and store smokes, each run in a fresh
    interpreter with ``--device cpu``, pass and load neither ``jax`` nor
    ``sieve`` (the failover, shard, observe and profile smokes' own check
    is in tests/test_torch_fleet_smokes.py, which runs each of them once;
    the fleet tools' in tests/test_torch_fleet_tools.py, the graft
    entry's in tests/test_torch_graft_entry.py);
  - no command the package starts runs ``-m sieve``: a spawned process is
    ``-m sieve_torch``;
  - asking for the card where there is none raises a clear error instead
    of running on the CPU;
  - chip_smoke.py exits non-zero and prints no result without a card, and
    outside a checkout of the repository.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "sieve_torch"
# the repository's ``tools`` are the reference's scripts: the port keeps
# its own copies in sieve_torch/tools
FORBIDDEN = ("jax", "jaxlib", "sieve", "tools")
OK_LINE = '"ok": true'


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


_PROBE = """
import io, contextlib, json, pkgutil, importlib, runpy, sys
buf = io.StringIO()
rcs = []
with contextlib.redirect_stdout(buf):
    for backend in ("cuda", "torch"):
        sys.argv = ["sieve_torch", "--n", "1e5", "--device", "cpu", "--count-kind",
                    "cousins", "--packing", "wheel30", "--segments", "3",
                    "--backend", backend]
        try:
            runpy.run_module("sieve_torch", run_name="__main__")
        except SystemExit as e:
            rcs.append(e.code)
    sys.argv = ["sieve_torch", "--emit-primes", "999900:1000000"]
    try:
        runpy.run_module("sieve_torch", run_name="__main__")
    except SystemExit as e:
        rcs.append(e.code)
import sieve_torch
mods = [m.name for m in pkgutil.walk_packages(sieve_torch.__path__, "sieve_torch.")
        if m.name != "sieve_torch.__main__"]  # importing it runs the CLI
for m in mods:
    importlib.import_module(m)
print(json.dumps({"rcs": rcs, "out": buf.getvalue(), "modules": mods,
                  "after": sorted(sys.modules)}))
"""


def test_run_loads_no_jax_and_no_sieve():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["rcs"] == [0, 0, 0]
    lines = got["out"].splitlines()
    assert lines[6:] == ["999907", "999917", "999931", "999953", "999959", "999961",
                         "999979", "999983"]
    for i, backend in enumerate(("cuda", "torch")):
        assert lines[3 * i : 3 * i + 2] == [
            "pi(100000) = 9592", "cousin pairs (p, p+4 <= 100000) = 1216"]
        assert lines[3 * i + 2].startswith(f"backend={backend} packing=wheel30 segments=3 ")
    assert {"sieve_torch.kernels.cuda_mark", "sieve_torch.backends.cuda",
            "sieve_torch.interop", "sieve_torch.kernels.build",
            "sieve_torch.kernels.word_mark", "sieve_torch.backends.torch_words",
            "sieve_torch.backends.mesh_backend", "sieve_torch.backends.cpu_native",
            "sieve_torch.cluster", "sieve_torch.rpc", "sieve_torch.trace",
            "sieve_torch.metrics", "sieve_torch.chaos", "sieve_torch.parallel.dist",
            "sieve_torch.analysis.lockdebug", "sieve_torch.analysis.model",
            "sieve_torch.service", "sieve_torch.service.index",
            "sieve_torch.service.store", "sieve_torch.service.exemplar",
            "sieve_torch.enumerate", "sieve_torch.debug", "sieve_torch.profile",
            "sieve_torch.service.server", "sieve_torch.service.client",
            "sieve_torch.service.shards", "sieve_torch.service.router",
            "sieve_torch.service.observe", "sieve_torch.tools",
            "sieve_torch.tools.trace_report", "sieve_torch.tools.profile_prepare",
            "sieve_torch.tools.profile_kernel", "sieve_torch.tools.profile_rtt",
            "sieve_torch.tools.profile_breakdown", "sieve_torch.tools.profile_rounds",
            "sieve_torch.tools.microbench", "sieve_torch.tools.mesh_cold_smoke",
            "sieve_torch.analysis.core", "sieve_torch.analysis.checks",
            "sieve_torch.tools.check_concurrency", "sieve_torch.tools.check_env_vars",
            "sieve_torch.tools.check_event_schema", "sieve_torch.tools.check_wire_ops",
            "sieve_torch.tools.check_all", "sieve_torch.tools.service_smoke",
            "sieve_torch.tools.chaos_smoke", "sieve_torch.tools.store_smoke",
            "sieve_torch.tools.failover_smoke", "sieve_torch.tools.shard_smoke",
            "sieve_torch.tools.observe_smoke", "sieve_torch.tools.profile_smoke",
            "sieve_torch.tools.fleet_top", "sieve_torch.tools.fleet_debug",
            "sieve_torch.tools.fleet_profile", "sieve_torch.tools.autotune_kernel",
            "sieve_torch.graft_entry",
            } <= set(got["modules"])
    loaded = [m for m in got["after"] if _forbidden(m)]
    assert not loaded, f"the port loaded {loaded}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_spawned_commands_run_the_port(path):
    """Every ``-m <module>`` in a literal command list names sieve_torch."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, (ast.List, ast.Tuple)):
            continue
        items = [e.value if isinstance(e, ast.Constant) else None for e in node.elts]
        for flag, module in zip(items, items[1:]):
            if flag == "-m" and isinstance(module, str) and _forbidden(module):
                raise AssertionError(f"{path.name}:{node.lineno} runs -m {module}")


# runs one process of the port through its entry point, then reports the
# modules it loaded; argv[1:] are the CLI's arguments
_ROLE_PROBE = """
import json, runpy, sys
sys.argv = ["sieve_torch"] + sys.argv[1:]
try:
    runpy.run_module("sieve_torch", run_name="__main__")
except SystemExit as e:
    rc = e.code
print(json.dumps({"rc": rc, "after": sorted(sys.modules)}))
"""


def _free_addr() -> str:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _role_probe(argv, **env):
    run_env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen([sys.executable, "-c", _ROLE_PROBE, *argv], cwd=REPO,
                            env={**run_env, **env}, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_cluster_worker_loads_no_jax_and_no_sieve(monkeypatch):
    from sieve_torch.cluster import run_cluster
    from sieve_torch.config import SieveConfig

    monkeypatch.setenv("SIEVE_CLUSTER_NO_SPAWN", "1")
    addr = _free_addr()
    proc = _role_probe(["--role", "worker", "--n", "1e5", "--device", "cpu",
                              "--coordinator-addr", addr],
                             SIEVE_CLUSTER_WORKER_BACKEND="cuda")
    try:
        res = run_cluster(SieveConfig(n=10**5, backend="cpu-cluster", device="cpu",
                                      workers=1, n_segments=4, quiet=True,
                                      coordinator_addr=addr))
    finally:
        out, err = proc.communicate(timeout=60)
    assert res.pi == 9592
    got = json.loads(out.strip().splitlines()[-1])
    assert got["rc"] == 0, err
    assert "sieve_torch.kernels.cuda_mark" in got["after"]
    loaded = [m for m in got["after"] if _forbidden(m)]
    assert not loaded, f"the cluster worker loaded {loaded}"


def test_multihost_rank_loads_no_jax_and_no_sieve():
    proc = _role_probe(["--n", "1e5", "--device", "cpu", "--workers", "2",
                              "--rounds", "2", "--twins", "--multihost",
                              "--dist-coordinator", _free_addr(),
                              "--dist-processes", "1", "--dist-process-id", "0"])
    out, err = proc.communicate(timeout=60)
    lines = out.strip().splitlines()
    got = json.loads(lines[-1])
    assert got["rc"] == 0, err
    assert lines[:2] == ["pi(100000) = 9592", "twin pairs (p, p+2 <= 100000) = 1224"]
    assert "sieve_torch.parallel.dist" in got["after"]
    loaded = [m for m in got["after"] if _forbidden(m)]
    assert not loaded, f"the multihost rank loaded {loaded}"


# serves in the main thread (it installs the SIGTERM handler) while a
# client thread reads the address line, queries and shuts the server down
_SERVE_PROBE = """
import contextlib, io, json, sys, threading, time
from sieve_torch.cli import main
buf = io.StringIO()
got = {}
def client():
    from sieve_torch.service import ServiceClient
    t0 = time.time()
    while "serving" not in buf.getvalue():
        if time.time() - t0 > 60:
            return
        time.sleep(0.05)
    addr = json.loads(buf.getvalue().splitlines()[0])["addr"]
    with ServiceClient(addr, timeout_s=30) as c:
        got["wire"] = c.wire_v
        got["pi"] = c.pi(10**5)
        got["batch"] = [m["value"] for m in c.query_batch(
            [{"op": "pi", "x": 1000}, {"op": "is_prime", "x": 99991}])]
        got["draining"] = c.shutdown()["draining"]
t = threading.Thread(target=client)
t.start()
with contextlib.redirect_stdout(buf):
    rc = main(["serve", "--n", "1e5", "--device", "cpu", "--addr", "127.0.0.1:0",
               "--quiet", "--refresh-s", "0"])
t.join(60)
print(json.dumps({"rc": rc, "got": got, "after": sorted(sys.modules)}))
"""


def test_serve_loads_no_jax_and_no_sieve():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SERVE_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert got["got"] == {"wire": 2, "pi": 9592, "batch": [168, True],
                          "draining": True}
    assert {"sieve_torch.service.server", "sieve_torch.service.client",
            "sieve_torch.backends.cuda"} <= set(got["after"])
    loaded = [m for m in got["after"] if _forbidden(m)]
    assert not loaded, f"the server loaded {loaded}"


_FABRIC_PROBE = """
import contextlib, io, json, sys
import sieve_torch.service.shards, sieve_torch.service.router
import sieve_torch.service.observe
from sieve_torch.cli import main
out, codes = io.StringIO(), []
for sub in ("route", "observe"):
    with contextlib.redirect_stdout(out):
        try:
            main([sub, "--help"])
        except SystemExit as e:
            codes.append(e.code)
print(json.dumps({"codes": codes, "help": out.getvalue(),
                  "after": sorted(sys.modules)}))
"""


def test_fabric_loads_no_torch_no_jax_no_sieve():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _FABRIC_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["codes"] == [0, 0]
    assert "usage: sieve_torch route" in got["help"]
    assert "usage: sieve_torch observe" in got["help"]
    loaded = [m for m in got["after"] if m == "torch" or m.startswith("torch.")
              or _forbidden(m)]
    assert not loaded, f"the fabric loaded {loaded}"


# runs one tool module as ``python -m`` would, then reports the modules it
# loaded; argv[1] is the module, argv[2:] its arguments
_TOOL_PROBE = """
import contextlib, io, json, runpy, sys
mod = sys.argv[1]
sys.argv = [mod] + sys.argv[2:]
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        runpy.run_module(mod, run_name="__main__")
    except SystemExit as e:
        rc = e.code
print(json.dumps({"rc": rc, "out": out.getvalue(), "after": sorted(sys.modules)}))
"""


def _tool_probe(*argv, timeout=120, **extra_env):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _TOOL_PROBE, *argv], cwd=REPO,
                          env={**env, **extra_env}, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_trace_report_loads_no_torch_no_jax_no_sieve_no_tools(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"name": "round.dispatch", "ph": "X", "ts": 0.0, "dur": 5.0, "args": {}}]}))
    got = _tool_probe("sieve_torch.tools.trace_report", str(path))
    assert got["rc"] == 0
    assert "per-phase breakdown" in got["out"]
    assert "sieve_torch.tools" in got["after"]  # the module ran as __main__
    loaded = [m for m in got["after"] if m == "torch" or m.startswith("torch.")
              or _forbidden(m)]
    assert not loaded, f"trace_report loaded {loaded}"


def test_profile_prepare_loads_no_jax_and_no_sieve():
    got = _tool_probe("sieve_torch.tools.profile_prepare", "1e5", "1")
    assert got["rc"] == 0
    assert "CudaChain steady-state prepare" in got["out"]
    loaded = [m for m in got["after"] if _forbidden(m)]
    assert not loaded, f"profile_prepare loaded {loaded}"


@pytest.mark.parametrize("tool, ok", [
    ("check_concurrency", "check_concurrency: ok (0 new findings, 0 waived)"),
    ("check_env_vars", "check_env_vars: ok ("),
    ("check_event_schema", "check_event_schema: ok ("),
])
def test_static_gates_load_no_torch_no_jax_no_sieve_no_tools(tool, ok):
    got = _tool_probe(f"sieve_torch.tools.{tool}")
    assert got["rc"] == 0
    assert got["out"].startswith(ok)
    if tool == "check_concurrency":
        assert "sieve_torch.analysis.core" in got["after"]
    loaded = [m for m in got["after"] if m == "torch" or m.startswith("torch.")
              or _forbidden(m)]
    assert not loaded, f"{tool} loaded {loaded}"


@pytest.mark.parametrize("smoke", ["service_smoke", "chaos_smoke", "store_smoke"])
def test_smokes_load_no_jax_and_no_sieve(smoke, tmp_path):
    got = _tool_probe(f"sieve_torch.tools.{smoke}", "--device", "cpu",
                      "--keep", str(tmp_path / "work"), timeout=300,
                      OMP_NUM_THREADS="1")
    assert got["rc"] == 0, got["out"][-2000:]
    assert got["out"].splitlines()[-1] == f"{smoke.upper()}_OK"
    loaded = [m for m in got["after"] if _forbidden(m)]
    assert not loaded, f"{smoke} loaded {loaded}"


@pytest.mark.parametrize("module, argv, first, torch_free", [
    ("sieve_torch.bench", ["--help"], "usage: python -m sieve_torch.bench", False),
    ("sieve_torch.tools.bench_compare", [], "bench_compare: round r", True),
])
def test_bench_modules_load_no_jax_no_sieve_no_tools(module, argv, first, torch_free):
    """The benchmark and its gate, each run as ``python -m`` in a fresh
    interpreter, load none of ``jax``, ``sieve`` or ``tools`` (the gate,
    host code, no torch either)."""
    got = _tool_probe(module, *argv)
    assert got["rc"] == 0
    assert got["out"].startswith(first)
    loaded = [m for m in got["after"] if _forbidden(m)
              or (torch_free and (m == "torch" or m.startswith("torch.")))]
    assert not loaded, f"{module} loaded {loaded}"


def test_cuda_device_without_card_raises(monkeypatch, capsys):
    """device='cuda' (the default) never falls back to the CPU."""
    from sieve_torch.cli import main
    from sieve_torch.config import SieveConfig
    from sieve_torch.coordinator import run_local

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_local(SieveConfig(n=10**5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_local(SieveConfig(n=10**5, backend="cuda", device="cuda:0"))
    assert main(["--n", "1e5", "--device", "cuda"]) == 2
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and "pi(" not in err.out
    # serve probes the card at start: exit 2 before it listens
    assert main(["serve", "--n", "1e5", "--addr", "127.0.0.1:0"]) == 2
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and "serving" not in err.out
    # the numpy backend has no device and still runs
    assert run_local(SieveConfig(n=10**5, backend="cpu-numpy")).pi == 9592


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from sieve_torch.kernels import build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    path = build.library_path()
    assert path.parent == PKG / "_build" and path.name.startswith("libfused_mark-")
    assert path == build.library_path()  # stable for one tree


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs in full there")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert OK_LINE not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert OK_LINE not in proc.stdout
    assert "No module named 'sieve_torch'" in proc.stderr
