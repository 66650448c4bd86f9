"""``--profile-dir`` on the port: a torch.profiler trace of the run.

The reference wraps its dispatch in ``jax.profiler.trace`` on the jax and
tpu-pallas backends (sieve/cli.py); the port wraps it in
``torch.profiler.profile`` on their counterparts, cuda and torch, and
writes the Chrome trace with ``tensorboard_trace_handler``. Here, on the
CPU, the trace holds host ops only: that it holds the card's kernels is
checked on the card by chip_smoke.py (phase ``profile``). Held here:
  - ``python -m sieve_torch --n 1e6 --backend torch --device cpu
    --profile-dir D`` writes one loadable Chrome trace under D and prints
    the same result as the run without the flag; so do the cuda backend
    (the plain kernel) and the rounds path;
  - the other backends ignore the flag, as the reference's do;
  - a run on a card that torch.profiler cannot trace fails instead of
    tracing the host alone, and ``--device cuda`` without a card exits 2;
  - ``config_from_reference`` carries ``profile_dir``, out of the ledger
    key.
"""

import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sieve.config import SieveConfig as RefConfig
from sieve_torch import cli
from sieve_torch.config import SieveConfig
from sieve_torch.interop import config_from_reference

REPO = Path(__file__).resolve().parent.parent
# fields of the --json result that do not depend on the clock
STABLE = ("n", "pi", "twin_pairs", "backend", "packing", "n_segments")


def _traces(d: Path) -> list[Path]:
    return sorted(p for p in d.glob("*.pt.trace.json*"))


def _load(path: Path) -> dict:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)


def _run(argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv + ["--json", "--quiet"]) == 0
    out = json.loads(buf.getvalue().splitlines()[-1])
    return {k: out[k] for k in STABLE}


def _ops(doc: dict) -> set:
    return {e.get("name") for e in doc["traceEvents"] if e.get("cat") == "cpu_op"}


def test_cli_profile_dir_torch_backend_process(tmp_path):
    d = tmp_path / "prof"
    argv = [sys.executable, "-m", "sieve_torch", "--n", "1e6", "--backend",
            "torch", "--device", "cpu", "--twins", "--json", "--quiet"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # no oversubscription beside a loaded test run
    runs = [subprocess.run(a, cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=60)
            for a in (argv + ["--profile-dir", str(d)], argv)]
    for r in runs:
        assert r.returncode == 0, r.stderr
    got, plain = (json.loads(r.stdout.splitlines()[-1]) for r in runs)
    assert {k: got[k] for k in STABLE} == {k: plain[k] for k in STABLE}
    assert (got["pi"], got["twin_pairs"]) == (78_498, 8_169)
    files = _traces(d)
    assert len(files) == 1
    doc = _load(files[0])
    assert doc["traceEvents"]
    # the word kernel's torch ops ran inside the profiled window
    assert {"aten::remainder", "aten::bitwise_and"} & _ops(doc)
    assert not any(e.get("cat") == "kernel" for e in doc["traceEvents"])


@pytest.mark.parametrize("argv", [
    ["--backend", "cuda", "--segments", "3"],
    ["--backend", "cuda", "--rounds", "4", "--twins"],
    ["--backend", "torch", "--workers", "2", "--rounds", "2"],
], ids=["cuda-plain", "rounds", "torch-rounds"])
def test_profile_dir_device_backends(argv, tmp_path):
    d = tmp_path / "prof"
    base = ["--n", "1e6", "--device", "cpu"] + argv
    assert _run(base + ["--profile-dir", str(d)]) == _run(base)
    files = _traces(d)
    assert len(files) == 1
    assert _ops(_load(files[0]))


@pytest.mark.parametrize("backend", ["cpu-numpy", "cpu-native"])
def test_profile_dir_ignored_by_host_backends(backend, tmp_path):
    d = tmp_path / "prof"
    got = _run(["--n", "1e6", "--backend", backend, "--profile-dir", str(d)])
    assert got["pi"] == 78_498
    assert not d.exists()


def test_profiler_that_cannot_trace_the_card_fails(monkeypatch, tmp_path):
    from torch.profiler import ProfilerActivity

    # no card: the run exits 2 and names it, before it profiles anything
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--n", "1e5", "--profile-dir", str(tmp_path / "p")])
    assert rc == 2 and "no CUDA device" in err.getvalue()
    assert not (tmp_path / "p").exists()
    # a card that torch.profiler cannot trace: no silent host-only trace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU})
    cfg = SieveConfig(n=10**5, backend="cuda", device="cuda",
                      profile_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="cannot trace CUDA"):
        cli._profiler(cfg)


def test_profile_dir_carried_and_out_of_the_hash(tmp_path):
    args = cli.build_parser().parse_args(["--n", "1e6", "--profile-dir", "D"])
    cfg = cli.config_from_args(args)
    assert cfg.profile_dir == "D"
    ref = RefConfig(n=10**6, backend="tpu-pallas", profile_dir="D")
    got = config_from_reference(ref.to_dict(), device="cpu")
    assert got.profile_dir == "D" and got.backend == "cuda"
    assert got.config_hash() == ref.config_hash() == cfg.config_hash()
    assert SieveConfig(n=10**6).config_hash() == cfg.config_hash()
    # the port's config round-trips the field
    assert SieveConfig.from_dict(cfg.to_dict()) == cfg
