"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``configs`` gives, and a traffic mix, ``benchmark/traffic/<traffic>.json``.
A per-layer metric is read by ``benchmark/metrics/<name>.py``. A metric
without a ``workloads`` key belongs to every cell; one with it, to the
cells it lists. Adding a cell, a configuration, a mix or a per-layer
metric is adding files and entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    per_layer: tuple


def load(root: Path) -> dict:
    """The parsed BENCHMARK.json at the checkout's root."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(spec: dict, name: str, root: Path) -> Cell:
    """The cell ``name`` with its configuration, mix and metrics."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise ValueError(f"no workload {name!r}; the benchmark has "
                         f"{sorted(by_name)}")
    w = by_name[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=tuple(m for m in spec["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in spec["per_layer"] if _applies(m, name)),
    )


def reader(metric: str):
    """The module ``benchmark/metrics/<metric>.py``: its UNIT, LAYER and
    MOVES, and ``read(reading) -> float | None``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
