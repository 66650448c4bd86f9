"""Carry state across from the reference package.

The sieve has no weights: its state is the prepared segment tables and
the run config. Both cross as plain data — numpy arrays, ints and
strings — so this module imports nothing of the reference:

  - ``segment_from_reference(dataclasses.asdict(pallas_segment))`` gives
    the port's CudaSegment, so the reference's kernel and the port's can
    be fed the very same tables;
  - ``tiered_from_reference(dataclasses.asdict(tiered_segment))`` gives
    the port's TieredSegment, so both word kernels can be fed the same
    tables;
  - ``config_from_reference(sieve_config.to_dict())`` gives the port's
    SieveConfig, with ``tpu-pallas`` mapped to ``cuda`` and ``jax`` to
    ``torch``; its checkpoint dir and ``resume`` carry over, and a ledger
    written by either package resumes under the other (same file format,
    same config hash), as do ``cpu-cluster`` and its coordinator address,
    the chaos schedule, ``multihost``, ``profile_dir`` (a torch.profiler
    trace in the port), ``trace_file`` and ``metrics_file``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from sieve_torch.config import SieveConfig
from sieve_torch.kernels.cuda_mark import CudaSegment
from sieve_torch.kernels.specs import TieredSegment

# reference backend -> port backend
BACKEND_MAP = {"tpu-pallas": "cuda", "jax": "torch", "cpu-numpy": "cpu-numpy",
               "cpu-native": "cpu-native", "cpu-cluster": "cpu-cluster"}


def _fields_from(cls, d: dict[str, Any]):
    """A dataclass of numpy arrays, tuples of them and ints from the
    reference's ``dataclasses.asdict`` of its counterpart."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if isinstance(v, (tuple, list)):
            v = tuple(int(a) if np.ndim(a) == 0 else np.asarray(a) for a in v)
        elif isinstance(v, np.ndarray):
            v = np.asarray(v)
        else:
            v = int(v)
        kw[f.name] = v
    return cls(**kw)


def segment_from_reference(d: dict[str, Any]) -> CudaSegment:
    """CudaSegment from ``dataclasses.asdict`` of the reference's
    PallasSegment (same field names, numpy arrays and ints)."""
    return _fields_from(CudaSegment, d)


def tiered_from_reference(d: dict[str, Any]) -> TieredSegment:
    """TieredSegment from ``dataclasses.asdict`` of the reference's
    TieredSegment: the word kernel's tables as plain arrays."""
    return _fields_from(TieredSegment, d)


def config_from_reference(d: dict[str, Any], device: str = "cuda") -> SieveConfig:
    """Port SieveConfig from the reference's ``SieveConfig.to_dict()``."""
    backend = d.get("backend", "cpu-numpy")
    if backend not in BACKEND_MAP:
        raise NotImplementedError(
            f"sieve_torch: backend {backend!r} has no counterpart in the port"
        )
    fields = {f.name for f in dataclasses.fields(SieveConfig)}
    kw = {k: v for k, v in d.items() if k in fields}
    kw["backend"] = BACKEND_MAP[backend]
    kw["device"] = device
    return SieveConfig(**kw)
