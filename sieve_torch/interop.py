"""Carry state across from the reference package.

The sieve has no weights: its state is the prepared segment tables and
the run config. Both cross as plain data — numpy arrays, ints and
strings — so this module imports nothing of the reference:

  - ``segment_from_reference(dataclasses.asdict(pallas_segment))`` gives
    the port's CudaSegment, so the reference's kernel and the port's can
    be fed the very same tables;
  - ``config_from_reference(sieve_config.to_dict())`` gives the port's
    SieveConfig, with ``tpu-pallas`` mapped to ``cuda``; its checkpoint
    dir and ``resume`` carry over, and a ledger written by either package
    resumes under the other (same file format, same config hash).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from sieve_torch.config import SieveConfig
from sieve_torch.kernels.cuda_mark import CudaSegment

# reference backend -> port backend
BACKEND_MAP = {"tpu-pallas": "cuda", "cpu-numpy": "cpu-numpy"}
# reference backend -> the later slice of the port that brings it
BACKEND_SLICES = {
    "jax": "torch word-kernel backend",
    "cpu-native": "tools and bench",
    "cpu-cluster": "cluster",
}
# reference-only fields -> the slice that brings them (rejected when set)
FIELD_SLICES = {
    "profile_dir": "tracing",
    "trace_file": "tracing",
    "metrics_file": "tracing",
    "coordinator_addr": "cluster",
}
_FIELD_DEFAULTS = {"coordinator_addr": "127.0.0.1:7621"}


def segment_from_reference(d: dict[str, Any]) -> CudaSegment:
    """CudaSegment from ``dataclasses.asdict`` of the reference's
    PallasSegment (same field names, numpy arrays and ints)."""
    kw = {}
    for f in dataclasses.fields(CudaSegment):
        v = d[f.name]
        if isinstance(v, (tuple, list)):
            v = tuple(np.asarray(a) for a in v)
        elif isinstance(v, np.ndarray):
            v = np.asarray(v)
        else:
            v = int(v)
        kw[f.name] = v
    return CudaSegment(**kw)


def config_from_reference(d: dict[str, Any], device: str = "cuda") -> SieveConfig:
    """Port SieveConfig from the reference's ``SieveConfig.to_dict()``."""
    backend = d.get("backend", "cpu-numpy")
    if backend not in BACKEND_MAP:
        slice_name = BACKEND_SLICES.get(backend, "a later")
        raise NotImplementedError(
            f"sieve_torch: backend {backend!r} is not ported yet; it comes "
            f"with the {slice_name} slice"
        )
    for name, slice_name in FIELD_SLICES.items():
        if d.get(name) not in (None, _FIELD_DEFAULTS.get(name)):
            raise NotImplementedError(
                f"sieve_torch: {name!r} is not ported yet; it comes with "
                f"the {slice_name} slice"
            )
    fields = {f.name for f in dataclasses.fields(SieveConfig)}
    kw = {k: v for k, v in d.items() if k in fields}
    kw["backend"] = BACKEND_MAP[backend]
    kw["device"] = device
    return SieveConfig(**kw)
