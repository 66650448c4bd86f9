"""Backend registry: maps ``--backend`` names to SieveWorker implementations.

Imports are lazy, so building the registry loads no backend.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

if TYPE_CHECKING:
    from sieve_torch.config import SieveConfig
    from sieve_torch.worker import SieveWorker


def _cpu_numpy(config: "SieveConfig") -> "SieveWorker":
    from sieve_torch.backends.cpu_numpy import CpuNumpyWorker

    return CpuNumpyWorker(config)


def _cpu_native(config: "SieveConfig") -> "SieveWorker":
    from sieve_torch.backends.cpu_native import CpuNativeWorker

    return CpuNativeWorker(config)


def _cuda(config: "SieveConfig") -> "SieveWorker":
    from sieve_torch.backends.cuda import CudaWorker

    return CudaWorker(config)


def _torch(config: "SieveConfig") -> "SieveWorker":
    from sieve_torch.backends.torch_words import TorchWorker

    return TorchWorker(config)


WORKER_FACTORIES: dict[str, Callable[["SieveConfig"], "SieveWorker"]] = {
    "cpu-numpy": _cpu_numpy,
    "cpu-native": _cpu_native,
    "cuda": _cuda,
    "torch": _torch,
}


def make_worker(config: "SieveConfig") -> "SieveWorker":
    try:
        factory = WORKER_FACTORIES[config.backend]
    except KeyError:
        raise ValueError(f"backend {config.backend!r} has no worker") from None
    return factory(config)
