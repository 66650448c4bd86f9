"""sieve_torch: the segmented Sieve of Eratosthenes on NVIDIA GPUs.

The PyTorch and CUDA port of the ``sieve`` package. It imports torch and
numpy, never JAX and nothing of ``sieve``; module and function names
follow the reference's, so each part has a counterpart to be held
against. A counting run:

    python -m sieve_torch --n 1e9 --backend cuda --twins

runs every segment through a hand-written Hopper kernel
(sieve_torch/kernels/csrc/fused_mark.cu). ``--device cpu`` runs the
kernel's plain PyTorch version instead.
"""

from sieve_torch.config import SieveConfig
from sieve_torch.coordinator import SieveResult, run_local

__all__ = ["SieveConfig", "SieveResult", "run_local"]
