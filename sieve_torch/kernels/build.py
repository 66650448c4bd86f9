"""Build and load the port's CUDA kernels.

``csrc/fused_mark.cu``, which holds both marking kernels (fused and
split), is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds. The library goes to ``sieve_torch/_build/`` named by a hash
of the source and flags, so an edit rebuilds and an unchanged tree reuses
what is there. Nothing is built at import: the first call that needs a
kernel builds the library, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from sieve_torch.analysis.lockdebug import named_lock

PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_mark.cu"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_GROUPS = [
    _P, _P, _P,                 # group A: m, rK, act
    _P, _P, _P, _I,             # group B + count
    _P, _P, _P, _I,             # group C + count
    _P, _P, _P, _I,             # group D + count
]
ARGTYPES = _GROUPS + [
    _P, _P, _P,                 # corrections: idx, mask, per-tile cursors
    _P, _P, _P,                 # flat clears: idx, mask, per-tile cursors
    _I, _I, ctypes.c_uint, _I,  # G, nbits, pair_mask, shift
    _P, _P, _P,                 # words_out (nullable), partials, result
    _I, _P,                     # device, stream
]
SPLIT_ARGTYPES = _GROUPS + [
    _I, _P,                     # G, words_out
    _I, _P,                     # device, stream
]

_lock = named_lock("build._lock")
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernel builds on first use"
    )


def library_path(source: Path = SOURCE) -> Path:
    """Where a source builds to: named by a hash of the source and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"libfused_mark-{h.hexdigest()[:16]}.so"


def build(force: bool = False, source: Path = SOURCE) -> dict:
    """Compile ``source`` (this package's kernels unless another copy of
    them is named) unless its library exists (or ``force``). Returns
    {"path", "seconds", "log", "cached"}; raises if nvcc fails."""
    out = library_path(source)
    if out.exists() and not force:
        return {"path": str(out), "seconds": 0.0, "log": "", "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0,
            "log": proc.stdout, "cached": False}


def bind(path: str) -> ctypes.CDLL:
    """Load a built library and declare its C entry points."""
    lib = ctypes.CDLL(path)
    lib.sieve_fused_mark.argtypes = ARGTYPES
    lib.sieve_fused_mark.restype = ctypes.c_int
    lib.sieve_split_mark.argtypes = SPLIT_ARGTYPES
    lib.sieve_split_mark.restype = ctypes.c_int
    lib.sieve_warm.argtypes = [ctypes.c_int]
    lib.sieve_warm.restype = ctypes.c_int
    lib.sieve_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sieve_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build()["path"])
        return _lib
