"""cpu-native backend: the C++ mark_multiples hot loop through ctypes.

The counterpart of the reference's cpu-native backend. Python computes
the marking specs; the strided bit-clear, popcount and pair reduction run
in sieve_torch/csrc/mark_multiples.cc over a packed uint64 buffer. The
library is built with g++ at first use into sieve_torch/_build/, named by
a hash of the source and flags, under a file lock so that concurrent
first uses never load a half-written library. With SIEVE_NATIVE_ASAN set
(read at the first load) the process builds and loads the sanitizer
variant instead, the reference's ``make asan`` target: ``-O1 -g
-fsanitize=address,undefined``, under its own hashed name. A process that
loads it must have the ASan runtime preloaded (``LD_PRELOAD`` of
``g++ -print-file-name=libasan.so``), since python itself is not
instrumented.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import time
from pathlib import Path

import numpy as np

from sieve_torch import env, trace
from sieve_torch.analysis.lockdebug import named_lock
from sieve_torch.bitset import get_layout
from sieve_torch.kernels.specs import _pair_mask, marking_specs
from sieve_torch.worker import SegmentResult, SieveWorker

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "mark_multiples.cc"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall", "-Wextra")
ASAN_FLAGS = ("-O1", "-g", "-fPIC", "-shared", "-fsanitize=address,undefined")

_lock = named_lock("cpu_native._lock")
_LIB: ctypes.CDLL | None = None


def _asan() -> bool:
    return bool(env.env_str("SIEVE_NATIVE_ASAN"))


def library_path(asan: bool = False) -> Path:
    """The library of this source and flag set (the sanitizer's with
    ``asan``), named by their hash."""
    flags = ASAN_FLAGS if asan else FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(SOURCE.read_bytes())
    stem = "libmark_asan" if asan else "libmark"
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _build_and_load() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        asan = _asan()
        so = library_path(asan)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / ".mark_build_lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not so.exists():
                    tmp = so.with_suffix(f".{os.getpid()}.tmp")
                    proc = subprocess.run(
                        ["g++", *(ASAN_FLAGS if asan else FLAGS), "-o",
                         str(tmp), str(SOURCE)],
                        capture_output=True, text=True,
                    )
                    if proc.returncode != 0:
                        tmp.unlink(missing_ok=True)
                        raise RuntimeError(
                            f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
                    os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.sieve_init.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.mark_multiples.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.popcount_words.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.popcount_words.restype = ctypes.c_int64
        lib.twin_count.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.twin_count.restype = ctypes.c_int64
        _LIB = lib
        return lib


def _pair_mask64(packing: str, lo: int, gap: int = 2) -> int:
    """64-bit pairability mask: the 32-bit rule's period (8) divides 32,
    so the wide mask is the 32-bit one doubled."""
    m32 = _pair_mask(packing, lo, gap)
    return m32 | (m32 << 32)


def _boundary_words_u64(words: np.ndarray, nbits: int) -> tuple[int, int]:
    """(first_word, last_word) in SegmentResult's uint32 semantics."""
    first = int(words[0]) & 0xFFFFFFFF
    if nbits <= 32:
        return first, first
    off = nbits - 32
    w, sh = divmod(off, 64)
    val = int(words[w]) >> sh
    if sh > 32 and w + 1 < words.size:
        val |= int(words[w + 1]) << (64 - sh)
    return first, val & 0xFFFFFFFF


class CpuNativeWorker(SieveWorker):
    name = "cpu-native"

    def __init__(self, config):
        super().__init__(config)
        self._lib = _build_and_load()

    def process_segment(
        self, lo: int, hi: int, seed_primes: np.ndarray, seg_id: int = 0
    ) -> SegmentResult:
        t0 = time.perf_counter()
        packing = self.config.packing
        layout = get_layout(packing)
        with trace.span("segment.prepare", backend=self.name, seg=seg_id):
            specs = marking_specs(packing, lo, hi, seed_primes)
        nbits = specs.nbits
        nwords = max(1, -(-nbits // 64))
        words = np.empty(nwords, dtype=np.uint64)
        m = specs.m.astype(np.int64)
        s = specs.s.astype(np.int64)

        lib = self._lib
        words_p = words.ctypes.data_as(ctypes.c_void_p)
        with trace.span("segment.mark", backend=self.name, seg=seg_id):
            lib.sieve_init(words_p, nwords, nbits)
            lib.mark_multiples(
                words_p,
                nbits,
                m.ctypes.data_as(ctypes.c_void_p),
                s.ctypes.data_as(ctypes.c_void_p),
                len(m),
            )
        count = int(lib.popcount_words(words_p, nwords)) + layout.extras_in(lo, hi)
        twin = 0
        if self.config.twins and nbits:
            gap = self.config.pair_gap or 2
            if packing == "plain":
                shift = gap
            elif packing == "odds":
                shift = gap // 2
            else:
                shift = 1
            twin = int(
                lib.twin_count(
                    words_p, nwords, shift, _pair_mask64(packing, lo, gap)
                )
            )
            twin += layout.extra_pairs(lo, hi, gap)
        first_word, last_word = _boundary_words_u64(words, nbits)
        return SegmentResult(
            seg_id=seg_id,
            lo=lo,
            hi=hi,
            count=count,
            twin_count=twin,
            first_word=first_word,
            last_word=last_word,
            nbits=nbits,
            elapsed_s=time.perf_counter() - t0,
        )
