"""Mark+reduce on the card, fused and split: host tables, the kernel
wrappers, and their plain PyTorch versions.

One segment's work is described by host-prepared spec tables, grouped by
bit stride m exactly as the reference's TPU kernels group them, so the
tables equal the reference's array for array:

  A (m < 32)                  several marked bits per word
  B (32 <= m <= 1024)         at most one bit per word
  C (1024 < m <= D_MIN)       at most one bit per word
  D (D_MIN < m < flat cutoff) at most one bit per 4096-bit tile row; an
                              (ND, 128) table, zero-crossing specs pruned
  flat (m >= flat cutoff)     crossings enumerated on the host into a
                              sorted (word, clear mask) list

A spec (m, r) clears every bit b of the segment with b % m == r; the
table column ``rK`` holds r + K*m with K*m >= 32*Wpad, so rK - 32*w > 0
for every word w. The TPU-only columns (M1, rcp1, rcp: its f32
reciprocal mod) are kept so the tables stay the reference's; the CUDA
kernels use an exact integer mod and do not read them.

Both kernels live in csrc/fused_mark.cu and share its marking phase.

  - The fused kernel marks each 16,384-word tile, applies the flat clears,
    then the self-mark corrections, then the validity mask at nbits, and
    reduces the segment to four uint32 scalars: the popcount, the pair
    count, the first word, and the last 32 flag bits. ``need_bits`` also
    returns the final words. ``mark_fused`` launches it for a CUDA device
    and runs ``mark_fused_reference``, its plain version, for the CPU.
  - The split kernel only marks: it writes every tile's raw words,
    padding past nbits included, and the postlude (kernels/reduce.py)
    patches, masks and reduces them. ``mark_split`` launches it for a CUDA
    device and runs ``mark_split_reference`` for the CPU;
    ``mark_cuda_split`` is kernel plus postlude.

``mark_cuda`` picks one per call, as the reference's ``mark_pallas`` does:
fused unless SIEVE_PALLAS_FUSED=0. A failed build or launch raises;
nothing falls back.

The knobs SIEVE_PALLAS_DMIN, SIEVE_PALLAS_FLAT_MIN and SIEVE_PALLAS_FUSED
each resolve as the reference's do: the env var, else the port's tuned
file (written by ``python -m sieve_torch.tools.autotune_kernel``), else
the built-in default. The tuned file is SIEVE_TUNED_JSON when that is
set, else ``tuned_cuda.json`` at the repository's root; the TPU's
``tuned.json`` is never read, and keys with no knob here (the TPU's
SIEVE_PALLAS_ROWS) are ignored.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from sieve_torch import env
from sieve_torch.bitset import get_layout
from sieve_torch.kernels.pairs import PAIR_SHIFT
from sieve_torch.kernels.reduce import _postlude, pack4, popcount
from sieve_torch.kernels.specs import (
    DeltaModCache,
    _corrections,
    _pair_mask,
    _tier1_strides,
    flat_crossings,
    tier1_specs,
)
from sieve_torch.metrics import registry

TUNED_FILE = Path(__file__).resolve().parents[2] / "tuned_cuda.json"
TUNED_KNOBS = ("SIEVE_PALLAS_DMIN", "SIEVE_PALLAS_FLAT_MIN", "SIEVE_PALLAS_FUSED")


def _load_tuned() -> dict:
    """The tuned file's knob values, read at import: SIEVE_TUNED_JSON,
    else ``tuned_cuda.json`` at the repository's root. An absent or
    unreadable file (the normal state) means the defaults; ``_meta`` and
    keys with no knob here are dropped."""
    path = env.env_str("SIEVE_TUNED_JSON") or TUNED_FILE
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return {k: v for k, v in data.items() if k in TUNED_KNOBS}


_TUNED = _load_tuned()


def _knob(name: str, default: int) -> int:
    """An integer knob: the env var, else the tuned file, else default."""
    v = env.env_int(name, None)
    if v is None:
        v = int(_TUNED.get(name, default))
    return v


R_ROWS = 128                    # tile = (R_ROWS, 128) words; the kernel is written for it
TILE_WORDS = R_ROWS * 128
NA_PAD = 16                     # group-A slots (>= 11 primes below 32)
B_MAX = 1024
# Group-D threshold: strides wider than one tile row (128 words * 32 bits)
# hit each row at most once. Only raising it is meaningful (prepare clamps
# it to the 4096-bit row width); a huge value routes everything through C.
D_MIN = _knob("SIEVE_PALLAS_DMIN", 4096)
D_LANES = 128                   # specs per group-D table row
# Strides with at most this many crossings of the padded window leave the
# kernel's stride groups for the host-enumerated flat list.
_FLAT_MAX_HITS = 8
# 32 * Wpad must stay below this: the rK columns are int32
MAX_BITS = 1 << 30
_U32 = 0xFFFFFFFF               # words ride as int64 holding uint32 values


def _flat_cutoff(Wpad: int) -> int:
    """Smallest flat stride; SIEVE_PALLAS_FLAT_MIN (bits) overrides the
    auto cutoff, read per call so a sweep can move it."""
    v = _knob("SIEVE_PALLAS_FLAT_MIN", 0)
    if v <= 0:
        v = 32 * Wpad // _FLAT_MAX_HITS
    return max(v, max(D_MIN, 4096) + 1)


@dataclasses.dataclass(frozen=True)
class CudaSegment:
    nbits: int
    Wpad: int                   # padded word count, multiple of TILE_WORDS
    A: tuple[np.ndarray, ...]   # m, rK, M1, rcp1, rcp, act   each (1, NA_PAD)
    B: tuple[np.ndarray, ...]   # m, rK, M1, rcp1, rcp, act   each (1, SB)
    C: tuple[np.ndarray, ...]   # m, rK, rcp, act             each (1, SC)
    D: tuple[np.ndarray, ...]   # m, rK, rcp, act             each (ND, 128)
    corr_idx: np.ndarray        # (1, CC) int32 global word index (-1 pad)
    corr_mask: np.ndarray       # (1, CC) uint32
    flat_idx: np.ndarray        # (1, FC) int32 word index of flat clears (0 pad)
    flat_mask: np.ndarray       # (1, FC) uint32 bits to clear (0 pad = inert)
    pair_mask: int


def _group_arrays(m: np.ndarray, r: np.ndarray, Wpad: int, pad_to: int,
                  two_level: bool, pad_m: int = 3) -> tuple[np.ndarray, ...]:
    """Per-spec constants, padded with inert entries (act = 0)."""
    S = m.size
    P = max(pad_to, -(-S // pad_to) * pad_to)
    K = -(-32 * Wpad // np.maximum(m, 1))
    rK = r + K * m
    out_m = np.full(P, pad_m, np.int32)
    out_rK = np.zeros(P, np.int32)
    out_m[:S] = m
    out_rK[:S] = rK
    act = np.zeros(P, np.uint32)
    act[:S] = 0xFFFFFFFF
    rcp = (1.0 / out_m.astype(np.float64)).astype(np.float32)
    if two_level:
        M1 = (out_m.astype(np.int64) << 10).astype(np.int32)
        rcp1 = (1.0 / (out_m.astype(np.float64) * 1024.0)).astype(np.float32)
        arrs = (out_m, out_rK, M1, rcp1, rcp, act)
    else:
        arrs = (out_m, out_rK, rcp, act)
    return tuple(a.reshape(1, -1) for a in arrs)


def _group_d_arrays(m: np.ndarray, r: np.ndarray, Wpad: int) -> tuple[np.ndarray, ...]:
    """Group-D spec table, (ND, 128)-shaped, sorted by m."""
    arrs = _group_arrays(m, r, Wpad, D_LANES, two_level=False, pad_m=1 << 29)
    return tuple(a.reshape(-1, D_LANES) for a in arrs)


def _padded_words(nbits: int) -> int:
    W = -(-nbits // 32)
    return -(-(W + 1) // TILE_WORDS) * TILE_WORDS


def _corrections_padded(packing, lo, hi, seeds) -> tuple[np.ndarray, np.ndarray]:
    ci, cm = _corrections(packing, lo, hi, seeds, pad_to=32)
    ci_pad = np.full(ci.size, -1, np.int32)
    real = cm != 0
    ci_pad[real] = ci[real].astype(np.int32)
    return ci_pad.reshape(1, -1), cm.reshape(1, -1)


def prepare_cuda(
    packing: str, lo: int, hi: int, seeds: np.ndarray,
    wpad: int | None = None, pair_gap: int = 2,
) -> CudaSegment:
    """Host prep for one segment, from scratch. ``wpad`` overrides the
    word padding with a larger common value (the rK offsets bake in the
    padding, so it must be fixed before grouping)."""
    layout = get_layout(packing)
    nbits = layout.nbits(lo, hi)
    Wpad = _padded_words(nbits)
    if wpad is not None:
        if wpad < Wpad or wpad % TILE_WORDS:
            raise ValueError(f"wpad {wpad} < segment's {Wpad} or unaligned")
        Wpad = wpad
    if 32 * Wpad >= MAX_BITS:
        raise ValueError(f"segment too large for the fused kernel: {nbits} bits")
    # start-free residue-class specs for ALL seed primes
    m, r = tier1_specs(packing, lo, seeds, tier1_max=1 << 62)
    m = m.astype(np.int64)
    r = r.astype(np.int64)
    d_min = max(D_MIN, 4096)  # a D stride must exceed one 4096-bit tile row
    f_min = _flat_cutoff(Wpad)
    ga = m < 32
    gb = (m >= 32) & (m <= B_MAX)
    gc = (m > B_MAX) & (m <= d_min)
    # a group-D spec whose first hit is at or past nbits crosses only the
    # masked padding: prune it, so the D table holds live specs only
    gd = (m > d_min) & (m < f_min) & (r < nbits)
    gf = m >= f_min
    if np.count_nonzero(ga) > NA_PAD:
        raise ValueError("group A overflow")
    fi, fm = flat_crossings(m[gf], r[gf], nbits)
    ci, cm = _corrections_padded(packing, lo, hi, seeds)
    return CudaSegment(
        nbits=nbits,
        Wpad=Wpad,
        A=_group_arrays(m[ga], r[ga], Wpad, NA_PAD, two_level=True),
        B=_group_arrays(m[gb], r[gb], Wpad, 128, two_level=True),
        C=_group_arrays(m[gc], r[gc], Wpad, 128, two_level=False),
        D=_group_d_arrays(m[gd], r[gd], Wpad),
        corr_idx=ci,
        corr_mask=cm,
        flat_idx=fi.reshape(1, -1),
        flat_mask=fm.reshape(1, -1),
        pair_mask=_pair_mask(packing, lo, pair_gap),
    )


class CudaChain:
    """Incremental ``prepare_cuda`` over a chain of segments sharing one
    padded width.

    Group membership depends only on the strides m, so the grouped tables
    are built once; per segment only the residues advance —
    ``r' = (r - delta) mod m`` via DeltaModCache, no per-seed division —
    and the residue-dependent pieces are rebuilt: the rK columns, the
    group-D pruning, the flat crossings, the corrections and the pair
    mask. Output equals from-scratch ``prepare_cuda(..., wpad)``.

    ``phase_seconds`` accumulates host time per phase (residue / group /
    flat / corrections).
    """

    def __init__(self, packing: str, seeds: np.ndarray, wpad: int,
                 pair_gap: int = 2):
        if wpad % TILE_WORDS:
            raise ValueError(f"wpad {wpad} not a multiple of {TILE_WORDS}")
        if 32 * wpad >= MAX_BITS:
            raise ValueError(f"wpad {wpad} too large for the fused kernel")
        self.packing = packing
        self.seeds = seeds
        self.Wpad = wpad
        self.pair_gap = pair_gap
        self.layout = get_layout(packing)
        self.phase_seconds = {
            "residue": 0.0, "group": 0.0, "flat": 0.0, "corrections": 0.0,
        }
        self.segments_prepared = 0
        m = _tier1_strides(packing, seeds, 1 << 62)
        self._m = m
        d_min = max(D_MIN, 4096)
        f_min = _flat_cutoff(wpad)
        ga = m < 32
        gb = (m >= 32) & (m <= B_MAX)
        gc = (m > B_MAX) & (m <= d_min)
        self._gd = (m > d_min) & (m < f_min)
        self._gf = m >= f_min
        if np.count_nonzero(ga) > NA_PAD:
            raise ValueError("group A overflow")
        self._groups = []
        for g, pad, two in ((ga, NA_PAD, True), (gb, 128, True), (gc, 128, False)):
            S = int(np.count_nonzero(g))
            arrs = _group_arrays(m[g], np.zeros(S, np.int64), wpad, pad,
                                 two_level=two)
            # rK of the zero-residue base IS K*m for the real entries
            self._groups.append({"arrs": arrs, "Km": arrs[1][0, :S].astype(np.int64),
                                 "S": S, "mask": g})
        md = m[self._gd]
        self._d_m = md
        self._d_Km = -(-32 * wpad // np.maximum(md, 1)) * md
        self._d_rcp = (1.0 / md.astype(np.float64)).astype(np.float32)
        self._f_m = m[self._gf]
        self._dm = DeltaModCache(m)
        self._r: np.ndarray | None = None
        self._g0: int | None = None

    def _residues(self, lo: int) -> np.ndarray:
        g0 = self.layout.gidx(self.layout.first_candidate(lo))
        if self._r is None:
            m, r = tier1_specs(self.packing, lo, self.seeds, tier1_max=1 << 62)
            if m.shape != self._m.shape:
                raise ValueError("seed set changed under the chain")
            self._r = r.astype(np.int64)
        else:
            self._r = self._dm.advance(self._r, g0 - self._g0)
        self._g0 = g0
        return self._r

    @staticmethod
    def _with_residue(g: dict, r_g: np.ndarray) -> tuple[np.ndarray, ...]:
        arrs = list(g["arrs"])
        rK = arrs[1].copy()
        if g["S"]:
            rK[0, : g["S"]] = g["Km"] + r_g
        arrs[1] = rK
        return tuple(arrs)

    def prepare(self, lo: int, hi: int) -> CudaSegment:
        nbits = self.layout.nbits(lo, hi)
        if self.Wpad < _padded_words(nbits):
            raise ValueError(f"wpad {self.Wpad} < segment's {_padded_words(nbits)}")
        t0 = time.perf_counter()
        r = self._residues(lo)
        t1 = time.perf_counter()
        A, B, C = (self._with_residue(g, r[g["mask"]]) for g in self._groups)
        r_d = r[self._gd]
        sel = r_d < nbits  # zero-crossing pruning (see prepare_cuda)
        S = int(np.count_nonzero(sel))
        P = max(D_LANES, -(-S // D_LANES) * D_LANES)
        out_m = np.full(P, 1 << 29, np.int32)
        out_rK = np.zeros(P, np.int32)
        rcp = np.full(P, np.float32(1.0 / (1 << 29)), np.float32)
        act = np.zeros(P, np.uint32)
        out_m[:S] = self._d_m[sel]
        out_rK[:S] = self._d_Km[sel] + r_d[sel]
        rcp[:S] = self._d_rcp[sel]
        act[:S] = 0xFFFFFFFF
        D = tuple(a.reshape(-1, D_LANES) for a in (out_m, out_rK, rcp, act))
        t2 = time.perf_counter()
        fi, fm = flat_crossings(self._f_m, r[self._gf], nbits)
        t3 = time.perf_counter()
        ci, cm = _corrections_padded(self.packing, lo, hi, self.seeds)
        pair_mask = _pair_mask(self.packing, lo, self.pair_gap)
        t4 = time.perf_counter()
        ph = self.phase_seconds
        ph["residue"] += t1 - t0
        ph["group"] += t2 - t1
        ph["flat"] += t3 - t2
        ph["corrections"] += t4 - t3
        self.segments_prepared += 1
        return CudaSegment(
            nbits=nbits,
            Wpad=self.Wpad,
            A=A,
            B=B,
            C=C,
            D=D,
            corr_idx=ci,
            corr_mask=cm,
            flat_idx=fi.reshape(1, -1),
            flat_mask=fm.reshape(1, -1),
            pair_mask=pair_mask,
        )


def spec_counts(seg: CudaSegment) -> dict:
    """Real (unpadded) per-group spec counts of one prepared segment
    (group D counts live specs after pruning; flat counts merged
    crossing words)."""
    return {
        "A": int((seg.A[5] != 0).sum()),
        "B": int((seg.B[5] != 0).sum()),
        "C": int((seg.C[3] != 0).sum()),
        "D": int((seg.D[3] != 0).sum()),
        "flat_words": int((seg.flat_mask != 0).sum()),
        "corr_words": int((seg.corr_mask != 0).sum()),
    }


def tile_offsets(idx: np.ndarray, mask: np.ndarray, Wpad: int) -> np.ndarray:
    """Per-tile cursors into a word-sorted (idx, mask) crossing list:
    entries [off[0, t], off[0, t+1]) are exactly those whose global word
    index falls inside tile t. The padding entries (appended past the real
    ones) are never visited."""
    G = Wpad // TILE_WORDS
    flat = np.asarray(idx).reshape(-1)
    n_real = int(np.count_nonzero(np.asarray(mask).reshape(-1)))
    real = flat[:n_real].astype(np.int64)
    bounds = np.arange(G + 1, dtype=np.int64) * TILE_WORDS
    return np.searchsorted(real, bounds, side="left").astype(
        np.int32).reshape(1, -1)


def fused_args(seg: CudaSegment) -> tuple:
    """The fused kernel's 28 host inputs, in the reference's order: the
    A, B, C, D tables, the correction and flat lists, their per-tile
    cursors, nbits and the pair mask."""
    return (
        tuple(seg.A) + tuple(seg.B) + tuple(seg.C) + tuple(seg.D) + (
            seg.corr_idx, seg.corr_mask, seg.flat_idx, seg.flat_mask,
            tile_offsets(seg.corr_idx, seg.corr_mask, seg.Wpad),
            tile_offsets(seg.flat_idx, seg.flat_mask, seg.Wpad),
            np.full((1, 1), seg.nbits, np.int32),
            np.full((1, 1), seg.pair_mask, np.uint32),
        )
    )


# ---------------------------------------------------------------------------
# The kernel's inputs on a device, the wrapper, and the plain version.
# ---------------------------------------------------------------------------

# (name, position in fused_args) of every array the kernel reads; the TPU's
# reciprocal columns are not among them
_KERNEL_ARRAYS = (
    ("a_m", 0), ("a_rk", 1), ("a_act", 5),
    ("b_m", 6), ("b_rk", 7), ("b_act", 11),
    ("c_m", 12), ("c_rk", 13), ("c_act", 15),
    ("d_m", 16), ("d_rk", 17), ("d_act", 19),
    ("corr_idx", 20), ("corr_mask", 21), ("flat_idx", 22), ("flat_mask", 23),
    ("coff", 24), ("foff", 25),
)


@dataclasses.dataclass(frozen=True)
class FusedInputs:
    """Every array the kernel reads, packed into one int32 buffer on one
    device (a single host-to-device copy per segment); uint32 arrays ride
    bit for bit as int32."""

    buf: torch.Tensor
    spans: dict                 # name -> (offset, length) into buf
    nbits: int
    Wpad: int
    pair_mask: int

    @property
    def device(self) -> torch.device:
        return self.buf.device

    def part(self, name: str) -> torch.Tensor:
        off, n = self.spans[name]
        return self.buf[off : off + n]


def fused_inputs(seg: CudaSegment, device) -> FusedInputs:
    """Move one segment's kernel inputs to ``device``."""
    if seg.Wpad % TILE_WORDS or 32 * seg.Wpad >= MAX_BITS:
        raise ValueError(f"Wpad {seg.Wpad} not a tile multiple below 2^25 words")
    if seg.A[0].shape != (1, NA_PAD):
        raise ValueError(f"group A must have {NA_PAD} slots")
    args = fused_args(seg)
    parts, spans, off = [], {}, 0
    for name, i in _KERNEL_ARRAYS:
        a = np.ascontiguousarray(args[i]).reshape(-1).view(np.int32)
        spans[name] = (off, a.size)
        parts.append(a)
        off += a.size
    host = torch.from_numpy(np.concatenate(parts))
    if torch.device(device).type == "cuda":
        # pinned, so the copy is queued on the stream and the host goes on
        host = host.pin_memory()
    return FusedInputs(
        buf=host.to(device, non_blocking=True),
        spans=spans,
        nbits=seg.nbits,
        Wpad=seg.Wpad,
        pair_mask=seg.pair_mask,
    )


def _as_u32(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint32)


def mark_fused(seg: CudaSegment, twin_kind: int, need_bits: bool = False,
               device="cuda"):
    """Run the fused mark+reduce kernel on one prepared segment; returns
    (count, pairs, first_word, last_word) — and with ``need_bits`` also
    the final word array, shape (Wpad//128, 128) uint32, with the flat
    clears, corrections and validity mask applied.

    On a CUDA device this launches csrc/fused_mark.cu (built on first
    use) and adds one to ``mark_fused.launches``; the inputs go to the
    card in one copy and one uint32[4] comes back. On the CPU it runs the
    plain version."""
    x = fused_inputs(seg, device)
    if x.device.type == "cpu":
        return _fused_plain(x, twin_kind, need_bits)
    if x.device.type != "cuda":
        raise ValueError(f"mark_fused: unsupported device {x.device}")
    return _fused_launch(x, twin_kind, need_bits)


mark_fused.launches = 0


def mark_fused_reference(seg: CudaSegment, twin_kind: int,
                         need_bits: bool = False, device="cpu",
                         chunk_words: int = 1 << 20):
    """The plain PyTorch version of ``mark_fused``: same inputs, same
    outputs, on any device."""
    return _fused_plain(fused_inputs(seg, device), twin_kind, need_bits,
                        chunk_words)


def launch_fused(x: FusedInputs, twin_kind: int, need_bits: bool = False):
    """Launch the kernel on inputs already on the card, on the current
    stream, without waiting: returns the int32[4] result tensor (uint32
    bits: count, pairs, first_word, last_word) and the int32 word tensor
    (or None). Each launch adds one to ``mark_fused.launches`` and to the
    registry counter ``kernel.mark_fused.launches``."""
    from sieve_torch.kernels import build

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"launch_fused: inputs on {dev}, not a CUDA device")
    lib = build.load()
    G = x.Wpad // TILE_WORDS
    partials = torch.empty(8 * G, dtype=torch.int32, device=dev)
    result = torch.empty(4, dtype=torch.int32, device=dev)
    words = (torch.empty(x.Wpad, dtype=torch.int32, device=dev)
             if need_bits else None)
    ptr = {name: x.part(name).data_ptr() for name, _ in _KERNEL_ARRAYS}
    with torch.cuda.device(dev):
        err = lib.sieve_fused_mark(
            ptr["a_m"], ptr["a_rk"], ptr["a_act"],
            ptr["b_m"], ptr["b_rk"], ptr["b_act"], x.spans["b_m"][1],
            ptr["c_m"], ptr["c_rk"], ptr["c_act"], x.spans["c_m"][1],
            ptr["d_m"], ptr["d_rk"], ptr["d_act"], x.spans["d_m"][1],
            ptr["corr_idx"], ptr["corr_mask"], ptr["coff"],
            ptr["flat_idx"], ptr["flat_mask"], ptr["foff"],
            G, x.nbits, x.pair_mask, PAIR_SHIFT.get(twin_kind, 0),
            words.data_ptr() if words is not None else None,
            partials.data_ptr(), result.data_ptr(),
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_mark launch failed: {lib.sieve_cuda_error_string(err).decode()}"
        )
    mark_fused.launches += 1
    # mirrored into the registry, which a cluster worker ships to its
    # coordinator with its telemetry
    registry().counter("kernel.mark_fused.launches").inc()
    return result, words


def _fused_launch(x: FusedInputs, twin_kind: int, need_bits: bool):
    result, words = launch_fused(x, twin_kind, need_bits)
    res = tuple(int(v) for v in _as_u32(result))  # the one device->host fetch
    if need_bits:
        return res, _as_u32(words).reshape(-1, 128)
    return res


def fused_reduce(x: FusedInputs, twin_kind: int) -> torch.Tensor:
    """(count, pairs, first_word, last_word) of one segment by the fused
    kernel, as an int64[4] of uint32 values left on x's device (no
    fetch); the plain version on the CPU."""
    if x.device.type == "cpu":
        return torch.tensor(_fused_plain(x, twin_kind, False), dtype=torch.int64)
    result, _ = launch_fused(x, twin_kind)
    return result.to(torch.int64) & _U32


# --- the split kernel -----------------------------------------------------------

# the split kernel reads the group tables only
_SPLIT_ARRAYS = _KERNEL_ARRAYS[:12]


def launch_split(x: FusedInputs) -> torch.Tensor:
    """Launch the split marking kernel on inputs already on the card, on
    the current stream, without waiting: returns the int32 tensor of the
    Wpad raw words (uint32 bits). Each launch adds one to
    ``mark_split.launches`` and to ``kernel.mark_split.launches``."""
    from sieve_torch.kernels import build

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"launch_split: inputs on {dev}, not a CUDA device")
    lib = build.load()
    words = torch.empty(x.Wpad, dtype=torch.int32, device=dev)
    ptr = {name: x.part(name).data_ptr() for name, _ in _SPLIT_ARRAYS}
    with torch.cuda.device(dev):
        err = lib.sieve_split_mark(
            ptr["a_m"], ptr["a_rk"], ptr["a_act"],
            ptr["b_m"], ptr["b_rk"], ptr["b_act"], x.spans["b_m"][1],
            ptr["c_m"], ptr["c_rk"], ptr["c_act"], x.spans["c_m"][1],
            ptr["d_m"], ptr["d_rk"], ptr["d_act"], x.spans["d_m"][1],
            x.Wpad // TILE_WORDS, words.data_ptr(),
            dev.index, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"split_mark launch failed: {lib.sieve_cuda_error_string(err).decode()}"
        )
    mark_split.launches += 1
    registry().counter("kernel.mark_split.launches").inc()
    return words


def _split_words(x: FusedInputs) -> torch.Tensor:
    if x.device.type == "cpu":
        return _split_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"mark_split: unsupported device {x.device}")
    return launch_split(x)


def mark_split(seg: CudaSegment, device="cuda") -> torch.Tensor:
    """The split kernel's raw words of one prepared segment: an int32
    tensor of Wpad words (uint32 bits) on ``device``, every live A-D spec
    applied to every word, padding past nbits included; no flat clears,
    no corrections, no mask. On a CUDA device this launches the kernel
    (``mark_split.launches``); on the CPU it runs the plain version."""
    return _split_words(fused_inputs(seg, device))


mark_split.launches = 0


def mark_split_reference(seg: CudaSegment, device="cpu",
                         chunk_words: int = 1 << 20) -> torch.Tensor:
    """The plain PyTorch version of ``mark_split``: same inputs, same
    words, on any device."""
    return _split_plain(fused_inputs(seg, device), chunk_words)


def split_reduce(x: FusedInputs, twin_kind: int) -> torch.Tensor:
    """The split kernel plus its postlude on one segment: (count, pairs,
    first_word, last_word) as an int64[4] of uint32 values left on x's
    device (no fetch)."""
    words = _split_words(x)
    ci, cm = (x.part("corr_idx").to(torch.int64),
              x.part("corr_mask").to(torch.int64) & _U32)
    fi, fm = (x.part("flat_idx").to(torch.int64),
              x.part("flat_mask").to(torch.int64) & _U32)
    return pack4(*_postlude(words, x.nbits, x.pair_mask, ci, cm, twin_kind,
                            fi, fm))


def mark_cuda_split(seg: CudaSegment, twin_kind: int, device="cuda"):
    """The split kernel and the postlude on one prepared segment; returns
    (count, pairs, first_word, last_word), one device-to-host fetch. The
    counterpart of the reference's mark_pallas_split."""
    x = fused_inputs(seg, device)
    return tuple(int(v) for v in split_reduce(x, twin_kind).cpu().tolist())


def warm(devices) -> None:
    """Load the kernel library and the kernels on each CUDA device of
    ``devices`` without launching anything (a no-op for the CPU): the
    one-time work of a process's first launch, done where it can overlap
    host work. A failure raises."""
    from sieve_torch.kernels import build

    for dev in {torch.device(d) for d in devices}:
        if dev.type != "cuda":
            continue
        lib = build.load()
        err = lib.sieve_warm(dev.index if dev.index is not None else 0)
        if err != 0:
            raise RuntimeError(
                f"loading the kernels failed: {lib.sieve_cuda_error_string(err).decode()}")


def fused_enabled() -> bool:
    """Fused in-kernel reduction is the default; SIEVE_PALLAS_FUSED=0
    selects the split kernel + postlude, from the env var or else the
    tuned file. Read per call, as the reference's pallas_fused_enabled is,
    so tests and dry runs can flip it."""
    v = env.env_str("SIEVE_PALLAS_FUSED")
    if v is None:
        v = str(_TUNED.get("SIEVE_PALLAS_FUSED", "1"))
    return v != "0"


def mark_cuda(seg: CudaSegment, twin_kind: int, device="cuda"):
    """Segment entry point, the reference's mark_pallas: the fused kernel
    by default, SIEVE_PALLAS_FUSED=0 for the split kernel + postlude. Both
    return the same (count, pairs, first_word, last_word)."""
    if fused_enabled():
        return mark_fused(seg, twin_kind, device=device)
    return mark_cuda_split(seg, twin_kind, device=device)


# --- plain version -----------------------------------------------------------


def _splice(words: torch.Tensor, nxt: torch.Tensor, shift: int) -> torch.Tensor:
    """words[w] >> shift with the low `shift` bits of nxt[w] spliced in at
    the top — pairs bit j of word w with flag bit 32w+j+shift."""
    low = (1 << shift) - 1
    return (words >> shift) | ((nxt & low) << (32 - shift))


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """bool flags -> 32-bit words in int64, bit k of word w = flag[32w+k]."""
    dev = bits.device
    byte = (bits.view(-1, 4, 8).to(torch.uint8)
            << torch.arange(8, dtype=torch.uint8, device=dev)).sum(-1, dtype=torch.uint8)
    return (byte.to(torch.int64) << torch.arange(0, 32, 8, device=dev)).sum(-1)


def _live_specs(x: FusedInputs) -> list[tuple[int, int]]:
    """(m, r) of every active spec of groups A-D, r = rK mod m."""
    out = []
    for g in ("a", "b", "c", "d"):
        m = x.part(f"{g}_m").cpu().numpy().astype(np.int64)
        rk = x.part(f"{g}_rk").cpu().numpy().astype(np.int64)
        act = x.part(f"{g}_act").cpu().numpy() != 0
        out += list(zip(m[act].tolist(), (rk[act] % m[act]).tolist()))
    return out


def _mark_words(specs, w0: int, w1: int, dev) -> torch.Tensor:
    """Words [w0, w1) after every live spec: clear every bit b with
    b % m == r (strided slice assignment on a bool array), packed to words
    carried in int64."""
    bits = torch.ones(32 * (w1 - w0), dtype=torch.bool, device=dev)
    b0 = 32 * w0
    for m, r in specs:
        bits[(r - b0) % m :: m] = False
    return _pack(bits)


def _split_plain(x: FusedInputs, chunk_words: int = 1 << 20) -> torch.Tensor:
    """Chunk by chunk of words, the raw marked words as int32 (uint32
    bits), padding past nbits included."""
    specs = _live_specs(x)
    out = torch.empty(x.Wpad, dtype=torch.int32, device=x.device)
    for w0 in range(0, x.Wpad, chunk_words):
        w1 = min(w0 + chunk_words, x.Wpad)
        words = _mark_words(specs, w0, w1, x.device)
        out[w0:w1] = torch.where(words > 0x7FFFFFFF, words - (1 << 32), words)
    return out


def _patch_list(x: FusedInputs, idx: str, mask: str):
    m = x.part(mask).to(torch.int64) & _U32
    live = m != 0
    return x.part(idx).to(torch.int64)[live], m[live]


def _fused_plain(x: FusedInputs, twin_kind: int, need_bits: bool,
                 chunk_words: int = 1 << 20):
    """Chunk by chunk of words: mark (``_mark_words``), apply the flat
    clears, the corrections and the validity mask, then count bits and
    pairs (SWAR popcount) and pick the boundary words."""
    dev = x.device
    nbits, Wpad = x.nbits, x.Wpad
    shift = PAIR_SHIFT.get(twin_kind, 0)
    pmask = x.pair_mask
    specs = _live_specs(x)
    fi, fm = _patch_list(x, "flat_idx", "flat_mask")
    ci, cm = _patch_list(x, "corr_idx", "corr_mask")
    off = nbits - 32
    wl, sh = off // 32, off % 32  # floor semantics, as the reference
    count = pairs = 0
    first = None
    prev_last = None
    boundary = {wl: 0, wl + 1: 0}
    kept = []
    for w0 in range(0, Wpad, chunk_words):
        w1 = min(w0 + chunk_words, Wpad)
        words = _mark_words(specs, w0, w1, dev)
        sel = (fi >= w0) & (fi < w1)
        loc = fi[sel] - w0
        words[loc] = words[loc] & (~fm[sel] & _U32)
        sel = (ci >= w0) & (ci < w1)
        loc = ci[sel] - w0
        words[loc] = words[loc] | cm[sel]
        valid = (nbits - 32 * torch.arange(w0, w1, device=dev)).clamp(0, 32)
        part = (torch.ones_like(valid) << valid.clamp(max=31)) - 1
        words = words & torch.where(valid >= 32, _U32, part)
        count += int(popcount(words).sum())
        if shift:
            if prev_last is not None:
                pairs += int(popcount(prev_last & _splice(prev_last, words[:1], shift)
                                       & pmask).sum())
            adj = words[:-1] & _splice(words[:-1], words[1:], shift) & pmask
            pairs += int(popcount(adj).sum())
            prev_last = words[-1:]
        if first is None:
            first = int(words[0])
        for w in boundary:
            if w0 <= w < w1:
                boundary[w] = int(words[w - w0])
        if need_bits:
            kept.append(words.cpu())
    if shift:  # the last word's right neighbour lies past the array: zero
        pairs += int(popcount(prev_last & _splice(prev_last, prev_last * 0, shift)
                               & pmask).sum())
    last = ((boundary[wl] >> sh) | (0 if sh == 0 else boundary[wl + 1] << (32 - sh))) & _U32
    res = (count & _U32, pairs & _U32, first, last)
    if need_bits:
        return res, torch.cat(kept).numpy().astype(np.uint32).reshape(-1, 128)
    return res
