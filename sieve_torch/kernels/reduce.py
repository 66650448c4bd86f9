"""The split path's postlude: patch, mask and reduce a segment's raw words.

The counterpart of the reference's XLA tail (``reduce_packed``,
``_splice_right`` and ``pack4`` in sieve/kernels/jax_mark.py, and
``_postlude`` in sieve/kernels/pallas_mark.py). It is plain torch ops in
the reference too (XLA, not Pallas), so the same code runs on the CPU and
on the card, on whatever device the words lie.

Words ride as int64 holding 0 .. 2^32-1: torch's uint32 has no shifts or
comparisons on the CPU and only partial support on CUDA. Ordering int64
words is the unsigned order of their uint32 bits, which the scatter-min
and scatter-max below rely on.
"""

from __future__ import annotations

import torch

from sieve_torch.kernels.pairs import PAIR_SHIFT, TWIN_NONE

_U32 = 0xFFFFFFFF


def popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words carried in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _splice_right(words: torch.Tensor, shift: int) -> torch.Tensor:
    """words[w] >> shift with the low `shift` bits of words[w+1] spliced in
    at the top — pairs bit j of word w with flag bit 32w+j+shift. The word
    past the end reads as 0."""
    nxt = torch.cat([words[1:], words.new_zeros(1)])
    return (words >> shift) | (((nxt & ((1 << shift) - 1)) << (32 - shift)) & _U32)


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Negative indices count from the end, as jnp indexing normalises
    them: the corrections' -1 padding lands on the last word, where its
    zero mask is inert. torch's scatter rejects negative indices."""
    return torch.where(idx < 0, idx + n, idx)


def reduce_packed(words: torch.Tensor, nbits: int, twin_kind: int,
                  pair_mask: int, corr_idx=None, corr_mask=None,
                  flat_idx=None, flat_mask=None):
    """Flat clears, self-mark corrections, validity mask beyond nbits,
    popcount, pair reduction and boundary words of one segment's flat
    word array (int64 words, padded). Returns (count, pairs, first_word,
    last_word) as 0-d int64 tensors on the words' device.

    Index lists are int64 tensors on the same device; masks are int64
    holding uint32 bits."""
    W = words.shape[0]
    dev = words.device
    # flat clears before the corrections: a flat class can cross its own
    # seed prime's bit, which the correction then re-sets. A scatter-MIN,
    # so the (0, 0) padding colliding with a real word-0 entry resolves to
    # the cleared value.
    if flat_idx is not None and flat_idx.shape[0]:
        fi = _wrap(flat_idx, W)
        cur = words[fi]
        words = words.scatter_reduce(0, fi, cur & (~flat_mask & _U32), "amin")
    if corr_idx is not None and corr_idx.shape[0]:
        ci = _wrap(corr_idx, W)
        cur = words[ci]
        words = words.scatter_reduce(0, ci, cur | corr_mask, "amax")

    w = torch.arange(W, dtype=torch.int64, device=dev)
    valid = (nbits - 32 * w).clamp(0, 32)
    part = (torch.ones_like(valid) << valid.clamp(max=31)) - 1
    words = words & torch.where(valid >= 32, _U32, part)

    count = popcount(words).sum()
    if twin_kind == TWIN_NONE:
        pairs = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        adj = words & _splice_right(words, PAIR_SHIFT[twin_kind]) & pair_mask
        pairs = popcount(adj).sum()

    first_word = words[0]
    off = nbits - 32
    wl, sh = off // 32, off % 32            # floor semantics, as jnp
    wl = min(max(wl, 0), W - 2)             # lax.dynamic_slice clamps its start
    lo, hi = words[wl], words[wl + 1]
    last_word = (lo >> sh) | (0 if sh == 0 else (hi << (32 - sh)) & _U32)
    return count, pairs, first_word, last_word


def pack4(count, pairs, first_word, last_word) -> torch.Tensor:
    """The four per-segment results as ONE int64[4] of uint32 values, so
    the host fetches them in a single device-to-host copy."""
    return torch.stack([count, pairs, first_word, last_word]) & _U32


def _postlude(words, nbits, pair_mask, ci, cm, twin_kind: int,
              fi=None, fm=None):
    """The split kernel's tail on its raw words (any shape, int32 or int64
    holding uint32 bits): flat clears + corrections + reductions."""
    words = words.reshape(-1).to(torch.int64) & _U32
    return reduce_packed(words, nbits, twin_kind, pair_mask, ci, cm, fi, fm)
