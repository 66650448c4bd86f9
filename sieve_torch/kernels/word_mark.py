"""The word kernel: tiered, scatter-free marking over packed words.

The counterpart of the reference's ``mark_words`` (sieve/kernels/jax_mark.py),
which is XLA there, not Pallas; here it is plain torch ops, so the same
code runs on the CPU and, on the card, on the card's tensors. Bit k of
word w is flag 32w+k.

  Tier 1 — strides m <= TIER1_MAX: the marking pattern of spec (m, r) is
  periodic with period lcm(m, 32)/32 words. The host builds each pattern
  with the segment's phase baked in (kernels/specs.py); here it is tiled
  to the segment's length and ANDed out.

  Tier 2 — strides m > TIER1_MAX: each spec hits at most one bit per
  word, bit t = (r - 32w) mod m of word w when t < 32. The reference
  computes the mod with an f32 reciprocal and two fix-ups (the TPU has no
  integer division worth using); ``torch.remainder`` is exact, gives the
  same t and so the same words. A block of SPEC_BLOCK specs is one
  [SPEC_BLOCK, Wpad] broadcast, its hits ORed over the block axis by
  halving. ``K2`` and ``rcp2`` stay in the tables for parity with the
  reference and are not read.

Both tiers ignore the "start at p^2" bound; the self-mark corrections
re-set the seed primes' own bits. The tail (corrections, validity mask,
popcount, pair splice, boundary words) is the split postlude's
``reduce.reduce_packed``.

Words are marked as int32 holding uint32 bits (bitwise ops do not care
about the sign; the card moves half the bytes of int64) and handed to the
tail as int64 holding 0 .. 2^32-1, as reduce.py carries them.
"""

from __future__ import annotations

import numpy as np
import torch

from sieve_torch import env
from sieve_torch.kernels.reduce import _U32, pack4, reduce_packed

# Specs with m <= TIER1_MAX become periodic word patterns; SPEC_BLOCK
# tier-2 specs are marked per broadcast. The knobs are the reference's.
TIER1_MAX = env.env_int("SIEVE_TIER1_MAX", 64)
SPEC_BLOCK = env.env_int("SIEVE_SPEC_BLOCK", 16)
WORD_BUCKET = 8192    # word-count padding granularity


def _i32(a) -> np.ndarray:
    """uint32 (or any 32-bit) table as int32 with the same bits."""
    return np.ascontiguousarray(a).astype(np.uint32).view(np.int32)


def _to(a: np.ndarray, device) -> torch.Tensor:
    """A host table on ``device``; to a card from pinned memory, so the
    copy is queued instead of waiting for the stream's earlier work."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over axis -2 by halving (torch has no OR reduction)."""
    while x.shape[-2] > 1:
        h = x.shape[-2] // 2
        y = x[..., :h, :] | x[..., h : 2 * h, :]
        if x.shape[-2] % 2:
            y[..., :1, :] |= x[..., 2 * h :, :]
        x = y
    return x[..., 0, :]


def _marked_words(Wpad: int, periods: tuple[int, ...], patterns, m2, r2, act2,
                  device) -> torch.Tensor:
    """Tiers 1 and 2 over a batch: ``patterns`` is a tuple of [B, period]
    arrays, the tier-2 tables are [B, S2]. Returns int32 words [B, Wpad].
    Padded tier-2 rows (act2 == 0) are inert: a spec column padded in
    every row is skipped, and in a block where rows differ the act mask
    clears the padded rows' hits."""
    B = m2.shape[0]
    words = torch.full((B, Wpad), -1, dtype=torch.int32, device=device)
    for pat, period in zip(patterns, periods):
        pat = _to(_i32(pat).reshape(B, period), device)
        reps = Wpad // period + 1
        words &= ~pat.repeat(1, reps)[:, :Wpad]

    act = np.asarray(act2).reshape(B, -1) != 0
    keep = np.flatnonzero(act.any(axis=0))  # spec columns live in some row
    if keep.size == 0:
        return words
    act = act[:, keep]
    tables = np.stack([np.asarray(m2).reshape(B, -1)[:, keep],
                       np.asarray(r2).reshape(B, -1)[:, keep], act])
    t_m, t_r, t_a = _to(tables.astype(np.int32), device).unbind(0)
    w32 = 32 * torch.arange(Wpad, dtype=torch.int32, device=device)
    live = keep.size
    for j in range(0, live, SPEC_BLOCK):
        m = t_m[:, j : j + SPEC_BLOCK, None]
        r = t_r[:, j : j + SPEC_BLOCK, None]
        t = torch.remainder(r - w32, m)            # [B, block, Wpad]
        hit = (t < 32).to(torch.int32) << t.clamp(max=31)
        if not act[:, j : j + SPEC_BLOCK].all():
            hit *= t_a[:, j : j + SPEC_BLOCK, None]
        words &= ~_or_rows(hit)
    return words


def _count(fn, device) -> None:
    if torch.device(device).type == "cuda":
        fn.cuda_calls += 1


def mark_words_impl(Wpad: int, twin_kind: int, periods: tuple[int, ...], nbits,
                    patterns, m2, r2, K2, rcp2, act2, corr_idx, corr_mask,
                    pair_mask, device="cpu"):
    """One segment's (count, pairs, first_word, last_word) as 0-d int64
    tensors on ``device``. The tables are the host's numpy arrays of a
    TieredSegment."""
    words = _marked_words(
        Wpad, periods, tuple(np.asarray(p)[None] for p in patterns),
        np.asarray(m2)[None], np.asarray(r2)[None], np.asarray(act2)[None],
        device)[0]
    return _tail(words, int(nbits), twin_kind, int(pair_mask), corr_idx,
                 corr_mask, device)


def _tail(words: torch.Tensor, nbits: int, twin_kind: int, pair_mask: int,
          corr_idx, corr_mask, device):
    ci = _to(np.asarray(corr_idx, np.int64), device)
    cm = _to(np.asarray(corr_mask).astype(np.int64) & _U32, device)
    return reduce_packed(words.to(torch.int64) & _U32, nbits, twin_kind,
                         pair_mask, ci, cm)


def mark_words(Wpad, twin_kind, periods, nbits, patterns, m2, r2, K2, rcp2,
               act2, corr_idx, corr_mask, pair_mask, device="cpu") -> torch.Tensor:
    """One segment as ONE int64[4] of uint32 values on ``device``: count,
    pairs, first32, last32. A call on a CUDA device adds one to
    ``mark_words.cuda_calls``."""
    _count(mark_words, device)
    return pack4(*mark_words_impl(
        Wpad, twin_kind, periods, nbits, patterns, m2, r2, K2, rcp2, act2,
        corr_idx, corr_mask, pair_mask, device))


mark_words.cuda_calls = 0


def mark_words_batch(Wpad, twin_kind, periods, nbits, patterns, m2, r2, K2, rcp2,
                     act2, corr_idx, corr_mask, pair_mask,
                     device="cpu") -> torch.Tensor:
    """Batched ``mark_words``: every table gains a leading batch axis
    (``patterns`` is a tuple of [B, period] arrays) and the marking runs
    as one broadcast over the batch, the counterpart of the reference's
    vmap. Each row's tail is its own ``reduce_packed`` call (each row has
    its own nbits). Returns int64 [B, 4] of uint32 values on ``device``. A
    call on a CUDA device adds one to ``mark_words_batch.cuda_calls``."""
    _count(mark_words_batch, device)
    words = _marked_words(Wpad, periods, patterns, m2, r2, act2, device)
    return torch.stack([
        pack4(*_tail(words[i], int(nbits[i]), twin_kind, int(pair_mask[i]),
                     corr_idx[i], corr_mask[i], device))
        for i in range(words.shape[0])
    ])


mark_words_batch.cuda_calls = 0


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()
