"""The word kernel: tiered marking over packed words.

The counterpart of the reference's ``mark_words`` (sieve/kernels/jax_mark.py),
which is XLA there, not Pallas; here it is plain torch ops, so the same
code runs on the CPU and, on the card, on the card's tensors. Bit k of
word w is flag 32w+k.

  Tier 1 — strides m <= TIER1_MAX: the marking pattern of spec (m, r) is
  periodic with period lcm(m, 32)/32 words. The host builds each pattern
  with the segment's phase baked in (kernels/specs.py); here it is tiled
  to the segment's length and ANDed out.

  Tier 2 — strides m > TIER1_MAX: spec (m, r) clears the bits r + m*j of
  its row, at most one a word. The reference is scatter-free: it takes
  t = (r - 32w) mod m over every word for every spec, since the TPU's
  scatters are slow and XLA wants dense, static shapes; at n=1e9 that is
  119 elements for each bit it clears. The card scatters well, so here
  only the hits are written (``_tier2_plan``, ``_mark_tier2``). The host
  counts each spec's hits, ceil((32*Wpad - r) / m), and lays them out
  window by window of the row, the specs grouped by their most hits in a
  window. The card lists each group's bit indices with one ``addcmul``,
  sets them in a byte per flag with ``index_fill_`` (duplicate hits write
  the same byte, so no atomics and no order), and packs the bytes into
  words that are ANDed out (``_pack``). A window's flag bytes stay in the
  card's L2 cache while its hits are set. Every size is known on the
  host, so nothing waits for the card. The words are the dense formula's,
  bit for bit. ``K2`` and ``rcp2``, the reference's reciprocal mod, stay
  in the tables and are not read; SPEC_BLOCK only buckets the tables'
  length.

Both tiers ignore the "start at p^2" bound; the self-mark corrections
re-set the seed primes' own bits. The tail (corrections, validity mask,
popcount, pair splice, boundary words) is the split postlude's
``reduce.reduce_packed``.

The three stages are device spans (``trace.device_span``): ``words.tier1``
(the fill and the pattern ANDs), ``words.tier2`` (the table upload, the
marking and the packing; args ``hits`` and ``chunks``) and
``words.tail``; they cost nothing with capture off. On a card each call
adds its tier-2 hits to the registry counter
``kernel.mark_words.tier2_hits``.

Words are marked as int32 holding uint32 bits (bitwise ops do not care
about the sign; the card moves half the bytes of int64) and handed to the
tail as int64 holding 0 .. 2^32-1, as reduce.py carries them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sieve_torch import env, trace
from sieve_torch.kernels.reduce import _U32, pack4, reduce_packed
from sieve_torch.metrics import registry

# Specs with m <= TIER1_MAX become periodic word patterns; SPEC_BLOCK
# buckets the tier-2 tables' length. The knobs are the reference's.
TIER1_MAX = env.env_int("SIEVE_TIER1_MAX", 64)
SPEC_BLOCK = env.env_int("SIEVE_SPEC_BLOCK", 16)
WORD_BUCKET = 8192    # word-count padding granularity
# Tier-2 hits listed at a time: an int64 index each, 2 GiB on the card,
# so a 1e9-value segment takes two chunks and ~40 launches.
TIER2_CHUNK = 1 << 28
# Tier-2 bits whose hits are set together: 16 MiB of flag bytes, which the
# card's 50 MB L2 cache holds while they are written.
TIER2_WINDOW = 1 << 24
# x * _GATHER8 gathers bit 0 of each of x's 8 bytes into its top byte,
# byte i's to bit 56 + i; no two partial products meet there, so nothing
# carries into them.
_GATHER8 = 0x0102040810204080


def _i32(a) -> np.ndarray:
    """uint32 (or any 32-bit) table as int32 with the same bits."""
    return np.ascontiguousarray(a).astype(np.uint32).view(np.int32)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def _to(a: np.ndarray, device) -> torch.Tensor:
    """A host table on ``device``; to a card from pinned memory, so the
    copy is queued instead of waiting for the stream's earlier work."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclasses.dataclass(frozen=True)
class Tier2Plan:
    """Tier 2's hits over a batch, laid out on the host for the card.

    ``table`` is int64 [3, S], per live spec: its first hit as a flat bit
    (row b's bits start at b*row_bits), its stride m, and r. Its first
    hit at or past bit k*window of its row is the k-th of ``windows``
    starts (``_window_starts``); from each it lists ``width`` hits, at
    least its most hits in one window. Those past its window are the next
    window's hits again, those past its row land in the row's pad
    (row_bits >= 32*Wpad). ``groups`` are (width, first column, stop
    column, offset of the group's first element in a window), widest
    first, ``per_window`` elements in all; ``chunks`` are (first window,
    stop window), at most ``chunk`` elements each (or one window, if it
    holds more)."""

    hits: int
    row_bits: int
    window: int
    windows: int
    table: np.ndarray
    per_window: int
    groups: tuple[tuple[int, int, int, int], ...]
    chunks: tuple[tuple[int, int], ...]


def _tier2_plan(L: int, m2, r2, act2, chunk: int) -> Tier2Plan:
    """Tier 2's hits over a batch of rows of L = 32*Wpad bits, on the host.

    A live spec (m, r) of row b (act2 != 0) hits the bits r + m*j < L of
    that row, with r taken mod m: ceil((L - r) / m) of them, the bits the
    dense rule t = (r - 32w) mod m < 32 clears (m > 32). The row is cut
    into windows of TIER2_WINDOW bits (at most 32 * chunk, so a window
    holds at most ``chunk`` hits of a spec), listed window after window,
    so the card sets the hits of one window, whose flag bytes its L2
    cache holds, before it moves on. A spec's width is its most hits in a
    window, rounded up to 2^k or 3 * 2^(k-1) so the specs fall into a few
    groups of one width each."""
    B = np.asarray(m2).shape[0]
    rows, cols = np.nonzero(np.asarray(act2).reshape(B, -1) != 0)
    m = np.asarray(m2, np.int64).reshape(B, -1)[rows, cols]
    r = np.asarray(r2, np.int64).reshape(B, -1)[rows, cols] % m
    cnt = (L - r + m - 1) // m
    live = cnt > 0
    rows, m, r, cnt = rows[live], m[live], r[live], cnt[live]
    window = min(TIER2_WINDOW, 32 << (chunk.bit_length() - 1))
    width = np.minimum(cnt, -(-window // m))
    up = np.left_shift(1, np.frexp((width - 1).astype(np.float64))[1])
    width = np.where(width <= (3 * up) >> 2, (3 * up) >> 2, up)
    order = np.argsort(-width, kind="stable")
    rows, m, r, width = rows[order], m[order], r[order], width[order]
    K = -(-L // window)
    row_bits = 0
    if m.size:   # past the last window's elements, the greatest
        last = np.maximum(0, np.ceil((window * (K - 1) - r) / m)).astype(np.int64)
        row_bits = max(L, -(-int((r + m * (last + width)).max()) // 32) * 32)
    table = np.stack([r + rows * row_bits, m, r])
    groups, col, off = [], 0, 0
    for w in np.unique(width)[::-1].tolist():
        n = int(np.count_nonzero(width == w))
        groups.append((w, col, col + n, off))
        col, off = col + n, off + n * w
    per = max(1, chunk // max(off, 1))
    chunks = tuple((k, min(k + per, K)) for k in range(0, K, per)) if groups else ()
    return Tier2Plan(int(cnt.sum()), row_bits, window, K, table, off, tuple(groups),
                     chunks)


def _window_starts(plan: Tier2Plan, table: torch.Tensor) -> torch.Tensor:
    """Each spec's first hit at or past each window's start, int64 [K, S],
    from ``plan.table`` on its device. ceil((k*window - r) / m) is exact
    in float64: a quotient below 2^31 that is no integer lies 1/m or more
    from one, far beyond its rounding error."""
    first, m, r = table
    k = torch.arange(plan.windows, dtype=torch.float64, device=table.device)
    j = ((plan.window * k[:, None] - r) / m).ceil_().clamp_(min=0)
    return first + m * j.to(torch.int64)


def _pack(flags: torch.Tensor) -> torch.Tensor:
    """uint8 flags (0 or 1), flag 32w+k at byte 32w+k, as int32 words with
    flag 32w+k at bit k of word w. Overwrites ``flags``."""
    flags.view(torch.int64).mul_(_GATHER8)   # little-endian: byte i of 8
    return flags.view(-1, 32)[:, 7::8].contiguous().view(torch.int32).view(-1)


def _mark_tier2(words: torch.Tensor, m2, r2, act2, device,
                chunk: int = TIER2_CHUNK) -> int:
    """Clears tier 2's hits from ``words`` [B, Wpad] in place. Returns the
    hits; on a card they are added to ``kernel.mark_words.tier2_hits``."""
    B, Wpad = words.shape
    plan = _tier2_plan(32 * Wpad, m2, r2, act2, chunk)
    with trace.device_span("words.tier2", device, hits=plan.hits,
                           chunks=len(plan.chunks)):
        if plan.groups:
            table = _to(plan.table, device)
            start, step = _window_starts(plan, table), table[1]
            j = torch.arange(plan.groups[0][0], dtype=torch.int64, device=device)
            flags = torch.zeros(B * plan.row_bits, dtype=torch.uint8, device=device)
            for k0, k1 in plan.chunks:
                idx = torch.empty((k1 - k0, plan.per_window), dtype=torch.int64,
                                  device=device)
                for w, c0, c1, off in plan.groups:
                    out = idx[:, off:off + w * (c1 - c0)].view(k1 - k0, c1 - c0, w)
                    torch.addcmul(start[k0:k1, c0:c1, None], step[c0:c1, None],
                                  j[:w], out=out)
                flags.index_fill_(0, idx.view(-1), 1)
                del idx, out
            words &= ~_pack(flags).view(B, -1)[:, :Wpad]
    if _on_card(device):
        registry().counter("kernel.mark_words.tier2_hits").inc(plan.hits)
    return plan.hits


def _marked_words(Wpad: int, periods: tuple[int, ...], patterns, m2, r2, act2,
                  device, chunk: int = TIER2_CHUNK) -> torch.Tensor:
    """Tiers 1 and 2 over a batch: ``patterns`` is a tuple of [B, period]
    arrays, the tier-2 tables are [B, S2]. Returns int32 words [B, Wpad].
    Padded tier-2 specs (act2 == 0) are inert; without a live spec in any
    row tier 2 is skipped. ``chunk`` bounds the hits listed at a time."""
    B = m2.shape[0]
    with trace.device_span("words.tier1", device):
        words = torch.full((B, Wpad), -1, dtype=torch.int32, device=device)
        for pat, period in zip(patterns, periods):
            pat = _to(_i32(pat).reshape(B, period), device)
            reps = Wpad // period + 1
            words &= ~pat.repeat(1, reps)[:, :Wpad]
    if np.any(np.asarray(act2) != 0):
        _mark_tier2(words, m2, r2, act2, device, chunk)
    return words


def _count(fn, device) -> None:
    if _on_card(device):
        fn.cuda_calls += 1
        # mirrored into the registry a cluster worker ships
        registry().counter(f"kernel.{fn.__name__}.cuda_calls").inc()


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
    with trace.device_span("words.tail", device):
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
    over the whole batch at once, the counterpart of the reference's
    vmap. Each row's tail is its own ``reduce_packed`` call (each row has
    its own nbits). Returns int64 [B, 4] of uint32 values on ``device``. A
    call on a CUDA device adds one to ``mark_words_batch.cuda_calls``."""
    _count(mark_words_batch, device)
    words = _marked_words(Wpad, periods, patterns, m2, r2, act2, device)
    with trace.device_span("words.tail", device, batch=words.shape[0]):
        return torch.stack([
            pack4(*_tail(words[i], int(nbits[i]), twin_kind, int(pair_mask[i]),
                         corr_idx[i], corr_mask[i], device))
            for i in range(words.shape[0])
        ])


mark_words_batch.cuda_calls = 0


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()
