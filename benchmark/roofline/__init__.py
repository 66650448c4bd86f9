"""The yardstick of the kernels' roofline shares: the work a segment needs
and the least time the card could take for it.

The count is a frozen restatement of ``chip_smoke.py``'s ``_work`` and
``_bound``, taken from the segment's range and its seed primes alone, so
that no table the program builds enters it and any implementation of the
same function (the fused kernel, the word kernel's torch ops, a later
hand kernel) is read against the same work:

- one AND of a repeating pattern per 32-flag word for each odd seed below
  32 whose square lies below the segment's end;
- one clear per odd multiple p*m (m >= p) in the segment of each larger
  odd seed, which is what the inputs need: a kernel that walks further
  (from p itself, or past the end into padding) does more than this;
- per word one population count, and with a pair count two shifts, an OR,
  two ANDs and a second population count;
- the bytes: each seed's stride and residue read once as 32-bit words,
  the four 32-bit results written once.

The least time is the larger of the 32-bit integer operations over their
peak, the population counts over theirs (each at SMs x lanes x the
maximum SM clock), and the bytes over the memory rate, with the card's
published numbers from ``peaks.json``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> dict | None:
    """The published peaks of a card by its torch name, or None."""
    with open(PEAKS) as f:
        return json.load(f).get(device_name)


def segment_work(lo: int, hi: int, seeds: np.ndarray, gap: int) -> dict:
    """Operations and bytes one odds-packed segment [lo, hi) needs."""
    f = max(lo, 3) | 1
    last = hi - 1 if (hi - 1) % 2 else hi - 2
    nbits = (last - f) // 2 + 1 if last >= f else 0
    words = -(-nbits // 32)
    live = seeds[(seeds > 2) & (seeds * seeds < hi)]
    pattern = int(np.count_nonzero(live < 32))
    p = live[live >= 32]
    k0 = -(-np.maximum(p * p, lo) // p)           # first multiplier in range
    k1 = (hi - 1) // p                            # last multiplier in range
    hits = int(np.maximum(0, (k1 + 1) // 2 - k0 // 2).sum())   # odd ones
    pairs = gap > 0
    return {
        "words": words,
        "alu": words * pattern + hits + (5 * words if pairs else 0),
        "popc": words * (2 if pairs else 1),
        "bytes": 8 * int(live.size) + 16,
    }


def bound_s(work: dict, peak: dict) -> float:
    """The least time in seconds for ``work`` on a card with ``peak``."""
    clock = peak["max_sm_mhz"] * 1e6
    alu = peak["sms"] * peak["int32_lanes_per_sm"] * clock
    popc = peak["sms"] * peak["popc_lanes_per_sm"] * clock
    return max(work["alu"] / alu, work["popc"] / popc,
               work["bytes"] / peak["hbm_bytes_per_s"])
