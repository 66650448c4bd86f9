"""Pair-reduction kinds shared by the kernel and its backend.

The reduction counts pairs (bit b, bit b + shift) that are both set and
whose left bit is allowed by the segment's pair mask. The kind selects the
shift for a (packing, gap) combination; the ids are the reference's, so a
kind number means the same splice in both packages.
"""

from __future__ import annotations

TWIN_NONE = 0
TWIN_PLAIN = 1  # pairs (b, b+2): adjacent candidates differ by 1
TWIN_ADJ = 2    # pairs (b, b+1): odds layout, adjacent candidates differ by 2
TWIN_W30 = 3    # pairs (b, b+1) masked to residue indices {2, 4, 7}
COUSIN_PLAIN = 4  # pairs (b, b+4)
COUSIN_ADJ = 5    # pairs (b, b+2): odds layout, candidates differ by 4
COUSIN_W30 = 6    # pairs (b, b+1) masked to residue indices {1, 3, 5}

# How far the word array is spliced right so bit j pairs with the
# candidate `gap` values above it, per pair kind.
PAIR_SHIFT = {
    TWIN_PLAIN: 2, TWIN_ADJ: 1, TWIN_W30: 1,
    COUSIN_PLAIN: 4, COUSIN_ADJ: 2, COUSIN_W30: 1,
}

TWIN_KIND = {"plain": TWIN_PLAIN, "odds": TWIN_ADJ, "wheel30": TWIN_W30}
COUSIN_KIND = {"plain": COUSIN_PLAIN, "odds": COUSIN_ADJ, "wheel30": COUSIN_W30}

# Segments with fewer candidate bits go to the numpy backend: their
# boundary words are a host-side concern, not worth a device launch.
MIN_DEVICE_BITS = 64


def pair_kind(config) -> int:
    """Device pair-reduction kind for a config: TWIN_NONE when no pairs
    are counted, else the (packing, gap)-specific splice kind."""
    gap = getattr(config, "pair_gap", 2 if config.twins else 0)
    if gap == 0:
        return TWIN_NONE
    return (TWIN_KIND if gap == 2 else COUSIN_KIND)[config.packing]
