"""The ``SieveWorker`` plugin boundary — the backend-selection seam.

Every backend implements ``process_segment(lo, hi, seed_primes) ->
SegmentResult`` with the reference's signature and result fields, so a
port backend and a reference backend given the same segment must return
equal results (all fields but ``elapsed_s``).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    from sieve_torch.config import SieveConfig


@dataclasses.dataclass
class SegmentResult:
    """Per-segment output merged by the coordinator.

    ``count`` includes the layout's extra primes (2 / 2,3,5) when they fall
    in [lo, hi). ``twin_count`` counts pairs (v, v+gap) with both members
    in [lo, hi); pairs straddling a segment boundary are reconstructed at
    merge time from the boundary bitwords (sieve_torch/twins.py).
    """

    seg_id: int
    lo: int
    hi: int
    count: int
    twin_count: int
    first_word: int  # first min(32, nbits) flag bits; bit k = flag[k]
    last_word: int   # bit k = flag[nbits-32+k] (== first_word when nbits <= 32)
    nbits: int
    elapsed_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SegmentResult":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)})

    def is_sane(self) -> bool:
        """Structural validity, used by the ledger's corrupt-file salvage
        path: an entry that parses but violates these bounds is damage,
        not a result (sieve_torch/checkpoint.py)."""
        ints = (
            self.seg_id, self.lo, self.hi, self.count, self.twin_count,
            self.first_word, self.last_word, self.nbits,
        )
        if not all(isinstance(v, int) for v in ints):
            return False
        return (
            self.seg_id >= 0
            and 2 <= self.lo < self.hi
            and self.nbits > 0
            and 0 <= self.count <= self.hi - self.lo
            and 0 <= self.twin_count <= self.hi - self.lo
            and self.first_word >= 0
            and self.last_word >= 0
            and isinstance(self.elapsed_s, (int, float))
            and self.elapsed_s >= 0
        )


class SieveWorker(abc.ABC):
    """A backend that sieves one segment at a time.

    Contract: given [lo, hi) and the host-computed seed primes (all primes
    <= isqrt(n), including 2/3/5 — the backend filters per packing), return
    the SegmentResult for the configured packing. Must be deterministic and
    idempotent: re-processing a segment yields an identical result.
    """

    name: str = ""

    def __init__(self, config: "SieveConfig"):
        self.config = config
        # host-prepare phase totals (seconds) of backends that prepare
        # incrementally; the coordinator reports them in host_phases
        self.phase_seconds: dict[str, float] = {}

    @abc.abstractmethod
    def process_segment(
        self, lo: int, hi: int, seed_primes: np.ndarray, seg_id: int = 0
    ) -> SegmentResult:
        ...

    def close(self) -> None:
        """Release backend resources (device buffers)."""
