"""Typed run configuration of the PyTorch port.

One frozen dataclass, serializable, everything on the config and nothing
ambient — the shape of ``sieve.config.SieveConfig``. The port adds the
``cuda`` backend (the hand-written Hopper kernel, counterpart of
``tpu-pallas``) and a ``device`` field: entry points run on the card
unless the caller asks for ``device="cpu"``, where the ``cuda`` backend
runs its kernel's plain PyTorch version.

Fields that belong to parts of the system not ported yet are kept so a
config can name them, and are refused with a message naming the slice
that brings them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any

PACKINGS = ("plain", "odds", "wheel30")
BACKENDS = ("cpu-numpy", "cuda")
# --count-kind: which reduction runs on the marked bitset. All kinds share
# the same marking kernel — only the splice shift and pair mask at the
# reduction differ (primes = count only; twins = p, p+2; cousins = p, p+4).
COUNT_KINDS = ("primes", "twins", "cousins")
PAIR_GAPS = {"primes": 0, "twins": 2, "cousins": 4}

# field -> the later slice of the port that brings it
LATER_SLICES = {
    "multihost": "multihost (multi-GPU across hosts, torch.distributed)",
    "chaos": "cluster",
    "chaos_kill": "cluster",
}


@dataclasses.dataclass(frozen=True)
class SieveConfig:
    """Configuration for one sieve run.

    ``n`` is inclusive: the run computes pi(n) (= count of primes in [2, n]).
    Internally every range is half-open [lo, hi) with the global range being
    [2, n + 1).
    """

    n: int
    backend: str = "cuda"
    packing: str = "odds"
    # Segmentation: give either a segment count or a per-segment value span.
    n_segments: int | None = None
    segment_values: int | None = None
    twins: bool = False
    # "primes" (count only), "twins" (p, p+2), "cousins" (p, p+4);
    # ``twins=True`` is the legacy spelling of count_kind="twins".
    count_kind: str = "primes"
    workers: int = 1
    checkpoint_dir: str | None = None
    resume: bool = False
    rounds: int = 1
    quiet: bool = False
    json_output: bool = False
    # torch device of the ``cuda`` backend: "cuda" (the kernel) or "cpu"
    # (its plain version). Left out of config_hash like ``backend``.
    device: str = "cuda"
    multihost: bool = False
    chaos: str | None = None
    chaos_kill: str | None = None

    def __post_init__(self) -> None:
        if self.n < 2:
            raise ValueError(f"n must be >= 2, got {self.n}")
        if self.packing not in PACKINGS:
            raise ValueError(f"packing must be one of {PACKINGS}, got {self.packing!r}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.n_segments is not None and self.n_segments < 1:
            raise ValueError("n_segments must be >= 1")
        if self.segment_values is not None and self.segment_values < 4:
            raise ValueError("segment_values must be >= 4")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.count_kind not in COUNT_KINDS:
            raise ValueError(
                f"count_kind must be one of {COUNT_KINDS}, got "
                f"{self.count_kind!r}"
            )
        for name, slice_name in LATER_SLICES.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"sieve_torch: {name!r} is not ported yet; it comes "
                    f"with the {slice_name} slice"
                )
        if self.count_kind == "primes" and self.twins:
            object.__setattr__(self, "count_kind", "twins")
        elif self.count_kind in ("twins", "cousins") and not self.twins:
            object.__setattr__(self, "twins", True)

    @property
    def pair_gap(self) -> int:
        """Prime-pair difference counted at the reduction (0 = none)."""
        return PAIR_GAPS[self.count_kind]

    @property
    def seed_limit(self) -> int:
        return math.isqrt(self.n)

    def resolved_n_segments(self) -> int:
        """Segment count after resolving n_segments/segment_values defaults."""
        if self.n_segments is not None:
            return self.n_segments
        if self.segment_values is not None:
            span = self.n - 1  # values in [2, n+1)
            return max(1, -(-span // self.segment_values))
        return 1

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SieveConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def config_hash(self) -> str:
        """Stable hash of the result-affecting fields (checkpoint ledger key).

        Byte-identical to the reference's, so a ledger keyed by one package
        is keyed the same by the other. Backend, device, workers and the
        output fields are left out: the math must not change with them.
        """
        payload = {
            "n": self.n,
            "packing": self.packing,
            "n_segments": self.resolved_n_segments(),
            "segment_values": self.segment_values,
            "twins": self.twins,
        }
        if self.count_kind == "cousins":
            # key added only for this kind so every primes/twins hash
            # matches the one written before cousins existed
            payload["count_kind"] = self.count_kind
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]
