"""Typed run configuration of the PyTorch port.

One frozen dataclass, serializable, everything on the config and nothing
ambient — the shape of ``sieve.config.SieveConfig``. The port's backends
are ``cuda`` (the hand-written Hopper kernels, counterpart of
``tpu-pallas``), ``torch`` (the word kernel in torch ops, counterpart of
``jax``), ``cpu-numpy``, ``cpu-native`` and ``cpu-cluster`` (the
coordinator of worker processes over TCP, sieve_torch/cluster.py). The
``device`` field places the device backends: entry points run on the card
unless the caller asks for ``device="cpu"``, where the ``cuda`` backend
runs its kernels' plain PyTorch versions and ``torch`` runs the same ops
on the CPU.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any

PACKINGS = ("plain", "odds", "wheel30")
BACKENDS = ("cpu-numpy", "cpu-native", "cpu-cluster", "cuda", "torch")
# --count-kind: which reduction runs on the marked bitset. All kinds share
# the same marking kernel — only the splice shift and pair mask at the
# reduction differ (primes = count only; twins = p, p+2; cousins = p, p+4).
COUNT_KINDS = ("primes", "twins", "cousins")
PAIR_GAPS = {"primes": 0, "twins": 2, "cousins": 4}

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
    # torch device of the ``cuda`` and ``torch`` backends: "cuda" (the
    # card) or "cpu". Left out of config_hash like ``backend``.
    device: str = "cuda"
    # Multi-process rounds over torch.distributed: the CLI joins the
    # process group before the run; workers is then the GLOBAL shard count.
    multihost: bool = False
    # Observability: ``profile_dir`` receives a torch.profiler trace of the
    # run (cuda and torch backends); ``trace_file`` writes a Chrome
    # trace-event JSON of host spans (sieve_torch/trace.py);
    # ``metrics_file`` appends every metrics event as JSONL whatever
    # --quiet says. All out of config_hash.
    profile_dir: str | None = None
    trace_file: str | None = None
    metrics_file: str | None = None
    # Fault injection: ``chaos`` is the composable schedule (see
    # sieve_torch/chaos.py); ``chaos_kill`` the legacy one-shot "k@s",
    # shorthand for "kill:k@s<s>". Both merge in :meth:`chaos_directives`.
    chaos: str | None = None
    chaos_kill: str | None = None
    # the cpu-cluster coordinator's endpoint
    coordinator_addr: str = "127.0.0.1:7621"

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
        if self.count_kind == "primes" and self.twins:
            object.__setattr__(self, "count_kind", "twins")
        elif self.count_kind in ("twins", "cousins") and not self.twins:
            object.__setattr__(self, "twins", True)
        # parse the chaos schedule now, so bad grammar fails here and not
        # mid-run on a worker
        if self.chaos or self.chaos_kill:
            self.chaos_directives()

    def chaos_directives(self) -> list:
        """The merged fault-injection schedule (``chaos`` plus the legacy
        ``chaos_kill``) as :class:`sieve_torch.chaos.ChaosDirective`s."""
        from sieve_torch.chaos import parse_chaos

        spec = self.chaos or ""
        if self.chaos_kill:
            if "@" not in self.chaos_kill:
                raise ValueError(
                    f"chaos_kill must be 'k@s', got {self.chaos_kill!r}"
                )
            who, seg = self.chaos_kill.split("@", 1)
            legacy = f"kill:{who}@s{seg}"
            spec = f"{spec},{legacy}" if spec else legacy
        return parse_chaos(spec) if spec else []

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
        """The config of a dict, keeping only this class's fields: a dict
        from another version of the config (a mixed cluster) may carry
        fields this one lacks, and they are dropped."""
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
