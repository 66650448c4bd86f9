"""Shard map: contiguous range partition of the keyspace.

The reference's ``sieve/service/shards.py``, with the same geometry and
the same error strings.

A :class:`ShardMap` describes how [2, N) is split into contiguous,
non-overlapping range shards, each served by its own ledger-backed
replica set. The router (sieve_torch/service/router.py) is a pure function of
this map: every routing decision — which shard owns a point, which
shards a window intersects, where pair counts must be spliced — is
derived here, so the map is validated once at construction and the
router never has to re-check geometry per request.

Two wire-ins exist, both producing the same validated object:

* a JSON file (``--shard-map map.json``)::

      {"shards": [{"lo": 2, "hi": 500000, "addrs": ["127.0.0.1:7701"]},
                  {"lo": 500000, "hi": 1000001,
                   "addrs": ["127.0.0.1:7711", "127.0.0.1:7712"]}]}

* repeated CLI flags (``--shard 2:500000=127.0.0.1:7701``).

Validation is by-name so misconfigurations are diagnosable from the
error string alone: ``unsorted`` (shards not in ascending order),
``overlap`` (a shard starts before its predecessor ends), ``gap`` (a
shard starts after its predecessor ends). The last shard is special:
queries beyond ``map.hi`` route to it, because its server's cold tier
is what grows the fabric's covered range.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Iterable, Sequence

# A shard narrower than this could let one pair (max gap 4) straddle two
# shard edges at once, which the single-edge splice does not handle; no
# real deployment shards the number line this finely.
MIN_SPAN = 16


def _num(text: str) -> int:
    """Parse a shard bound: plain int, 1e6 style, or 10**6 style."""
    s = text.strip().replace("_", "")
    try:
        if "**" in s:
            base, exp = s.split("**", 1)
            return int(base) ** int(exp)
        if "e" in s.lower():
            f = float(s)
            if f != int(f):
                raise ValueError
            return int(f)
        return int(s)
    except (ValueError, TypeError):
        raise ValueError(f"bad shard bound: {text!r}") from None


@dataclasses.dataclass(frozen=True)
class Shard:
    """One contiguous range [lo, hi) and the replica addresses serving it."""

    lo: int
    hi: int
    addrs: tuple[str, ...]

    def __post_init__(self) -> None:
        if not isinstance(self.lo, int) or not isinstance(self.hi, int):
            raise ValueError("shard bounds must be integers")
        if self.lo < 2:
            raise ValueError(f"shard lo must be >= 2, got {self.lo}")
        if self.hi <= self.lo:
            raise ValueError(f"shard range empty: [{self.lo}, {self.hi})")
        if self.hi - self.lo < MIN_SPAN:
            raise ValueError(
                f"shard [{self.lo}, {self.hi}) narrower than MIN_SPAN="
                f"{MIN_SPAN}: pair splice assumes one edge per pair")
        if not self.addrs:
            raise ValueError(f"shard [{self.lo}, {self.hi}) has no addrs")
        object.__setattr__(self, "addrs", tuple(str(a) for a in self.addrs))

    def to_dict(self) -> dict:
        return {"lo": self.lo, "hi": self.hi, "addrs": list(self.addrs)}


class ShardMap:
    """Validated, ordered partition of [lo, hi) into contiguous shards."""

    def __init__(self, shards: Sequence[Shard]):
        shards = list(shards)
        if not shards:
            raise ValueError("shard map is empty")
        for prev, cur in zip(shards, shards[1:]):
            if cur.lo < prev.lo:
                raise ValueError(
                    f"unsorted shard map: [{cur.lo}, {cur.hi}) listed after "
                    f"[{prev.lo}, {prev.hi})")
            if cur.lo < prev.hi:
                raise ValueError(
                    f"overlap in shard map: [{cur.lo}, {cur.hi}) begins "
                    f"inside [{prev.lo}, {prev.hi})")
            if cur.lo > prev.hi:
                raise ValueError(
                    f"gap in shard map: [{prev.hi}, {cur.lo}) is covered by "
                    f"no shard")
        self.shards: tuple[Shard, ...] = tuple(shards)
        self._los = [s.lo for s in self.shards]

    @property
    def lo(self) -> int:
        return self.shards[0].lo

    @property
    def hi(self) -> int:
        return self.shards[-1].hi

    def __len__(self) -> int:
        return len(self.shards)

    def __iter__(self):
        return iter(self.shards)

    def shard_for(self, x: int) -> int:
        """Index of the shard owning value ``x``.

        Values at or beyond ``self.hi`` route to the last shard — its
        cold tier extends the fabric's range. Values below ``self.lo``
        are owned by nobody and raise.
        """
        if x < self.lo:
            raise ValueError(
                f"value {x} below shard map range [{self.lo}, {self.hi})")
        return min(bisect.bisect_right(self._los, x) - 1, len(self.shards) - 1)

    def shards_in(self, lo: int, hi: int) -> list[tuple[int, int, int]]:
        """Ascending (index, a, b) intersections of [lo, hi) with shards.

        The last shard's intersection extends to ``hi`` even past its
        declared ``hi`` (cold-tier extension). Empty for hi <= lo.
        """
        if hi <= lo:
            return []
        if lo < self.lo:
            raise ValueError(
                f"window [{lo}, {hi}) starts below shard map range "
                f"[{self.lo}, {self.hi})")
        parts: list[tuple[int, int, int]] = []
        first = self.shard_for(lo)
        for i in range(first, len(self.shards)):
            s = self.shards[i]
            a = max(lo, s.lo)
            b = hi if i == len(self.shards) - 1 else min(hi, s.hi)
            if b > a:
                parts.append((i, a, b))
            if b >= hi:
                break
        return parts

    def edges(self) -> list[int]:
        """Interior shard boundaries (where pair counts must be spliced)."""
        return [s.hi for s in self.shards[:-1]]

    def to_dict(self) -> dict:
        return {"shards": [s.to_dict() for s in self.shards]}

    @classmethod
    def from_dict(cls, data: dict) -> "ShardMap":
        if not isinstance(data, dict) or "shards" not in data:
            raise ValueError('shard map JSON must be {"shards": [...]}')
        shards = []
        for ent in data["shards"]:
            if not isinstance(ent, dict):
                raise ValueError(f"bad shard entry: {ent!r}")
            try:
                shards.append(Shard(int(ent["lo"]), int(ent["hi"]),
                                    tuple(ent["addrs"])))
            except (KeyError, TypeError) as e:
                raise ValueError(f"bad shard entry {ent!r}: {e}") from None
        return cls(shards)

    @classmethod
    def from_json(cls, path: str) -> "ShardMap":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_flags(cls, flags: Iterable[str]) -> "ShardMap":
        """Parse repeated ``--shard LO:HI=ADDR[,ADDR...]`` values."""
        shards = []
        for flag in flags:
            try:
                rng, addrs = flag.split("=", 1)
                lo_s, hi_s = rng.split(":", 1)
            except ValueError:
                raise ValueError(
                    f"bad --shard {flag!r}: expected LO:HI=ADDR[,ADDR...]"
                ) from None
            addr_list = tuple(a.strip() for a in addrs.split(",") if a.strip())
            shards.append(Shard(_num(lo_s), _num(hi_s), addr_list))
        return cls(shards)
