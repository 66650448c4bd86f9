"""Validated ``SIEVE_*`` environment-knob readers.

Every ``SIEVE_*`` knob the port reads goes through one of these helpers,
so a malformed value raises ``ValueError`` naming the variable at the
read site instead of an anonymous ``int()`` traceback deep in a worker.
The knob names are the reference package's (``sieve/env.py``), so one
environment drives both packages the same way.
"""

from __future__ import annotations

import os


def env_int(name: str, default: int | None) -> int | None:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"env {name}={raw!r}: expected an integer"
        ) from None


def env_float(name: str, default: float | None) -> float | None:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(
            f"env {name}={raw!r}: expected a number"
        ) from None


def env_str(name: str, default: str | None = None) -> str | None:
    """Tracked read of a free-form knob (paths, backend names, modes)."""
    return os.environ.get(name, default)


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: unset -> default; ``""`` and ``"0"`` -> False;
    anything else -> True (so ``SIEVE_X=1`` and ``SIEVE_X=yes`` agree)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw not in ("", "0")


def env_items() -> list[tuple[str, str]]:
    """Every currently-set ``SIEVE_*`` variable."""
    return [(k, v) for k, v in os.environ.items() if k.startswith("SIEVE_")]
