"""Checkpoint / resume ledger: the reference's file format, byte for byte.

Format (version 2)::

    {"version": 2, "config_hash": h, "checksum": c,
     "completed": {seg_id: SegmentResult}}

``checksum`` is a truncated sha256 over the canonical
``{config_hash, completed}`` payload, verified on every open, so bit rot
is detected instead of silently merged. Version-1 files (no
``version``/``checksum``) still load. ``config_hash`` is the reference's
(sieve_torch/config.py), so a ledger written by either package resumes
under the other.

Durability: every flush writes a temp file, fsyncs it, atomically renames
it over the ledger, and fsyncs the directory (``SIEVE_LEDGER_FSYNC=0``
opts out): a host crash leaves the previous complete ledger, never a torn
one.

Corruption handling on open:

* unparseable / truncated file: quarantined to ``<ledger>.quarantined``
  and salvaged entry by entry. Every complete ``SegmentResult`` object
  whose fields pass :meth:`SegmentResult.is_sane` is recovered, provided
  the embedded ``config_hash`` still matches the run; a clean checksummed
  ledger is rewritten at once, and ``Ledger.salvaged`` /
  ``Ledger.quarantined`` say so. If nothing is salvageable,
  :class:`LedgerCorrupt` names the quarantined file.
* parseable but checksum-mismatched: silent corruption with no way to
  tell which entry is bad; quarantined, never salvaged,
  :class:`LedgerCorrupt` raised.

``--resume`` replays the merge over ledger + remaining segments; a
config-hash mismatch refuses to resume (the math would differ).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
from pathlib import Path
from typing import TYPE_CHECKING

from sieve_torch import env
from sieve_torch.worker import SegmentResult

if TYPE_CHECKING:
    from sieve_torch.config import SieveConfig

LEDGER_NAME = "sieve_ledger.json"
LEDGER_VERSION = 2

# completed-dict entries: '"<seg_id>": {flat object}' — SegmentResult
# serializations are flat, so a non-greedy brace match per entry is exact
_ENTRY_RE = re.compile(r'"(\d+)"\s*:\s*(\{[^{}]*\})')
_HASH_RE = re.compile(r'"config_hash"\s*:\s*"([0-9a-f]+)"')


class LedgerMismatch(RuntimeError):
    pass


class LedgerCorrupt(LedgerMismatch):
    """The ledger file failed parse or checksum; the damaged file has been
    quarantined (path in the message) and nothing could be salvaged."""


def _payload_checksum(config_hash: str, completed: dict[str, dict]) -> str:
    blob = json.dumps(
        {"config_hash": config_hash, "completed": completed}, sort_keys=True
    ).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _fsync_enabled() -> bool:
    return env.env_str("SIEVE_LEDGER_FSYNC", "1") != "0"


def ledger_fingerprint(path: Path | str) -> tuple[int, int] | None:
    """Cheap change detector: (mtime_ns, size), or None when the file is
    absent. One stat, no read."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    return (st.st_mtime_ns, st.st_size)


def _salvage_entries(text: str) -> dict[int, dict]:
    """Recover complete, sane SegmentResult entries from corrupt ledger
    bytes (truncation keeps every fully written entry intact)."""
    out: dict[int, dict] = {}
    for m in _ENTRY_RE.finditer(text):
        try:
            res = SegmentResult.from_dict(json.loads(m.group(2)))
        except (ValueError, KeyError, TypeError):
            continue
        if res.is_sane():
            out[int(m.group(1))] = res.to_dict()
    return out


class Ledger:
    def __init__(self, path: Path, config_hash: str, entries: dict[int, dict]):
        self.path = path
        self.config_hash = config_hash
        self._entries = entries
        # salvage provenance (set by open() when a corrupt file was
        # recovered)
        self.salvaged = 0
        self.quarantined: str | None = None

    @classmethod
    def open(cls, config: "SieveConfig") -> "Ledger":
        assert config.checkpoint_dir is not None
        path = Path(config.checkpoint_dir) / LEDGER_NAME
        chash = config.config_hash()
        entries: dict[int, dict] = {}
        salvaged = 0
        quarantined: Path | None = None
        if path.exists():
            text = path.read_text()
            data, corrupt = cls._parse(text)
            if data is not None:
                if data.get("config_hash") != chash:
                    raise LedgerMismatch(
                        f"ledger at {path} was written for config_hash="
                        f"{data.get('config_hash')}, current run is {chash}; "
                        "refusing to mix results (delete the ledger or match "
                        "the config)"
                    )
                if int(data.get("version", 1)) > LEDGER_VERSION:
                    raise LedgerMismatch(
                        f"ledger at {path} has version {data.get('version')} "
                        f"(this build writes {LEDGER_VERSION}); refusing to "
                        "rewrite a newer format"
                    )
                entries = {
                    int(k): v for k, v in data.get("completed", {}).items()
                }
            else:
                quarantined, entries = cls._quarantine_and_salvage(
                    path, text, chash, corrupt
                )
                salvaged = len(entries)
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
        ledger = cls(path, chash, entries)
        if salvaged:
            ledger.salvaged = salvaged
            ledger.quarantined = str(quarantined)
            ledger._flush()  # rewrite a clean, checksummed ledger now
        return ledger

    @staticmethod
    def _parse(text: str) -> tuple[dict | None, str]:
        """(payload, "") when intact; (None, reason) when corrupt.

        reason "truncated" = unparseable bytes (salvageable per entry);
        reason "checksum" = parseable but failing its own checksum
        (silent corruption — not salvageable)."""
        try:
            data = json.loads(text)
        except ValueError:
            return None, "truncated"
        if not isinstance(data, dict) or "config_hash" not in data:
            return None, "truncated"
        want = data.get("checksum")
        if want is not None and want != _payload_checksum(
            data.get("config_hash"), data.get("completed") or {}
        ):
            return None, "checksum"
        return data, ""

    @classmethod
    def _quarantine_and_salvage(
        cls, path: Path, text: str, chash: str, reason: str
    ) -> tuple[Path, dict[int, dict]]:
        qpath = path.with_name(path.name + ".quarantined")
        os.replace(path, qpath)
        entries: dict[int, dict] = {}
        m = _HASH_RE.search(text)
        if reason == "truncated" and m and m.group(1) == chash:
            entries = _salvage_entries(text)
        if entries:
            return qpath, entries
        detail = (
            "its checksum does not match its payload (silent corruption; "
            "per-entry salvage is unsafe)"
            if reason == "checksum"
            else "it is truncated or unparseable and no complete entry "
            "matching this run's config could be salvaged"
            if m is None or m.group(1) == chash
            else f"its recovered config_hash {m.group(1)} does not match "
            f"this run's {chash}"
        )
        raise LedgerCorrupt(
            f"ledger at {path} is corrupt: {detail}. The damaged file was "
            f"quarantined to {qpath}; --resume has no completed segments to "
            f"restore from it. Rerun without --resume to recompute from "
            f"scratch, or restore a known-good ledger to {path} "
            f"(delete {qpath} once investigated)."
        )

    def completed(self) -> dict[int, SegmentResult]:
        return {k: SegmentResult.from_dict(v) for k, v in self._entries.items()}

    def record(self, res: SegmentResult) -> None:
        """Idempotent: the ledger keys on segment id, so a segment processed
        twice is counted once."""
        self.record_many([res])

    def record_many(self, results: list[SegmentResult]) -> None:
        """Record a batch of results with ONE atomic fsync'd flush: a crash
        leaves either the whole batch or none of it."""
        if not results:
            return
        for res in results:
            self._entries[res.seg_id] = res.to_dict()
        self._flush()

    def _flush(self) -> None:
        completed = {str(k): v for k, v in self._entries.items()}
        payload = {
            "version": LEDGER_VERSION,
            "config_hash": self.config_hash,
            "checksum": _payload_checksum(self.config_hash, completed),
            "completed": completed,
        }
        fd, tmp = tempfile.mkstemp(dir=self.path.parent, prefix=".ledger.")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
                if _fsync_enabled():
                    f.flush()
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)  # atomic on POSIX
            if _fsync_enabled():
                # fsync the directory so the rename itself is durable
                dfd = os.open(self.path.parent, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
