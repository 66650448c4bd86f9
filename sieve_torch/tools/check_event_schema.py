"""Static check: every emitted event kind of the port must be in
``sieve_torch.metrics.EVENT_SCHEMA``. The port of the reference's
``tools/check_event_schema.py``.

Greps every ``<logger>.event("kind", ...)`` call and every literal
record passed to ``validate_record({... "event": "kind" ...})`` across
``sieve_torch/`` (tests excluded — they exercise bogus kinds on
purpose), then fails with a ``path:line: kind`` line per kind that
:data:`sieve_torch.metrics.EVENT_SCHEMA` does not document. Console
head lines like the CLI's ``{"event": "serving"}`` are not metrics
records and are deliberately not matched. It loads no torch.

Usage: python -m sieve_torch.tools.check_event_schema [ROOT]
"""

from __future__ import annotations

import os
import re
import sys

from sieve_torch.metrics import EVENT_SCHEMA

# .event( may put the kind string on the next line — allow whitespace
_EVENT_CALL = re.compile(r"\.event\(\s*['\"]([a-z0-9_]+)['\"]")
_VALIDATE_LITERAL = re.compile(
    r"validate_record\(\s*\{[^}]*['\"]event['\"]\s*:\s*['\"]([a-z0-9_]+)['\"]",
    re.S,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _py_files(root: str) -> list[str]:
    out: list[str] = []
    base = os.path.join(root, "sieve_torch")
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in filenames
                   if f.endswith(".py")
                   and f != "check_event_schema.py")  # own docstring
    return sorted(out)


def missing_kinds(root: str) -> list[tuple[str, int, str]]:
    """Every ``(path, line, kind)`` emission site whose kind is absent
    from EVENT_SCHEMA. Empty list means the schema is honest."""
    bad: list[tuple[str, int, str]] = []
    for path in _py_files(root):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for pat in (_EVENT_CALL, _VALIDATE_LITERAL):
            for m in pat.finditer(text):
                kind = m.group(1)
                if kind not in EVENT_SCHEMA:
                    line = text.count("\n", 0, m.start()) + 1
                    rel = os.path.relpath(path, root)
                    bad.append((rel, line, kind))
    return bad


def main(argv: list[str] | None = None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    root = args[0] if args else REPO
    bad = missing_kinds(root)
    for rel, line, kind in bad:
        print(f"{rel}:{line}: event kind '{kind}' missing from "
              "EVENT_SCHEMA (sieve_torch/metrics.py)", file=sys.stderr)
    if bad:
        return 1
    print(f"check_event_schema: ok ({len(EVENT_SCHEMA)} kinds documented)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
