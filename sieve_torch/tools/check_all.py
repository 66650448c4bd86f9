"""Run every static gate of the port, one line per check, one exit code.
The port of the reference's ``tools/check_all.py``.

The individual checkers stay runnable on their own (each prints its
own diagnostics to stderr); this runner exists so CI and humans have a
single command that cannot silently skip a gate. Adding a checker
means adding a ``(name, main)`` pair to ``CHECKS``. ``--device`` goes
to the wire check, whose live leg sieves its ledger there (default
``cuda``: the fused kernel, and the card must exist).

Usage: python -m sieve_torch.tools.check_all [--device D]
"""

from __future__ import annotations

import argparse
import sys

from sieve_torch.tools import (
    check_concurrency,
    check_env_vars,
    check_event_schema,
    check_wire_ops,
)

#: (display name, argv-style main returning an exit code, takes --device)
CHECKS = (
    ("wire_ops", check_wire_ops.main, True),
    ("event_schema", check_event_schema.main, False),
    ("concurrency", check_concurrency.main, False),
    ("env_vars", check_env_vars.main, False),
)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device of the wire check's live leg (cuda or cpu)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    failed = []
    for name, entry, takes_device in CHECKS:
        try:
            rc = entry(["--device", args.device] if takes_device else [])
        except Exception as exc:  # a crashed checker is a failed checker
            print(f"check_all: {name} crashed: {exc!r}", file=sys.stderr)
            rc = 2
        print(f"check_all: {name}: {'ok' if rc == 0 else f'FAILED ({rc})'}")
        if rc != 0:
            failed.append(name)
    if failed:
        print(f"check_all: FAILED ({', '.join(failed)})", file=sys.stderr)
        return 1
    print(f"check_all: ok ({len(CHECKS)} checks)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
