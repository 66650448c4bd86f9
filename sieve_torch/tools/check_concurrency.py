"""Static concurrency gate over ``sieve_torch/``: the port of the
reference's ``tools/check_concurrency.py``.

Runs the :mod:`sieve_torch.analysis` pass over the port's package and
fails on any finding not waived in
``sieve_torch/tools/concurrency_baseline.json``. The baseline only
ratchets *down*: new findings fail the gate immediately, stale entries
(baselined keys that no longer fire) print a warning so they get pruned.
Stdlib only: it loads no torch.

Usage::

    python -m sieve_torch.tools.check_concurrency               # the gate
    python -m sieve_torch.tools.check_concurrency --dump        # roles, edges, locks
    python -m sieve_torch.tools.check_concurrency --rebaseline  # rewrite baseline

``--dump`` is how the canonical lock order in
``sieve_torch/analysis/model.py`` is derived; re-run it when adding locks.
"""

from __future__ import annotations

import json
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_PATH = os.path.join(PKG, "tools", "concurrency_baseline.json")


def run_analysis(root: str | None = None):
    from sieve_torch.analysis import checks, core, model

    root = root or PKG
    prog = core.scan(root, pkg="sieve_torch", return_types=model.RETURN_TYPES)
    m = model.default_model()
    return prog, m, checks.analyze(prog, m)


def load_baseline(path: str = BASELINE_PATH) -> set[str]:
    if not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return set(data.get("waived", []))


def check() -> tuple[list[str], list[str]]:
    """(new_finding_lines, stale_baseline_keys) — gate fails on new."""
    _, _, findings = run_analysis()
    waived = load_baseline()
    live = {f.key for f in findings}
    new = [str(f) for f in findings if f.key not in waived]
    stale = sorted(waived - live)
    return new, stale


def _dump() -> None:
    from sieve_torch.analysis import checks

    prog, m, findings = run_analysis()
    roles = checks.assign_roles(prog, m)
    print("== thread roles ==")
    by_role: dict[str, list[str]] = {}
    for q, rs in roles.items():
        for r in rs:
            by_role.setdefault(r, []).append(q)
    for r in sorted(by_role):
        print(f"  {r}: {len(by_role[r])} funcs")
    print("== locks ==")
    for lock in sorted(prog.lock_ids()):
        print(f"  {lock}")
    print("== acquisition edges ==")
    for (a, b), sites in sorted(checks.lock_edges(prog).items()):
        func, line = sites[0]
        print(f"  {a} -> {b}   ({func}:{line}, {len(sites)} sites)")
    print("== findings ==")
    for f in findings:
        print(f"  {f}")
    print(f"== {len(findings)} findings ==")


def _rebaseline() -> None:
    _, _, findings = run_analysis()
    data = {
        "comment": (
            "Waived pre-existing concurrency findings of sieve_torch/. "
            "Ratchet-only: python -m sieve_torch.tools.check_concurrency "
            "fails on any key not listed here; remove entries as the "
            "findings get fixed."
        ),
        "waived": sorted({f.key for f in findings}),
    }
    with open(BASELINE_PATH, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"check_concurrency: baseline rewritten "
          f"({len(data['waived'])} waived) -> {BASELINE_PATH}")


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--dump" in argv:
        _dump()
        return 0
    if "--rebaseline" in argv:
        _rebaseline()
        return 0
    new, stale = check()
    for key in stale:
        print(f"check_concurrency: warning: stale baseline entry {key}",
              file=sys.stderr)
    if new:
        print("check_concurrency: FAIL — new findings (fix them or, for "
              "judged false positives, add to sieve_torch/tools/"
              "concurrency_baseline.json):", file=sys.stderr)
        for line in new:
            print(f"  {line}", file=sys.stderr)
        return 1
    waived = len(load_baseline())
    print(f"check_concurrency: ok (0 new findings, {waived} waived"
          f"{', ' + str(len(stale)) + ' stale' if stale else ''})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
