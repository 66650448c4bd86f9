"""Env-var discipline checker over the port: the port of the reference's
``tools/check_env_vars.py``.

Two rules, both over ``sieve_torch/`` and ``chip_smoke.py``:

1. **No raw reads.** Every ``SIEVE_*`` environment variable must be
   read through the validators in :mod:`sieve_torch.env` (``env_int`` /
   ``env_float`` / ``env_str`` / ``env_flag`` / ``env_items``), which
   produce actionable errors on malformed values instead of a bare
   ``ValueError`` deep in a worker thread. A direct
   ``os.environ.get("SIEVE_...")`` / ``os.environ["SIEVE_..."]`` /
   ``os.getenv("SIEVE_...")`` read anywhere outside
   ``sieve_torch/env.py`` is a failure. *Writes* (``setdefault``,
   subscript stores, building a child-process environment dict) are
   fine — the rule is about parsing config, not exporting it.

2. **Documented.** Every ``SIEVE_*`` name that appears as a complete
   string literal in the code (read sites, prefix constants, child-env
   keys) must appear in ``README.md``. Names ending in ``_`` are
   prefixes (``SIEVE_SVC_SLO_MS_<OP>``) and match as substrings too.

Both rules are absolute, not ratcheted. Stdlib only: it loads no torch.

Usage: python -m sieve_torch.tools.check_env_vars
"""

from __future__ import annotations

import ast
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
README = os.path.join(REPO, "README.md")
SCAN = ("sieve_torch",)
EXTRA_FILES = ("chip_smoke.py",)
# the validator module itself is the one place raw reads are legal
RAW_READ_EXEMPT = {os.path.join("sieve_torch", "env.py")}

_NAME_RE = re.compile(r"^SIEVE_[A-Z0-9_]+$")


def _py_files() -> list[str]:
    out = []
    for top in SCAN:
        for dirpath, dirnames, filenames in os.walk(os.path.join(REPO, top)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    for fn in EXTRA_FILES:
        p = os.path.join(REPO, fn)
        if os.path.exists(p):
            out.append(p)
    return sorted(out)


def _is_environ(node: ast.expr) -> bool:
    """True for ``os.environ`` (or a bare ``environ`` import)."""
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        return True
    return isinstance(node, ast.Name) and node.id == "environ"


def _sieve_literal(node: ast.expr) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        if _NAME_RE.match(node.value):
            return node.value
    return None


class _Scanner(ast.NodeVisitor):
    def __init__(self, rel: str) -> None:
        self.rel = rel
        self.raw_reads: list[tuple[int, str]] = []
        self.names: set[str] = set()

    def visit_Constant(self, node: ast.Constant) -> None:
        name = _sieve_literal(node)
        if name:
            self.names.add(name)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        # os.environ.get("SIEVE_...") / os.environ.setdefault(...)
        if (isinstance(func, ast.Attribute) and _is_environ(func.value)
                and func.attr == "get" and node.args):
            name = _sieve_literal(node.args[0])
            if name:
                self.raw_reads.append((node.lineno, name))
        # os.getenv("SIEVE_...")
        if (isinstance(func, ast.Attribute) and func.attr == "getenv"
                and node.args):
            name = _sieve_literal(node.args[0])
            if name:
                self.raw_reads.append((node.lineno, name))
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # os.environ["SIEVE_..."] in Load context is a raw read;
        # a subscript *store* is exporting to children and is fine
        if _is_environ(node.value) and isinstance(node.ctx, ast.Load):
            name = _sieve_literal(node.slice)
            if name:
                self.raw_reads.append((node.lineno, name))
        self.generic_visit(node)


def scan() -> tuple[list[str], set[str]]:
    """Returns (raw-read problem strings, all SIEVE_* literal names)."""
    problems: list[str] = []
    names: set[str] = set()
    for path in _py_files():
        rel = os.path.relpath(path, REPO)
        try:
            tree = ast.parse(open(path, encoding="utf-8").read())
        except SyntaxError as exc:
            problems.append(f"{rel}: unparseable: {exc}")
            continue
        sc = _Scanner(rel)
        sc.visit(tree)
        names |= sc.names
        if rel in RAW_READ_EXEMPT:
            continue
        for lineno, name in sc.raw_reads:
            problems.append(
                f"{rel}:{lineno}: raw read of {name} — go through "
                "sieve_torch.env (env_int/env_float/env_str/env_flag/env_items)"
            )
    return problems, names


def undocumented(names: set[str]) -> list[str]:
    text = open(README, encoding="utf-8").read()
    missing = []
    for name in sorted(names):
        # trailing-underscore names are prefixes; both forms match as a
        # plain substring (the README writes SIEVE_SVC_SLO_MS_<OP>)
        if name not in text:
            missing.append(name)
    return missing


def main(argv: list[str] | None = None) -> int:
    problems, names = scan()
    for name in undocumented(names):
        problems.append(f"README.md: {name} is not documented")
    for p in problems:
        print(f"check_env_vars: {p}", file=sys.stderr)
    if problems:
        print(f"check_env_vars: FAILED ({len(problems)} problem(s))",
              file=sys.stderr)
        return 1
    print(f"check_env_vars: ok ({len(names)} SIEVE_* vars, all "
          "validated + documented)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
