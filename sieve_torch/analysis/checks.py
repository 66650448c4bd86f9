"""Concurrency checks over a scanned :class:`~sieve_torch.analysis.core.Program`:
the port's copy of the reference's ``sieve/analysis/checks.py``.

Four families of findings, each with a *stable* key (no line numbers)
so the committed baseline ratchets instead of churning:

* ``lock-order:A->B@func`` / ``lock-cycle:...`` / ``lock-self:...`` /
  ``lock-unlisted:...`` / ``lock-name:...`` — the acquisition graph
  against the canonical order.
* ``loop-blocking:role:func:op`` — blocking operation reachable from an
  event-loop role.
* ``guard:Class.attr@func`` — access to a ``# guard:``-annotated shared
  attribute without its lock held.
* ``unannotated:Class.attr`` — mutable attribute of a lock-owning class
  touched from >= 2 thread roles with no ``# guard:`` declaration.
"""

from __future__ import annotations

import dataclasses

from sieve_torch.analysis.core import FunctionInfo, Program
from sieve_torch.analysis.model import Model


@dataclasses.dataclass
class Finding:
    kind: str
    key: str  # stable baseline key
    msg: str
    where: str  # "module:func (path:line)"-ish display hint

    def __str__(self) -> str:
        return f"[{self.kind}] {self.key}: {self.msg} ({self.where})"


# --- thread roles --------------------------------------------------------


def assign_roles(prog: Program, model: Model) -> dict[str, set[str]]:
    """Map function qualname -> set of thread-role names that reach it.

    Seeds: every ``threading.Thread(...)`` spawn target (role = the
    thread's ``name=``), every ``Thread`` subclass ``run`` method
    (role = class name), the synthetic ``app`` role at public methods
    of the API classes, and any extra model seeds. Roles then flow
    along resolved call edges — but *not* through spawn sites: the
    spawned function runs on the new thread, not the spawner's.
    """
    roles: dict[str, set[str]] = {q: set() for q in prog.functions}
    work: list[str] = []

    def seed(qual: str | None, role: str) -> None:
        if qual is not None and qual in roles and role not in roles[qual]:
            roles[qual].add(role)
            work.append(qual)

    for fi in prog.functions.values():
        for sp in fi.spawns:
            seed(sp.target, sp.role)
    for ci in prog.classes.values():
        if ci.is_thread:
            seed(ci.methods.get("run"), ci.name)
        if ci.name in model.app_role_classes:
            for mname, qual in ci.methods.items():
                if not mname.startswith("_") or mname == "__init__":
                    seed(qual, "app")
    for qual, role in model.extra_seeds:
        seed(qual, role)

    while work:
        q = work.pop()
        fi = prog.functions[q]
        spawn_lines = {sp.line for sp in fi.spawns}
        for ce in fi.calls:
            if ce.target is None or ce.target not in roles:
                continue
            if ce.line in spawn_lines:
                continue  # the ctor call at a spawn site is not an edge
            for r in roles[q]:
                if r not in roles[ce.target]:
                    roles[ce.target].add(r)
                    work.append(ce.target)
    return roles


# --- lock graph ----------------------------------------------------------


def transitive_acquires(prog: Program) -> dict[str, set[str]]:
    """TA(f): every lock ``f`` may acquire, directly or via callees."""
    ta: dict[str, set[str]] = {
        q: {a.lock for a in fi.acquires}
        for q, fi in prog.functions.items()
    }
    changed = True
    while changed:
        changed = False
        for q, fi in prog.functions.items():
            cur = ta[q]
            for ce in fi.calls:
                if ce.target in ta:
                    extra = ta[ce.target] - cur
                    if extra:
                        cur |= extra
                        changed = True
    return ta


def lock_edges(prog: Program) -> dict[tuple[str, str], list[tuple[str, int]]]:
    """(held, acquired) -> [(func, line)] — direct ``with``-nesting plus
    interprocedural edges via calls made while holding a lock."""
    edges: dict[tuple[str, str], list[tuple[str, int]]] = {}

    def add(a: str, b: str, func: str, line: int) -> None:
        edges.setdefault((a, b), []).append((func, line))

    ta = transitive_acquires(prog)
    for q, fi in prog.functions.items():
        for ae in fi.acquires:
            for h in ae.held:
                add(h, ae.lock, q, ae.line)
        for ce in fi.calls:
            if ce.target not in ta or not ce.held:
                continue
            for h in ce.held:
                for l in ta[ce.target]:
                    add(h, l, q, ce.line)
    return edges


def _lock_kinds(prog: Program) -> dict[str, str]:
    kinds: dict[str, str] = {}
    for ci in prog.classes.values():
        for d in ci.locks.values():
            kinds[d.lock_id] = d.kind
    for m in prog.modules.values():
        for d in m.locks.values():
            kinds[d.lock_id] = d.kind
    return kinds


def _sccs(nodes: set[str], succ: dict[str, set[str]]) -> list[list[str]]:
    """Tarjan SCCs, iterative; returns only components of size > 1."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on: set[str] = set()
    stack: list[str] = []
    out: list[list[str]] = []
    counter = [0]

    def strongconnect(v0: str) -> None:
        call = [(v0, iter(sorted(succ.get(v0, ()))))]
        index[v0] = low[v0] = counter[0]
        counter[0] += 1
        stack.append(v0)
        on.add(v0)
        while call:
            v, it = call[-1]
            advanced = False
            for w in it:
                if w not in nodes:
                    continue
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    call.append((w, iter(sorted(succ.get(w, ())))))
                    advanced = True
                    break
                elif w in on:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            call.pop()
            if call:
                pv = call[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    out.append(sorted(comp))

    for v in sorted(nodes):
        if v not in index:
            strongconnect(v)
    return out


# --- the checks ----------------------------------------------------------


def check_lock_order(prog: Program, model: Model) -> list[Finding]:
    findings: list[Finding] = []
    order = {lock: i for i, lock in enumerate(model.canonical_lock_order)}
    kinds = _lock_kinds(prog)
    edges = lock_edges(prog)

    unlisted = {
        lock for lock in kinds if lock not in order
    } | {
        l for (a, b) in edges for l in (a, b) if l not in order
    }
    for lock in sorted(unlisted):
        findings.append(Finding(
            kind="lock-unlisted", key=f"lock-unlisted:{lock}",
            msg=f"lock {lock} missing from CANONICAL_LOCK_ORDER",
            where=lock))

    succ: dict[str, set[str]] = {}
    for (a, b), sites in sorted(edges.items()):
        func, line = sites[0]
        if a == b:
            if kinds.get(a) != "rlock":
                findings.append(Finding(
                    kind="lock-self", key=f"lock-self:{a}@{func}",
                    msg=f"re-acquisition of non-reentrant {a}",
                    where=f"{func}:{line}"))
            continue
        succ.setdefault(a, set()).add(b)
        if a in order and b in order and order[a] > order[b]:
            findings.append(Finding(
                kind="lock-order", key=f"lock-order:{a}->{b}@{func}",
                msg=(f"acquires {b} while holding {a}, against the "
                     f"canonical order"),
                where=f"{func}:{line}"))
    nodes = {l for (a, b) in edges for l in (a, b)}
    for comp in _sccs(nodes, succ):
        findings.append(Finding(
            kind="lock-cycle", key="lock-cycle:" + ">".join(comp),
            msg="cyclic lock acquisition (potential deadlock): "
                + " <-> ".join(comp),
            where=comp[0]))

    # named_lock literal must match the derived identity
    decls = [d for ci in prog.classes.values() for d in ci.locks.values()]
    decls += [d for m in prog.modules.values() for d in m.locks.values()]
    for d in decls:
        if d.given_name is not None and d.given_name != d.lock_id:
            findings.append(Finding(
                kind="lock-name", key=f"lock-name:{d.lock_id}",
                msg=(f"named_lock({d.given_name!r}) does not match the "
                     f"derived identity {d.lock_id!r}"),
                where=f"{d.lock_id}:{d.line}"))
    return findings


def check_loop_blocking(prog: Program, model: Model,
                        roles: dict[str, set[str]]) -> list[Finding]:
    findings: list[Finding] = []
    for q, fi in prog.functions.items():
        hit = roles.get(q, set()) & model.loop_roles
        if not hit:
            continue
        role = sorted(hit)[0]
        spawn_lines = {sp.line for sp in fi.spawns}
        seen: set[str] = set()
        for ce in fi.calls:
            if ce.line in spawn_lines:
                continue
            op = None
            if ce.target is not None:
                if ce.target in model.blocking_calls:
                    op = ce.target
                else:
                    for p in model.blocking_prefixes:
                        if ce.target.startswith(p):
                            op = ce.target
                            break
            if op is None and ce.attr in model.blocking_attrs:
                op = f".{ce.attr}"
            if op is None or op in seen:
                continue
            seen.add(op)
            findings.append(Finding(
                kind="loop-blocking",
                key=f"loop-blocking:{role}:{q}:{op}",
                msg=f"blocking op {op} reachable from loop role {role}",
                where=f"{q}:{ce.line}"))
    return findings


def _guard_exempt(fi: FunctionInfo, owner_fullid: str) -> bool:
    """Constructors of the owning class publish before sharing."""
    if fi.cls != owner_fullid:
        return False
    local = fi.qualname.rsplit(".", 1)[-1]
    return local in ("__init__", "__post_init__")


def check_guards(prog: Program, roles: dict[str, set[str]]) -> list[Finding]:
    findings: list[Finding] = []
    # gather declared guards: (owner_fullid, attr) -> (lock_id|None, decl)
    guards: dict[tuple[str, str], str | None] = {}
    for ci in prog.classes.values():
        for attr, g in ci.guards.items():
            if g.lock is None:
                guards[(ci.fullid, attr)] = None
            else:
                decl = ci.locks.get(g.lock)
                guards[(ci.fullid, attr)] = (
                    decl.lock_id if decl else f"{ci.name}.{g.lock}"
                )
    for m in prog.modules.values():
        for name, g in m.guards.items():
            if g.lock is None:
                guards[(f"{m.name}:", name)] = None
            else:
                decl = m.locks.get(g.lock)
                guards[(f"{m.name}:", name)] = (
                    decl.lock_id if decl else f"{m.base}.{g.lock}"
                )

    # accesses per guarded attr
    access_roles: dict[tuple[str, str], set[str]] = {}
    sites: dict[tuple[str, str], list[tuple[FunctionInfo, int, bool]]] = {}
    for q, fi in prog.functions.items():
        for ac in fi.accesses:
            key = (ac.owner, ac.attr)
            if key not in guards:
                continue
            lock_id = guards[key]
            if lock_id is None:
                continue  # guard: none(reason) — waived by annotation
            if _guard_exempt(fi, ac.owner):
                continue
            access_roles.setdefault(key, set()).update(
                roles.get(q, set()))
            if lock_id not in ac.held:
                sites.setdefault(key, []).append((fi, ac.line, ac.is_store))
    for key, bad in sorted(sites.items(),
                           key=lambda kv: (kv[0][0], kv[0][1])):
        if len(access_roles.get(key, set())) < 2:
            continue  # effectively single-threaded
        owner, attr = key
        disp = owner.split(":")[-1] or owner.split(":")[0].rsplit(".")[-1]
        flagged: set[str] = set()
        for fi, line, is_store in bad:
            if fi.qualname in flagged:
                continue
            flagged.add(fi.qualname)
            verb = "write to" if is_store else "read of"
            findings.append(Finding(
                kind="guard",
                key=f"guard:{disp}.{attr}@{fi.qualname}",
                msg=(f"{verb} {disp}.{attr} without "
                     f"{guards[key]} held"),
                where=f"{fi.qualname}:{line}"))
    return findings


def check_unannotated(prog: Program,
                      roles: dict[str, set[str]]) -> list[Finding]:
    """Mutable attrs of lock-owning classes touched from >= 2 roles but
    carrying no ``# guard:`` declaration."""
    findings: list[Finding] = []
    access_roles: dict[tuple[str, str], set[str]] = {}
    writers: dict[tuple[str, str], set[str]] = {}
    for q, fi in prog.functions.items():
        for ac in fi.accesses:
            key = (ac.owner, ac.attr)
            access_roles.setdefault(key, set()).update(roles.get(q, set()))
            if ac.is_store:
                writers.setdefault(key, set()).add(q)
    for ci in sorted(prog.classes.values(), key=lambda c: c.fullid):
        if not ci.locks and not ci.is_thread:
            continue
        # self-writes plus cross-object stores (obj.attr = ... from
        # another class, e.g. the follower poking the service)
        attrs = set(ci.attr_writes) | {
            a for (o, a) in writers if o == ci.fullid
        }
        for attr in sorted(attrs):
            if attr in ci.guards or attr in ci.locks \
                    or attr in ci.events or attr in ci.methods:
                continue
            init = ci.methods.get("__init__")
            wr = ci.attr_writes.get(attr, set()) \
                | writers.get((ci.fullid, attr), set())
            if wr <= ({init} if init else set()):
                continue  # only ever written during construction
            if len(access_roles.get((ci.fullid, attr), set())) < 2:
                continue
            findings.append(Finding(
                kind="unannotated",
                key=f"unannotated:{ci.name}.{attr}",
                msg=(f"{ci.name}.{attr} is written outside __init__ and "
                     f"reached from multiple thread roles but has no "
                     f"# guard: annotation"),
                where=ci.fullid))
    return findings


def analyze(prog: Program, model: Model) -> list[Finding]:
    roles = assign_roles(prog, model)
    findings = check_lock_order(prog, model)
    findings += check_loop_blocking(prog, model, roles)
    findings += check_guards(prog, roles)
    findings += check_unannotated(prog, roles)
    findings.sort(key=lambda f: (f.kind, f.key))
    return findings
