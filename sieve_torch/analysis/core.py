"""AST fact extraction for the concurrency analyzer: the port's copy of the
reference's ``sieve/analysis/core.py``, function for function.

Stdlib-only (``ast`` + source text; air-gap safe). :func:`scan` walks a
source tree and returns a :class:`Program` of per-function facts:

* resolved call sites (name-and-type based: ``self.x()`` through class
  methods, ``alias.f()`` through imports, ``obj.m()`` through attribute
  and parameter type inference),
* lock declarations (``threading.Lock/RLock/Condition`` attributes and
  the :mod:`sieve_torch.analysis.lockdebug` named constructors, whose literal
  name must match the derived ``Class.attr`` identity),
* lock acquisitions from ``with`` statements, each recorded with the
  set of locks already held (lexically or via a ``# holds:`` contract
  comment on the enclosing ``def``),
* attribute accesses on lock-owning classes with the held set at the
  access site,
* thread-creation sites (``threading.Thread(target=..., name=...)`` and
  ``threading.Thread`` subclasses) that seed thread roles,
* blocking operations (``time.sleep``, ``.wait()``/``.join()``, queue
  gets, and the model-supplied blocking call list).

Annotation syntax (trailing comments, parsed from source text):

* ``self.attr = ...  # guard: _some_lock`` — shared attribute, must be
  touched under ``Class._some_lock`` wherever >= 2 thread roles reach.
* ``self.attr = ...  # guard: none(reason)`` — intentionally racy; the
  reason is required and shows up in ``--dump`` output.
* ``def f(...):  # holds: _some_lock`` — contract: every caller holds
  the named lock; the body is analyzed with it in the held set.

The scanner is deliberately approximate — unresolvable calls produce no
edge (under-approximation) and the committed baseline absorbs judged
false positives — but it is deterministic, so findings ratchet.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}
NAMED_CTORS = {
    "named_lock": "lock",
    "named_rlock": "rlock",
    "named_condition": "condition",
}

_GUARD_RE = re.compile(
    # the none(reason) close-paren may land on a continuation line;
    # the reason captured here is just the first line's worth
    r"#\s*guard:\s*(?:none\s*\((?P<reason>[^)]*)\)?|(?P<lock>[A-Za-z_]\w*))"
)
_HOLDS_RE = re.compile(r"#\s*holds:\s*(?P<locks>[\w.]+(?:\s*,\s*[\w.]+)*)")


@dataclasses.dataclass
class Guard:
    lock: str | None  # lock attr name; None means none(reason)
    reason: str
    line: int


@dataclasses.dataclass
class LockDecl:
    lock_id: str  # "Class.attr" or "modbase.name"
    kind: str  # lock | rlock | condition
    line: int
    given_name: str | None  # literal passed to a named_* ctor


@dataclasses.dataclass
class CallEvent:
    target: str | None  # "module:qual" | external dotted | None
    attr: str | None  # bare attribute name for unresolved method calls
    line: int
    held: tuple[str, ...]


@dataclasses.dataclass
class AcquireEvent:
    lock: str
    line: int
    held: tuple[str, ...]


@dataclasses.dataclass
class Access:
    owner: str  # class fullid "module:Class", or "module:" for globals
    attr: str
    is_store: bool
    line: int
    held: tuple[str, ...]


@dataclasses.dataclass
class BlockEvent:
    op: str
    line: int


@dataclasses.dataclass
class ThreadSpawn:
    role: str
    target: str | None
    line: int


@dataclasses.dataclass
class FunctionInfo:
    qualname: str  # "module:Class.method" | "module:func" | nested "a.b"
    module: str
    cls: str | None  # fullid of enclosing class
    line: int
    holds: tuple[str, ...] = ()
    calls: list[CallEvent] = dataclasses.field(default_factory=list)
    acquires: list[AcquireEvent] = dataclasses.field(default_factory=list)
    accesses: list[Access] = dataclasses.field(default_factory=list)
    blocking: list[BlockEvent] = dataclasses.field(default_factory=list)
    spawns: list[ThreadSpawn] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClassInfo:
    fullid: str  # "module:Class"
    name: str
    module: str
    line: int
    bases: list[str] = dataclasses.field(default_factory=list)
    methods: dict[str, str] = dataclasses.field(default_factory=dict)
    locks: dict[str, LockDecl] = dataclasses.field(default_factory=dict)
    events: set[str] = dataclasses.field(default_factory=set)
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)
    guards: dict[str, Guard] = dataclasses.field(default_factory=dict)
    attr_writes: dict[str, set[str]] = dataclasses.field(
        default_factory=dict
    )  # attr -> funcs that store it
    is_thread: bool = False


@dataclasses.dataclass
class ModuleInfo:
    name: str  # dotted
    path: str
    classes: dict[str, ClassInfo] = dataclasses.field(default_factory=dict)
    functions: dict[str, str] = dataclasses.field(default_factory=dict)
    locks: dict[str, LockDecl] = dataclasses.field(default_factory=dict)
    guards: dict[str, Guard] = dataclasses.field(default_factory=dict)
    imports: dict[str, str] = dataclasses.field(default_factory=dict)
    from_imports: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def base(self) -> str:
        return self.name.rsplit(".", 1)[-1]


@dataclasses.dataclass
class Program:
    modules: dict[str, ModuleInfo]
    functions: dict[str, FunctionInfo]
    classes: dict[str, ClassInfo]  # by fullid

    def lock_ids(self) -> set[str]:
        out = set()
        for c in self.classes.values():
            out.update(d.lock_id for d in c.locks.values())
        for m in self.modules.values():
            out.update(d.lock_id for d in m.locks.values())
        return out


# --- discovery -----------------------------------------------------------


def _py_modules(root: str, pkg: str) -> list[tuple[str, str]]:
    """(dotted module name, path) under ``root`` (the package dir)."""
    out: list[tuple[str, str]] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in sorted(filenames):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            parts = rel[:-3].split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out.append((".".join([pkg] + parts) if parts else pkg,
                        os.path.join(dirpath, f)))
    return out


def _ann_class_name(node: ast.AST | None) -> str | None:
    """Best-effort class name from an annotation expression: unwraps
    ``X | None``, ``Optional[X]``, quoted strings, and dotted names
    (keeping the final component)."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _ann_class_name(node.left)
    if isinstance(node, ast.Subscript):
        base = _ann_class_name(node.value)
        if base in ("Optional", "Final"):
            return _ann_class_name(node.slice)
        return None  # dict[...]/list[...] element types stay untyped
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _joined_prefix(node: ast.JoinedStr) -> str:
    parts = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            break
    return "".join(parts).rstrip("-_ .")


class _ModuleScanner:
    """Pass A: structure (classes, methods, locks, guards, imports)."""

    def __init__(self, name: str, path: str, src: str):
        self.info = ModuleInfo(name=name, path=path)
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)

    def _comment_guard(self, line: int) -> Guard | None:
        if 1 <= line <= len(self.lines):
            m = _GUARD_RE.search(self.lines[line - 1])
            if m:
                return Guard(lock=m.group("lock"),
                             reason=(m.group("reason") or "").strip(),
                             line=line)
        return None

    def _comment_holds(self, line: int) -> tuple[str, ...]:
        if 1 <= line <= len(self.lines):
            m = _HOLDS_RE.search(self.lines[line - 1])
            if m:
                return tuple(s.strip() for s in m.group("locks").split(","))
        return ()

    def scan(self) -> tuple[ModuleInfo, ast.Module]:
        mod = self.info
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mod.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    mod.from_imports[a.asname or a.name] = (
                        f"{node.module}.{a.name}"
                    )
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self._scan_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_func(node, prefix="", cls=None)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                self._module_assign(node)
        return mod, self.tree

    # -- pieces -----------------------------------------------------------

    def _lock_decl(self, value: ast.AST, derived_id: str) -> LockDecl | None:
        if not isinstance(value, ast.Call):
            return None
        fn = value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None
        )
        if name in LOCK_CTORS:
            return LockDecl(derived_id, LOCK_CTORS[name], value.lineno, None)
        if name in NAMED_CTORS:
            given = None
            if value.args and isinstance(value.args[0], ast.Constant) \
                    and isinstance(value.args[0].value, str):
                given = value.args[0].value
            return LockDecl(derived_id, NAMED_CTORS[name], value.lineno,
                            given)
        return None

    def _module_assign(self, node: ast.Assign | ast.AnnAssign) -> None:
        mod = self.info
        targets = node.targets if isinstance(node, ast.Assign) else (
            [node.target] if node.target is not None else []
        )
        value = node.value
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            derived = f"{mod.base}.{t.id}"
            decl = self._lock_decl(value, derived) if value else None
            if decl is not None:
                mod.locks[t.id] = decl
                continue
            g = self._comment_guard(node.lineno)
            if g is not None:
                mod.guards[t.id] = g

    def _scan_class(self, node: ast.ClassDef) -> None:
        mod = self.info
        ci = ClassInfo(
            fullid=f"{mod.name}:{node.name}", name=node.name,
            module=mod.name, line=node.lineno,
        )
        for b in node.bases:
            if isinstance(b, ast.Attribute):
                ci.bases.append(b.attr)
            elif isinstance(b, ast.Name):
                ci.bases.append(b.id)
        ci.is_thread = "Thread" in ci.bases
        mod.classes[node.name] = ci
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.methods[item.name] = f"{mod.name}:{node.name}.{item.name}"
                self._scan_func(item, prefix=f"{node.name}.", cls=ci)
            elif isinstance(item, ast.AnnAssign) and isinstance(
                    item.target, ast.Name):
                # dataclass-style field declaration
                ty = _ann_class_name(item.annotation)
                if ty:
                    ci.attr_types.setdefault(item.target.id, ty)
                g = self._comment_guard(item.lineno)
                if g is not None:
                    ci.guards[item.target.id] = g

    def _scan_func(self, node: ast.FunctionDef | ast.AsyncFunctionDef,
                   prefix: str, cls: ClassInfo | None) -> None:
        mod = self.info
        qual = f"{mod.name}:{prefix}{node.name}"
        fi = FunctionInfo(qualname=qual, module=mod.name,
                          cls=cls.fullid if cls else None, line=node.lineno)
        fi.holds = self._comment_holds(node.lineno)
        mod.functions[f"{prefix}{node.name}"] = qual
        self._funcs.append((fi, node, cls))
        # class structure harvested from method bodies: self.X = ...
        if cls is not None:
            ann = {
                a.arg: _ann_class_name(a.annotation)
                for a in (node.args.posonlyargs + node.args.args
                          + node.args.kwonlyargs)
            }
            for sub in ast.walk(node):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    continue
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    if not (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        continue
                    attr = t.attr
                    cls.attr_writes.setdefault(attr, set()).add(qual)
                    decl = self._lock_decl(
                        sub.value, f"{cls.name}.{attr}"
                    ) if sub.value else None
                    if decl is not None:
                        cls.locks[attr] = decl
                        continue
                    if self._is_event_ctor(sub.value):
                        cls.events.add(attr)
                    g = self._comment_guard(sub.lineno)
                    if g is not None and attr not in cls.guards:
                        cls.guards[attr] = g
                    ty = self._value_class_name(sub.value, ann)
                    if isinstance(sub, ast.AnnAssign) and ty is None:
                        ty = _ann_class_name(sub.annotation)
                    if ty:
                        cls.attr_types.setdefault(attr, ty)
        # nested defs become their own functions
        for sub in node.body:
            self._collect_nested(sub, f"{prefix}{node.name}.", cls)

    def _collect_nested(self, node: ast.AST, prefix: str,
                        cls: ClassInfo | None) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._scan_func(node, prefix=prefix, cls=cls)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                continue
            self._collect_nested(child, prefix, cls)

    @staticmethod
    def _is_event_ctor(value: ast.AST | None) -> bool:
        return (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr == "Event")

    def _value_class_name(self, value: ast.AST | None,
                          param_ann: dict[str, str | None]) -> str | None:
        """Class name of ``self.x = <value>``: a constructor call, an
        annotated-parameter passthrough, or either branch of a
        conditional expression."""
        if value is None:
            return None
        if isinstance(value, ast.IfExp):
            return (self._value_class_name(value.body, param_ann)
                    or self._value_class_name(value.orelse, param_ann))
        if isinstance(value, ast.BoolOp):
            for v in value.values:
                got = self._value_class_name(v, param_ann)
                if got:
                    return got
            return None
        if isinstance(value, ast.Name):
            return param_ann.get(value.id)
        if isinstance(value, ast.Call):
            fn = value.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None
            )
            if name and name[:1].isupper():
                return name
        return None

    _funcs: list  # set in scan_all


# --- program-level scan --------------------------------------------------


def scan(root: str, pkg: str | None = None,
         return_types: dict[str, str] | None = None) -> Program:
    """Scan the package directory ``root`` into a :class:`Program`."""
    pkg = pkg or os.path.basename(os.path.abspath(root))
    scanners: list[tuple[_ModuleScanner, ast.Module]] = []
    prog = Program(modules={}, functions={}, classes={})
    pending: list[tuple[ModuleInfo, ast.Module, _ModuleScanner]] = []
    for name, path in _py_modules(root, pkg):
        with open(path, encoding="utf-8") as f:
            src = f.read()
        sc = _ModuleScanner(name, path, src)
        sc._funcs = []
        mod, tree = sc.scan()
        prog.modules[name] = mod
        for ci in mod.classes.values():
            prog.classes[ci.fullid] = ci
        pending.append((mod, tree, sc))
    # pass B needs every module's structure for cross-module typing
    res = _Resolver(prog, return_types or {})
    for mod, tree, sc in pending:
        for fi, node, cls in sc._funcs:
            prog.functions[fi.qualname] = fi
            _BehaviorWalker(res, mod, cls, fi).run(node)
    return prog


class _Resolver:
    """Name/type resolution shared by the behavior walkers."""

    def __init__(self, prog: Program, return_types: dict[str, str]):
        self.prog = prog
        self.return_types = return_types
        self.class_by_name: dict[str, list[ClassInfo]] = {}
        for ci in prog.classes.values():
            self.class_by_name.setdefault(ci.name, []).append(ci)

    def class_named(self, name: str | None,
                    prefer_module: str | None = None) -> ClassInfo | None:
        if not name:
            return None
        cands = self.class_by_name.get(name, [])
        if not cands:
            return None
        if prefer_module:
            for c in cands:
                if c.module == prefer_module:
                    return c
        return cands[0]

    def module_of_alias(self, mod: ModuleInfo, alias: str) -> str | None:
        return mod.imports.get(alias)

    def from_import(self, mod: ModuleInfo, name: str) -> str | None:
        return mod.from_imports.get(name)


class _BehaviorWalker:
    """Pass B: per-function facts — calls, acquisitions, accesses, and
    thread spawns, each recorded with the lexically-held lock set."""

    def __init__(self, res: _Resolver, mod: ModuleInfo,
                 cls: ClassInfo | None, fi: FunctionInfo):
        self.res = res
        self.mod = mod
        self.cls = cls
        self.fi = fi
        self.local_types: dict[str, ClassInfo] = {}
        self.held: list[str] = [self._lock_id_of_name(h) for h in fi.holds]
        self.held = [h for h in self.held if h]

    # -- identities -------------------------------------------------------

    def _lock_id_of_name(self, name: str) -> str | None:
        """Resolve a ``# holds:``/``# guard:`` name to a full lock id."""
        if "." in name:
            return name
        if self.cls is not None and name in self.cls.locks:
            return self.cls.locks[name].lock_id
        if name in self.mod.locks:
            return self.mod.locks[name].lock_id
        if self.cls is not None:
            return f"{self.cls.name}.{name}"
        return f"{self.mod.base}.{name}"

    def _type_of_expr(self, node: ast.AST) -> ClassInfo | None:
        if isinstance(node, ast.Name):
            if node.id == "self":
                return self.cls
            return self.local_types.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._type_of_expr(node.value)
            if base is not None:
                ty = base.attr_types.get(node.attr)
                return self.res.class_named(ty, prefer_module=base.module)
            return None
        if isinstance(node, ast.Call):
            tgt = self._resolve_call_target(node.func)
            if tgt is None:
                return None
            if tgt in self.res.return_types:
                return self.res.prog.classes.get(self.res.return_types[tgt])
            return self.res.prog.classes.get(tgt)
        return None

    def _lock_of_expr(self, node: ast.AST) -> str | None:
        """Lock id of a ``with`` context expression, if it is a declared
        lock attribute (``self._x``, ``obj._x`` for a typed obj, or a
        module-level lock name)."""
        if isinstance(node, ast.Name):
            decl = self.mod.locks.get(node.id)
            return decl.lock_id if decl else None
        if isinstance(node, ast.Attribute):
            owner = self._type_of_expr(node.value)
            if owner is not None:
                decl = owner.locks.get(node.attr)
                if decl is not None:
                    return decl.lock_id
        return None

    # -- call resolution --------------------------------------------------

    def _resolve_call_target(self, fn: ast.AST) -> str | None:
        prog = self.res.prog
        if isinstance(fn, ast.Name):
            name = fn.id
            # nested def in the current scope chain, innermost first
            local = self.fi.qualname.split(":", 1)[1]
            parts = local.split(".")
            for i in range(len(parts), 0, -1):
                cand = ".".join(parts[:i] + [name])
                if cand in self.mod.functions:
                    return self.mod.functions[cand]
            if name in self.mod.functions:
                return self.mod.functions[name]
            if name in self.mod.classes:
                ci = self.mod.classes[name]
                return ci.fullid
            dotted = self.mod.from_imports.get(name)
            if dotted:
                m, _, attr = dotted.rpartition(".")
                tgt = prog.modules.get(m)
                if tgt is not None:
                    if attr in tgt.functions:
                        return tgt.functions[attr]
                    if attr in tgt.classes:
                        return tgt.classes[attr].fullid
                return dotted
            return None
        if isinstance(fn, ast.Attribute):
            # typed receiver -> method
            owner = self._type_of_expr(fn.value)
            if owner is not None:
                if fn.attr in owner.methods:
                    return owner.methods[fn.attr]
                return None
            # module alias -> module function / class / external dotted
            if isinstance(fn.value, ast.Name):
                dotted_mod = self.mod.imports.get(fn.value.id)
                if dotted_mod:
                    tgt = prog.modules.get(dotted_mod)
                    if tgt is not None:
                        if fn.attr in tgt.functions:
                            return tgt.functions[fn.attr]
                        if fn.attr in tgt.classes:
                            return tgt.classes[fn.attr].fullid
                    return f"{dotted_mod}.{fn.attr}"
                # from-imported class used as namespace? rare; give up
            return None
        return None

    # -- walking ----------------------------------------------------------

    def run(self, node: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        ann = {
            a.arg: _ann_class_name(a.annotation)
            for a in (node.args.posonlyargs + node.args.args
                      + node.args.kwonlyargs)
        }
        for pname, ty in ann.items():
            ci = self.res.class_named(ty, prefer_module=self.mod.name)
            if ci is not None:
                self.local_types[pname] = ci
        self._prepass_types(node.body)
        for stmt in node.body:
            self._visit_stmt(stmt)

    def _prepass_types(self, body: list[ast.stmt]) -> None:
        """Straight-line local type inference: ``x = Cls(...)``,
        ``x = self.attr`` for a typed attr, ``x = mod.fn()`` with a
        known return type."""
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if not isinstance(sub, ast.Assign) or len(sub.targets) != 1:
                    continue
                t = sub.targets[0]
                if not isinstance(t, ast.Name):
                    continue
                ci = self._type_of_expr(sub.value)
                if ci is not None:
                    self.local_types.setdefault(t.id, ci)

    def _visit_stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs are separate FunctionInfos
        if isinstance(node, ast.With):
            self._visit_with(node)
            return
        for expr in self._stmt_exprs(node):
            self._visit_expr(expr)
        for child in self._stmt_blocks(node):
            self._visit_stmt(child)

    @staticmethod
    def _stmt_exprs(node: ast.stmt):
        for field, value in ast.iter_fields(node):
            if isinstance(value, ast.expr):
                yield value
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        yield v

    @staticmethod
    def _stmt_blocks(node: ast.stmt):
        for field in ("body", "orelse", "finalbody"):
            for child in getattr(node, field, []) or []:
                if isinstance(child, ast.stmt):
                    yield child
        for h in getattr(node, "handlers", []) or []:
            for child in h.body:
                yield child

    def _visit_with(self, node: ast.With) -> None:
        entered: list[str] = []
        for item in node.items:
            lock_id = self._lock_of_expr(item.context_expr)
            if lock_id is not None:
                self.fi.acquires.append(AcquireEvent(
                    lock=lock_id, line=item.context_expr.lineno,
                    held=tuple(self.held)))
                self.held.append(lock_id)
                entered.append(lock_id)
            else:
                self._visit_expr(item.context_expr)
        for child in node.body:
            self._visit_stmt(child)
        for _ in entered:
            self.held.pop()

    def _visit_expr(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._record_call(sub)
            elif isinstance(sub, ast.Attribute):
                self._record_access(sub)
            elif isinstance(sub, ast.Name):
                self._record_global_access(sub)

    def _record_access(self, node: ast.Attribute) -> None:
        owner = self._type_of_expr(node.value)
        if owner is None:
            return
        is_store = isinstance(node.ctx, (ast.Store, ast.Del))
        self.fi.accesses.append(Access(
            owner=owner.fullid, attr=node.attr, is_store=is_store,
            line=node.lineno, held=tuple(self.held)))

    def _record_global_access(self, node: ast.Name) -> None:
        if node.id not in self.mod.guards:
            return
        is_store = isinstance(node.ctx, (ast.Store, ast.Del))
        self.fi.accesses.append(Access(
            owner=f"{self.mod.name}:", attr=node.id, is_store=is_store,
            line=node.lineno, held=tuple(self.held)))

    def _record_call(self, node: ast.Call) -> None:
        target = self._resolve_call_target(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        # string-literal receivers (", ".join) are never blocking calls
        if attr is not None and isinstance(node.func.value, ast.Constant):
            attr = None
        self.fi.calls.append(CallEvent(
            target=target, attr=attr, line=node.lineno,
            held=tuple(self.held)))
        if target == "threading.Thread":
            self._record_spawn(node)
        elif target is not None and ":" not in target \
                and target.endswith(".Thread"):
            self._record_spawn(node)
        else:
            ci = self.res.prog.classes.get(target) if target else None
            if ci is not None and ci.is_thread:
                run_q = ci.methods.get("run")
                self.fi.spawns.append(ThreadSpawn(
                    role=ci.name, target=run_q, line=node.lineno))

    def _record_spawn(self, node: ast.Call) -> None:
        role = None
        target_q = None
        for kw in node.keywords:
            if kw.arg == "name":
                if isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    role = kw.value.value
                elif isinstance(kw.value, ast.JoinedStr):
                    role = _joined_prefix(kw.value) or None
            elif kw.arg == "target":
                target_q = self._resolve_call_target(kw.value)
        if role is None:
            if target_q is not None:
                role = f"{self.mod.base}.{target_q.rsplit('.', 1)[-1]}"
            else:
                role = f"{self.mod.base}.anon-thread"
        self.fi.spawns.append(ThreadSpawn(
            role=role, target=target_q, line=node.lineno))
