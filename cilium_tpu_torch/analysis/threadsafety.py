"""thread-safety: guarded-field inference + atomicity for the
threaded serving plane.

Upstream cilium leans on Go's dynamic race detector; our serving
plane is threaded Python (pack thread, stream workers, fleet
heartbeats, autojump clock threads) with no equivalent — a review by
hand once found five real data races in it. This rule family
recovers most of that class statically:

1. **thread-root discovery** — every ``threading.Thread(target=…)``,
   executor ``submit``, callable handed to a thread-owning class
   constructor (the ``Controller(name, fn)`` idiom), and handler
   entry point becomes a concurrency root; reachability over the
   call graph tells which methods run on which roots.
2. **guarded-field inference** — for each lock-owning class in the
   serving scope, infer each mutated attribute's guard by majority
   vote over lock-held mutation sites (``Condition(self._lock)``
   aliasing reused from lock-order), then flag mutations, compound
   ``+=`` reads, and guarded-container reads outside the inferred
   guard. Each finding names the two racing roots.
3. **atomicity / check-then-act** — a value read out of a guarded
   container and validated under a lock, then acted on after
   release (the lease race of ``tests/analysis_corpus``), and
   lock-release windows
   inside read-modify-write sequences on guarded containers.
4. **publication safety** — ``__init__`` starting a thread or
   handing ``self`` to a registry before later field assignments.

Heuristics are tuned to miss rather than invent (the shared-core
bias): classes that own no lock are out of scope (flag-attribute
classes like ``HostReplica`` are a documented false-negative class),
monotonic boolean latches (``while not self._stop``) are not
check-then-act, and findings are scoped to ``<package>/runtime/`` +
``engine/ring.py`` — the serving plane the rule family exists for —
while root discovery scans the whole tree.
"""

from __future__ import annotations

import ast
from collections import Counter
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cilium_tpu_torch.analysis.callgraph import ModuleInfo, dotted, project_for
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker
from cilium_tpu_torch.analysis.locks import (ClassModel, _Analyzer, _fmt_key,
                                       analyzer_for)

RULE = "thread-safety"

#: finding scope: the threaded serving plane (wall-clock precedent).
#: Root discovery still scans every indexed module.
#: Paths relative to the run's package (``ProjectIndex.rel``).
SCOPE_PREFIXES: Tuple[str, ...] = ("runtime/",)
SCOPE_FILES: Tuple[str, ...] = ("engine/ring.py",)

#: method names that mutate their receiver container in place
_MUT_METHODS = frozenset({
    "append", "extend", "insert", "add", "discard", "remove", "pop",
    "popitem", "popleft", "appendleft", "clear", "update",
    "setdefault", "sort", "reverse",
})

#: method names that read a container without mutating it
_READ_METHODS = frozenset({"get", "items", "keys", "values", "copy",
                           "count", "index"})

#: constructors whose result is a shared mutable container
_CONTAINER_CTORS = frozenset({
    "dict", "list", "set", "collections.OrderedDict",
    "collections.defaultdict", "collections.deque", "heapq",
})

_EXECUTOR_CTORS = frozenset({
    "concurrent.futures.ThreadPoolExecutor",
    "concurrent.futures.ProcessPoolExecutor",
    "futures.ThreadPoolExecutor",
    "ThreadPoolExecutor",
})

#: builtins that take the instance without publishing it — calling
#: ``id(self)`` / ``repr(self)`` in ``__init__`` is not an escape
_BENIGN_CALLS = frozenset({
    "id", "len", "str", "repr", "hash", "type", "isinstance",
    "issubclass", "format", "int", "float", "bool", "print", "vars",
    "getattr", "setattr", "hasattr", "super", "weakref.ref",
})

#: mutating access kinds (guard inference votes over these)
_MUT_KINDS = frozenset({"write", "aug", "item", "itemaug", "itemdel",
                        "mutcall"})


def in_scope(path: str, package: str) -> bool:
    return path in {f"{package}/{f}" for f in SCOPE_FILES} or \
        any(path.startswith(f"{package}/{p}") for p in SCOPE_PREFIXES)


class _Access:
    """One touch of ``self.<attr>`` inside a method."""

    __slots__ = ("attr", "kind", "held", "line", "fn")

    def __init__(self, attr: str, kind: str, held: Tuple[str, ...],
                 line: int, fn: str):
        self.attr = attr
        self.kind = kind      # write|aug|item|itemaug|itemdel|mutcall
        self.held = held      # canonical lock ids held at the site
        self.line = line      # |read|testread
        self.fn = fn          # method name


# ---------------------------------------------------------------- roots

def discover_roots(a: _Analyzer) -> Dict[Tuple, Set[str]]:
    """Seed concurrency roots: callable key → root labels.

    A root is code that begins executing on its own thread: a
    ``threading.Thread`` target, an executor ``submit`` callable, a
    callable passed into the constructor of a class that itself
    starts threads (``Controller(name, fn=…)``), or a request-handler
    method (``*Handler.handle*`` / ``do_*``)."""
    project = a.project
    seeds: Dict[Tuple, Set[str]] = {}

    def seed(key: Optional[Tuple], label: str) -> None:
        if key is not None:
            seeds.setdefault(key, set()).add(label)

    # pass 1: classes that start threads anywhere in their body take
    # constructor callables as roots (the thread-owner idiom)
    thread_owners: Set[Tuple[str, str]] = set()
    for mi in project.modules.values():
        for cls in mi.classes.values():
            for node in ast.walk(cls):
                if isinstance(node, ast.Call) and \
                        mi.qualify(node.func) == "threading.Thread":
                    thread_owners.add((mi.sf.module, cls.name))
                    break

    def resolve_callable(mi: ModuleInfo, cls_name: Optional[str],
                         expr: ast.AST) -> Optional[Tuple]:
        d = dotted(expr)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] == "self" and cls_name is not None \
                and len(parts) == 2:
            return ("method", mi.sf.module, cls_name, parts[1])
        if len(parts) == 1:
            r = project.resolve_function(mi, d)
            if r is not None:
                return ("func", r[0].sf.module,
                        getattr(r[1], "name", d))
        return None

    def scan_fn(mi: ModuleInfo, cls_name: Optional[str],
                fn: ast.AST) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            q = mi.qualify(node.func)
            d = dotted(node.func)
            if q == "threading.Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        key = resolve_callable(mi, cls_name, kw.value)
                        if key is not None:
                            seed(key, f"thread:{_fmt_key(key)}")
            elif d is not None and d.endswith(".submit") and node.args:
                key = resolve_callable(mi, cls_name, node.args[0])
                if key is not None:
                    seed(key, f"executor:{_fmt_key(key)}")
            elif d is not None and "." not in d:
                r = project.resolve_class(mi, d)
                if r is not None and (r[0].sf.module, r[1].name) \
                        in thread_owners:
                    cargs = list(node.args) + \
                        [kw.value for kw in node.keywords]
                    for arg in cargs:
                        key = resolve_callable(mi, cls_name, arg)
                        if key is not None:
                            seed(key, f"thread:{r[1].name}"
                                      f"({_fmt_key(key)})")

    for mi in project.modules.values():
        for fn in mi.functions.values():
            scan_fn(mi, None, fn)
        for cls in mi.classes.values():
            for node in cls.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    scan_fn(mi, cls.name, node)
                    if (node.name.startswith(("handle", "do_"))
                            and cls.name.endswith(("Handler",
                                                   "Server"))):
                        key = ("method", mi.sf.module, cls.name,
                               node.name)
                        seed(key, f"handler:{_fmt_key(key)}")
    return seeds


def reachable_roots(a: _Analyzer,
                    seeds: Dict[Tuple, Set[str]]
                    ) -> Dict[Tuple, Set[str]]:
    """Propagate root labels over the call graph to a fixpoint."""
    reach: Dict[Tuple, Set[str]] = {k: set(v)
                                    for k, v in seeds.items()}
    work = list(seeds)
    while work:
        key = work.pop()
        labels = reach.get(key)
        s = a.summaries.get(key)
        if s is None or not labels:
            continue
        for _held, callee, _line in s.calls:
            cur = reach.setdefault(callee, set())
            if not labels <= cur:
                cur.update(labels)
                work.append(callee)
    return reach


# ------------------------------------------------------------- visitor

class _TSVisitor(ast.NodeVisitor):
    """Per-method pass: attribute accesses with held-lock context,
    with-block structure (for check-then-act and release windows),
    and local-name validation tracking."""

    def __init__(self, a: _Analyzer, mi: ModuleInfo, cm: ClassModel,
                 fn_name: str, module_locks: Dict[str, str]):
        self.a = a
        self.mi = mi
        self.cm = cm
        self.fn = fn_name
        self.module_locks = module_locks
        self.held: List[str] = []
        self.accesses: List[_Access] = []
        #: name → (source attr, guard lock, bind line), survives the
        #: with-block that validated it
        self.validated: Dict[str, Tuple[str, str, int]] = {}
        #: active with-block records (innermost last)
        self.blocks: List[Dict] = []
        #: lock id → {attr: line} read under a with-block that has
        #: since been released (release-window detection)
        self.released_reads: Dict[str, Dict[str, int]] = {}
        #: (kind, line, detail) raw atomicity events; the class pass
        #: turns them into findings once guards are known
        self.events: List[Tuple[str, int, Dict]] = []

    # -- lock resolution (mirrors lock-order, canonical ids) --------
    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        d = dotted(expr)
        if d is None:
            return None
        if d.startswith("self."):
            attr = d.split(".", 1)[1]
            if "." in attr:
                return None
            return self.cm.lock_id(attr)
        if "." not in d and d in self.module_locks:
            return f"{self.mi.sf.module}.{d}"
        return None

    def _is_self_lock_attr(self, attr: str) -> bool:
        return self.cm.lock_id(attr) is not None

    def _record(self, attr: str, kind: str, line: int) -> None:
        if self._is_self_lock_attr(attr):
            return
        self.accesses.append(_Access(
            attr, kind, tuple(self.held), line, self.fn))
        for rec in self.blocks:
            if kind in _MUT_KINDS:
                if attr not in rec["reads"]:
                    rec["first_writes"].setdefault(attr, line)
                rec["writes"].setdefault(attr, line)
                if kind in ("itemaug", "aug"):
                    rec["reads"].setdefault(attr, line)
            elif kind in ("read", "testread"):
                rec["reads"].setdefault(attr, line)

    # -- with blocks ------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            lock = self._resolve_lock(item.context_expr)
            if lock is not None:
                self.held.append(lock)
                acquired.append(lock)
        rec = None
        if len(acquired) >= 1:
            rec = {"locks": tuple(acquired), "reads": {},
                   "writes": {}, "first_writes": {}, "binds": {},
                   "tested": set(), "tests": [], "line": node.lineno}
            self.blocks.append(rec)
        for stmt in node.body:
            self.visit(stmt)
        if rec is not None:
            self.blocks.pop()
            self._close_block(rec)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def _close_block(self, rec: Dict) -> None:
        for lock in rec["locks"]:
            prior = self.released_reads.get(lock, {})
            for attr, line in rec["first_writes"].items():
                if attr not in prior:
                    continue
                # a guarded test BEFORE the write re-validates state
                # under the re-acquired lock (the ring re-insert /
                # generation-check idiom) — not a lost-update window
                if any(t <= line for t in rec["tests"]):
                    continue
                self.events.append(("release-window", line, {
                    "attr": attr, "lock": lock,
                    "read_line": prior[attr]}))
            merged = self.released_reads.setdefault(lock, {})
            for attr, line in rec["reads"].items():
                merged.setdefault(attr, line)
        for name, (attr, line) in rec["binds"].items():
            if name in rec["tested"]:
                self.validated[name] = (attr, rec["locks"][0], line)

    # -- statements -------------------------------------------------
    def _bound_container_attr(self, value: ast.AST) -> Optional[str]:
        """``self.<attr>[k]`` / ``self.<attr>.get(k)`` /
        ``self.<attr>.pop(k)`` → attr."""
        if isinstance(value, ast.Subscript):
            d = dotted(value.value)
        elif isinstance(value, ast.Call) and \
                isinstance(value.func, ast.Attribute) and \
                value.func.attr in ("get", "pop", "setdefault"):
            d = dotted(value.func.value)
        else:
            return None
        if d and d.startswith("self.") and d.count(".") == 1:
            return d.split(".", 1)[1]
        return None

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._target(tgt, "write")
            if isinstance(tgt, ast.Name):
                self.validated.pop(tgt.id, None)
                if self.blocks:
                    attr = self._bound_container_attr(node.value)
                    if attr is not None and \
                            not self._is_self_lock_attr(attr):
                        self.blocks[-1]["binds"][tgt.id] = \
                            (attr, node.lineno)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._target(node.target, "write")
        if node.value is not None:
            self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._target(node.target, "aug")
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            self._target(tgt, "del")

    def _target(self, tgt: ast.AST, base_kind: str) -> None:
        if isinstance(tgt, ast.Attribute) and \
                isinstance(tgt.value, ast.Name) and \
                tgt.value.id == "self":
            self._record(tgt.attr, base_kind, tgt.lineno)
        elif isinstance(tgt, ast.Subscript):
            d = dotted(tgt.value)
            if d and d.startswith("self.") and d.count(".") == 1:
                kind = {"write": "item", "aug": "itemaug",
                        "del": "itemdel"}[base_kind]
                self._record(d.split(".", 1)[1], kind, tgt.lineno)
            else:
                self.visit(tgt.value)
            self.visit(tgt.slice)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._target(el, base_kind)

    # -- tests (check-then-act reads) -------------------------------
    def _scan_test(self, test: ast.AST) -> None:
        for sub in ast.walk(test):
            if isinstance(sub, ast.Attribute) and \
                    isinstance(sub.value, ast.Name) and \
                    sub.value.id == "self" and \
                    isinstance(sub.ctx, ast.Load):
                self._record(sub.attr, "testread", sub.lineno)
                for rec in self.blocks:
                    rec["tests"].append(sub.lineno)
            elif isinstance(sub, ast.Name) and self.blocks:
                self.blocks[-1]["tested"].add(sub.id)

    # exclusive branches must not pair with each other: a read under
    # the lock in the `on_data` arm never precedes a write in the
    # `close_connection` arm. Visit each branch from the pre-branch
    # state and union the outcomes (may-analysis).
    def _visit_branches(self, suites: List[List[ast.AST]]) -> None:
        base_reads = {lock: dict(d)
                      for lock, d in self.released_reads.items()}
        base_valid = dict(self.validated)
        out_reads: Dict[str, Dict[str, int]] = {}
        out_valid: Dict[str, Tuple[str, str, int]] = {}
        merged_any = False
        for suite in suites:
            self.released_reads = {lock: dict(d)
                                   for lock, d in base_reads.items()}
            self.validated = dict(base_valid)
            for stmt in suite:
                self.visit(stmt)
            # a branch that cannot fall through (return/raise/...)
            # contributes nothing to the post-branch state
            if suite and isinstance(suite[-1], (ast.Return, ast.Raise,
                                                ast.Continue,
                                                ast.Break)):
                continue
            merged_any = True
            for lock, d in self.released_reads.items():
                merged = out_reads.setdefault(lock, {})
                for attr, line in d.items():
                    merged.setdefault(attr, line)
            out_valid.update(self.validated)
        if not merged_any:
            out_reads = base_reads
            out_valid = base_valid
        self.released_reads = out_reads
        self.validated = out_valid

    def visit_If(self, node: ast.If) -> None:
        self._scan_test(node.test)
        self.visit(node.test)
        self._visit_branches([node.body, node.orelse])

    def visit_Try(self, node: ast.Try) -> None:
        self._visit_branches(
            [node.body + node.orelse]
            + [h.body for h in node.handlers])
        for stmt in node.finalbody:
            self.visit(stmt)

    def visit_While(self, node: ast.While) -> None:
        self._scan_test(node.test)
        self.visit(node.test)
        self._visit_branches([node.body, node.orelse])

    # -- calls ------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            d = dotted(func.value)
            if d and d.startswith("self.") and d.count(".") == 1:
                attr = d.split(".", 1)[1]
                if func.attr in _MUT_METHODS:
                    self._record(attr, "mutcall", node.lineno)
                elif func.attr in _READ_METHODS:
                    self._record(attr, "read", node.lineno)
            # act-after-release: method call on a validated object
            root = func.value
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and \
                    root.id in self.validated:
                attr, lock, bind_line = self.validated[root.id]
                if lock not in self.held:
                    self.events.append(("check-then-act",
                                        node.lineno, {
                                            "name": root.id,
                                            "attr": attr,
                                            "lock": lock,
                                            "bind_line": bind_line}))
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.value, ast.Name) and \
                node.value.id == "self" and \
                isinstance(node.ctx, ast.Load):
            self._record(node.attr, "read", node.lineno)
        self.generic_visit(node)

    # nested defs run when called, not here (lock-order precedent)
    def visit_FunctionDef(self, node):  # noqa: D102
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


# --------------------------------------------------------- class pass

class _ClassReport:
    def __init__(self, mi: ModuleInfo, cls: ast.ClassDef,
                 cm: ClassModel):
        self.mi = mi
        self.cls = cls
        self.cm = cm
        #: method name → _TSVisitor
        self.methods: Dict[str, _TSVisitor] = {}
        #: attrs initialized to mutable containers in __init__
        self.containers: Set[str] = set()
        #: classmethod/staticmethod names — no implicit caller root
        self.classmethods: Set[str] = set()
        #: method name → inherited caller-held lock context
        self.ctx: Dict[str, Tuple[str, ...]] = {}


def _scan_class(a: _Analyzer, mi: ModuleInfo, cls: ast.ClassDef,
                module_locks: Dict[str, str]) -> _ClassReport:
    cm = a.classes[(mi.sf.module, cls.name)]
    rep = _ClassReport(mi, cls, cm)
    for node in cls.body:
        if not isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            continue
        v = _TSVisitor(a, mi, cm, node.name, module_locks)
        for stmt in node.body:
            v.visit(stmt)
        rep.methods[node.name] = v
        for dec in node.decorator_list:
            if isinstance(dec, ast.Name) and \
                    dec.id in ("classmethod", "staticmethod"):
                rep.classmethods.add(node.name)
        if node.name == "__init__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) and \
                        len(sub.targets) == 1:
                    tgt, val = sub.targets[0], sub.value
                elif isinstance(sub, ast.AnnAssign) and \
                        sub.value is not None:
                    tgt, val = sub.target, sub.value
                else:
                    continue
                if not (isinstance(tgt, ast.Attribute) and
                        isinstance(tgt.value, ast.Name) and
                        tgt.value.id == "self"):
                    continue
                is_container = isinstance(
                    val, (ast.Dict, ast.List, ast.Set,
                          ast.ListComp, ast.DictComp, ast.SetComp))
                if isinstance(val, ast.Call):
                    q = mi.qualify(val.func) or ""
                    is_container = q in _CONTAINER_CTORS
                if is_container:
                    rep.containers.add(tgt.attr)
    return rep


def _caller_context(rep: _ClassReport, roots: Dict[Tuple, Set[str]]
                    ) -> None:
    """Private methods inherit the intersection of their same-class
    callers' held locks — ``_release_locked`` is only ever called
    with ``self._lock`` held, so its body counts as guarded. Public
    methods and thread roots get the empty context."""
    mod, cname = rep.cm.module, rep.cm.name
    #: method → call sites [(caller, held-at-site)]
    sites: Dict[str, List[Tuple[str, Tuple[str, ...]]]] = {}

    # light walk: find self.<m>() call sites per method with held locks
    class _CallSites(ast.NodeVisitor):
        def __init__(self, outer: _TSVisitor, caller: str):
            self.outer = outer
            self.caller = caller
            self.held: List[str] = []

        def visit_With(self, node: ast.With) -> None:
            acquired = []
            for item in node.items:
                lock = self.outer._resolve_lock(item.context_expr)
                if lock is not None:
                    self.held.append(lock)
                    acquired.append(lock)
            for stmt in node.body:
                self.visit(stmt)
            for _ in acquired:
                self.held.pop()

        visit_AsyncWith = visit_With

        def visit_Call(self, node: ast.Call) -> None:
            d = dotted(node.func)
            if d and d.startswith("self.") and d.count(".") == 1:
                sites.setdefault(d.split(".", 1)[1], []).append(
                    (self.caller, tuple(self.held)))
            self.generic_visit(node)

        def visit_FunctionDef(self, node):  # noqa: D102
            pass

        visit_AsyncFunctionDef = visit_FunctionDef
        visit_Lambda = visit_FunctionDef

    fn_nodes = {n.name: n for n in rep.cls.body
                if isinstance(n, (ast.FunctionDef,
                                  ast.AsyncFunctionDef))}
    for caller_name, node in fn_nodes.items():
        cs = _CallSites(rep.methods[caller_name], caller_name)
        for stmt in node.body:
            cs.visit(stmt)

    # fixpoint: ctx(m) = ⋂ over sites (held ∪ ctx(caller))
    ctx: Dict[str, Optional[Set[str]]] = {}
    for name in rep.methods:
        key = ("method", mod, cname, name)
        is_private = name.startswith("_") and not name.startswith("__")
        if not is_private or key in roots or name not in sites:
            ctx[name] = set()
        else:
            ctx[name] = None  # unknown (⊤)
    for _ in range(len(rep.methods) + 2):
        changed = False
        for name in rep.methods:
            if ctx[name] is not None and not ctx[name]:
                continue
            acc: Optional[Set[str]] = None
            for caller, held in sites.get(name, ()):
                inherit = ctx.get(caller, set())
                if inherit is None:
                    continue  # caller still unknown: no constraint yet
                eff = set(held) | inherit
                acc = eff if acc is None else (acc & eff)
            if acc is None:
                continue  # every caller unknown — stay unresolved
            if acc != ctx[name]:
                ctx[name] = acc
                changed = True
        if not changed:
            break
    for name in rep.methods:
        rep.ctx[name] = tuple(sorted(ctx[name] or ()))


def _self_locks(cm: ClassModel) -> Set[str]:
    return {cm.lock_id(attr) for attr in cm.locks}


# ----------------------------------------------------------- findings

def _class_findings(rep: _ClassReport, a: _Analyzer,
                    roots: Dict[Tuple, Set[str]]) -> List[Finding]:
    mod, cname = rep.cm.module, rep.cm.name
    path = rep.mi.sf.path
    out: List[Finding] = []

    def method_roots(fn: str) -> List[str]:
        key = ("method", mod, cname, fn)
        labels = sorted(roots.get(key, ()))
        if labels:
            return labels
        if not fn.startswith("_") and fn not in rep.classmethods:
            return [f"caller:{mod}.{cname}.{fn}"]
        return []

    def racing_pair(fn: str, attr: str,
                    accesses: List[_Access]) -> Tuple[str, ...]:
        mine = method_roots(fn)
        first = mine[0] if mine else f"internal:{mod}.{cname}.{fn}"
        for acc in accesses:
            if acc.fn == fn:
                continue
            for other in method_roots(acc.fn):
                if other != first:
                    return (first, other)
        for other_fn in rep.methods:
            if other_fn == fn:
                continue
            for other in method_roots(other_fn):
                if other != first:
                    return (first, other)
        return (first,)

    def held_at(acc: _Access) -> Set[str]:
        return set(acc.held) | set(rep.ctx.get(acc.fn, ()))

    # gather accesses per attribute
    per_attr: Dict[str, List[_Access]] = {}
    for v in rep.methods.values():
        for acc in v.accesses:
            per_attr.setdefault(acc.attr, []).append(acc)

    guards: Dict[str, str] = {}
    for attr, accs in sorted(per_attr.items()):
        muts = [acc for acc in accs
                if acc.kind in _MUT_KINDS and acc.fn != "__init__"]
        if not muts:
            continue
        votes: Counter = Counter()
        for acc in muts:
            for lock in held_at(acc):
                votes[lock] += 1
        guard: Optional[str] = None
        if votes:
            lock, n = votes.most_common(1)[0]
            if n >= 2 and 2 * n >= len(muts):
                guard = lock
            elif attr in rep.containers and n >= 1:
                # container mixed-guard: one locked mutation site is
                # a declared protocol; unlocked siblings race it
                guard = lock
        if guard is not None:
            guards[attr] = guard
            for acc in muts:
                if guard in held_at(acc):
                    continue
                pair = racing_pair(acc.fn, attr, muts)
                out.append(Finding(
                    path, acc.line, RULE,
                    f"`{cname}.{attr}` is guarded by `{guard}` at "
                    f"{votes[guard]}/{len(muts)} mutation sites but "
                    f"mutated here without it "
                    f"(roots: {', '.join(pair)})",
                    roots=pair))
        # compound read-modify-write with NO lock at all is a lost
        # update regardless of majority — the `+=` itself races
        for acc in muts:
            if acc.kind in ("aug", "itemaug") and not held_at(acc) \
                    and guard is None:
                pair = racing_pair(acc.fn, attr, muts)
                out.append(Finding(
                    path, acc.line, RULE,
                    f"unguarded read-modify-write of "
                    f"`{cname}.{attr}` — `+=` is not atomic across "
                    f"threads (roots: {', '.join(pair)})",
                    roots=pair))

    # guarded-container reads outside the guard (get/[]/iteration of
    # a container whose mutations are locked)
    seen_reads: Set[Tuple[str, int]] = set()
    for attr, guard in sorted(guards.items()):
        if attr not in rep.containers:
            continue
        for acc in per_attr[attr]:
            if acc.kind not in ("read", "testread") or \
                    acc.fn == "__init__":
                continue
            if guard in held_at(acc):
                continue
            if (attr, acc.line) in seen_reads:
                continue
            seen_reads.add((attr, acc.line))
            pair = racing_pair(acc.fn, attr, per_attr[attr])
            what = "checked" if acc.kind == "testread" else "read"
            out.append(Finding(
                path, acc.line, RULE,
                f"`{cname}.{attr}` (guarded by `{guard}`) {what} "
                f"without the guard — racing mutation can interleave "
                f"(roots: {', '.join(pair)})",
                roots=pair))

    # atomicity events from the visitors
    for fn, v in sorted(rep.methods.items()):
        ctx_held = set(rep.ctx.get(fn, ()))
        for kind, line, d in v.events:
            if kind == "check-then-act":
                if guards.get(d["attr"]) != d["lock"]:
                    continue
                if d["lock"] in ctx_held:
                    continue
                pair = racing_pair(fn, d["attr"],
                                   per_attr.get(d["attr"], []))
                out.append(Finding(
                    path, line, RULE,
                    f"check-then-act: `{d['name']}` was read from "
                    f"`{cname}.{d['attr']}` and validated under "
                    f"`{d['lock']}` (line {d['bind_line']}) but is "
                    f"acted on here after release "
                    f"(roots: {', '.join(pair)})",
                    roots=pair))
            elif kind == "release-window":
                if d["attr"] not in rep.containers:
                    continue
                if guards.get(d["attr"]) != d["lock"]:
                    continue
                pair = racing_pair(fn, d["attr"],
                                   per_attr.get(d["attr"], []))
                out.append(Finding(
                    path, line, RULE,
                    f"lock-release window: `{cname}.{d['attr']}` "
                    f"read under `{d['lock']}` (line "
                    f"{d['read_line']}), lock released, then "
                    f"written here without re-reading — a racing "
                    f"update in the window is lost "
                    f"(roots: {', '.join(pair)})",
                    roots=pair))

    # publication safety: __init__ escapes self before construction
    # finishes assigning fields other methods rely on
    init = rep.methods.get("__init__")
    if init is not None:
        node = next((n for n in rep.cls.body
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and n.name == "__init__"), None)
        escape_line = None
        escape_what = None
        late: List[Tuple[int, str]] = []
        shared_attrs = set(per_attr)
        for stmt in (node.body if node is not None else []):
            if escape_line is None:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        d = dotted(sub.func)
                        if d and d.endswith(".start") and \
                                d.startswith("self."):
                            escape_line = sub.lineno
                            escape_what = f"`{d}()` starts a thread"
                            break
                        if d and not d.startswith("self.") and \
                                d not in _BENIGN_CALLS and any(
                                isinstance(arg, ast.Name) and
                                arg.id == "self"
                                for arg in sub.args):
                            escape_line = sub.lineno
                            escape_what = (f"`{d}(self)` publishes "
                                           f"the instance")
                            break
            elif isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Attribute) and \
                            isinstance(tgt.value, ast.Name) and \
                            tgt.value.id == "self" and \
                            tgt.attr in shared_attrs:
                        late.append((tgt.lineno, tgt.attr))
        if escape_line is not None and late:
            line, attr = late[0]
            names = ", ".join(sorted({a for _, a in late}))
            out.append(Finding(
                path, line, RULE,
                f"unsafe publication: {escape_what} at line "
                f"{escape_line} before `__init__` assigns "
                f"`{names}` — the new thread can observe a "
                f"partially-constructed `{cname}`"))
    return out


# --------------------------------------------------------------- rule

@checker
def check(index: ProjectIndex,
          scope: Optional[Sequence[str]] = None) -> List[Finding]:
    project = project_for(index)
    a = analyzer_for(project)
    seeds = discover_roots(a)
    roots = reachable_roots(a, seeds)
    findings: List[Finding] = []
    for mi in project.modules.values():
        path = mi.sf.path
        if scope is not None:
            if not any(path.startswith(p) for p in scope):
                continue
        elif not in_scope(path, index.package):
            continue
        module_locks = a.module_locks.get(mi.sf.module, {})
        for cls in mi.classes.values():
            cm = a.classes.get((mi.sf.module, cls.name))
            if cm is None or not cm.locks:
                continue  # lock-free classes: documented false-neg
            rep = _scan_class(a, mi, cls, module_locks)
            # only SEED roots zero a method's inherited context — a
            # private helper reachable from a thread via locked
            # callers still runs with those locks held
            _caller_context(rep, seeds)
            findings.extend(_class_findings(rep, a, roots))
    return findings
check.emits = (RULE,)
