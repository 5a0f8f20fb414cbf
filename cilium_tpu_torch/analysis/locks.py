"""lock-order: the static lock-acquisition graph must be cycle-free.

The runtime is threaded end to end — MicroBatcher drain workers, the
stream pipeline's three stages, the loader's swap, kvstore watches —
and nothing but convention orders their lock acquisitions. A cycle
(thread 1 holds A wanting B, thread 2 holds B wanting A) is a
production-only hang: it needs precise interleaving, so no unit test
reproduces it. This rule extracts every lock a class owns
(``self._x = threading.Lock()``; ``Condition(self._x)`` aliases to the
wrapped lock), walks ``with`` nesting plus calls made while holding
(through attribute types and module-level singletons like ``METRICS``),
and reports (a) cycles in the resulting acquired-before graph and
(b) re-acquisition of a held non-reentrant lock (a self-deadlock even
with one thread).
"""

from __future__ import annotations

import ast
import threading
from typing import Dict, List, Optional, Set, Tuple

from cilium_tpu_torch.analysis.callgraph import (ModuleInfo, Project, dotted,
                                           project_for)
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

_MEMO_LOCK = threading.Lock()


def analyzer_for(project: Project) -> "_Analyzer":
    """One shared lock analyzer per project — thread-safety reuses the
    class models and call summaries built here, and checkers now run
    concurrently, so the memo is lock-guarded."""
    with _MEMO_LOCK:
        a = getattr(project, "_ctlint_lock_analyzer", None)
        if a is None:
            a = _Analyzer(project)
            project._ctlint_lock_analyzer = a
        return a

RULE = "lock-order"

_LOCK_CTORS = {"threading.Lock": "lock", "threading.RLock": "rlock",
               "threading.Condition": "cond"}


class ClassModel:
    def __init__(self, module: str, name: str):
        self.module = module
        self.name = name
        #: attr → "lock" | "rlock"
        self.locks: Dict[str, str] = {}
        #: attr → canonical attr (Condition(self._x) → _x)
        self.alias: Dict[str, str] = {}
        #: attr → (module, class name) of the instance assigned to it
        self.attr_types: Dict[str, Tuple[str, str]] = {}

    def lock_id(self, attr: str) -> Optional[str]:
        attr = self.alias.get(attr, attr)
        if attr in self.locks:
            return f"{self.module}.{self.name}.{attr}"
        return None


class FnSummary:
    """What one callable does with locks, directly."""

    def __init__(self) -> None:
        #: (held lock ids, acquired lock id, kind, line)
        self.acquires: List[Tuple[Tuple[str, ...], str, str, int]] = []
        #: (held lock ids, callee key, line)
        self.calls: List[Tuple[Tuple[str, ...], Tuple, int]] = []


def _build_class(project: Project, mi: ModuleInfo,
                 cls: ast.ClassDef) -> ClassModel:
    cm = ClassModel(mi.sf.module, cls.name)
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"):
            continue
        if isinstance(node.value, ast.Call):
            q = mi.qualify(node.value.func)
            kind = _LOCK_CTORS.get(q or "")
            if kind == "cond":
                arg = node.value.args[0] if node.value.args else None
                d = dotted(arg) if arg is not None else None
                if d and d.startswith("self."):
                    cm.alias[tgt.attr] = d.split(".", 1)[1]
                else:
                    # Condition() wraps its own RLock — reentrant
                    cm.locks[tgt.attr] = "rlock"
                continue
            if kind is not None:
                cm.locks[tgt.attr] = kind
                continue
            fname = dotted(node.value.func)
            if fname is not None:
                resolved = project.resolve_class(
                    mi, fname.split(".", 1)[0]) \
                    if "." not in fname else None
                if "." not in fname and resolved is not None:
                    tmi, tcls = resolved
                    cm.attr_types[tgt.attr] = (tmi.sf.module, tcls.name)
    return cm


def _singletons(project: Project) -> Dict[str, Tuple[str, str]]:
    """fully-qualified module-level name → (module, class) for
    ``NAME = SomeClass(...)`` instances (METRICS, TRACER, ...)."""
    out: Dict[str, Tuple[str, str]] = {}
    for mi in project.modules.values():
        for name, value in mi.constants.items():
            if not isinstance(value, ast.Call):
                continue
            fname = dotted(value.func)
            if fname is None or "." in fname:
                continue
            resolved = project.resolve_class(mi, fname)
            if resolved is not None:
                tmi, tcls = resolved
                out[f"{mi.sf.module}.{name}"] = (tmi.sf.module,
                                                 tcls.name)
    return out


def _module_locks(mi: ModuleInfo) -> Dict[str, str]:
    """module-level NAME = threading.Lock() → kind."""
    out = {}
    for name, value in mi.constants.items():
        if isinstance(value, ast.Call):
            kind = _LOCK_CTORS.get(mi.qualify(value.func) or "")
            if kind is not None:
                out[name] = "rlock" if kind == "cond" else kind
    return out


class _FnVisitor(ast.NodeVisitor):
    def __init__(self, analyzer: "_Analyzer", mi: ModuleInfo,
                 cm: Optional[ClassModel]):
        self.a = analyzer
        self.mi = mi
        self.cm = cm
        self.held: List[Tuple[str, str]] = []  # (lock id, kind)
        self.summary = FnSummary()

    def _resolve_lock(self, expr: ast.AST) -> Optional[Tuple[str, str]]:
        d = dotted(expr)
        if d is None:
            return None
        if d.startswith("self.") and self.cm is not None:
            attr = d.split(".", 1)[1]
            if "." in attr:
                return None
            canonical = self.cm.alias.get(attr, attr)
            lid = self.cm.lock_id(attr)
            if lid is not None:
                return lid, self.cm.locks[canonical]
            return None
        if "." not in d and d in self.a.module_locks.get(
                self.mi.sf.module, {}):
            kind = self.a.module_locks[self.mi.sf.module][d]
            return f"{self.mi.sf.module}.{d}", kind
        return None

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            expr = item.context_expr
            lock = self._resolve_lock(expr)
            if lock is not None:
                held_ids = tuple(h for h, _ in self.held)
                self.summary.acquires.append(
                    (held_ids, lock[0], lock[1], node.lineno))
                self.held.append(lock)
                acquired.append(lock)
        for stmt in node.body:
            self.visit(stmt)
        for _ in acquired:
            self.held.pop()

    visit_AsyncWith = visit_With

    def _callee_key(self, call: ast.Call) -> Optional[Tuple]:
        d = dotted(call.func)
        if d is None:
            return None
        parts = d.split(".")
        if parts[0] == "self" and self.cm is not None:
            if len(parts) == 2:
                return ("method", self.cm.module, self.cm.name,
                        parts[1])
            if len(parts) == 3:
                # self.attr.m() — calls INTO the lock object itself
                # (notify/wait/acquire on a held cond) are the lock's
                # own protocol, not a foreign acquisition
                if self.cm.lock_id(parts[1]) is not None:
                    return None
                t = self.cm.attr_types.get(parts[1])
                if t is not None:
                    return ("method", t[0], t[1], parts[2])
            return None
        if len(parts) >= 2:
            root_q = self.mi.imports.get(parts[0], None)
            owner = f"{root_q or self.mi.sf.module}.{parts[0]}" \
                if root_q is None else root_q
            inst = self.a.singletons.get(
                f"{self.mi.sf.module}.{parts[0]}") \
                or self.a.singletons.get(owner)
            if inst is not None and len(parts) == 2:
                return ("method", inst[0], inst[1], parts[1])
            target = self.a.project.modules.get(owner or "")
            if target is not None and len(parts) == 2 \
                    and parts[1] in target.functions:
                return ("func", target.sf.module, parts[1])
            return None
        resolved = self.a.project.resolve_function(self.mi, d)
        if resolved is not None:
            return ("func", resolved[0].sf.module,
                    getattr(resolved[1], "name", d))
        return None

    def visit_Call(self, node: ast.Call) -> None:
        key = self._callee_key(node)
        if key is not None:
            self.summary.calls.append(
                (tuple(h for h, _ in self.held), key, node.lineno))
        self.generic_visit(node)

    # don't descend into nested defs: they run when CALLED, not here
    def visit_FunctionDef(self, node):  # noqa: D102
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef


class _Analyzer:
    def __init__(self, project: Project):
        self.project = project
        self.classes: Dict[Tuple[str, str], ClassModel] = {}
        self.module_locks: Dict[str, Dict[str, str]] = {}
        self.summaries: Dict[Tuple, FnSummary] = {}
        self.kinds: Dict[str, str] = {}
        self.singletons = _singletons(project)
        for mi in project.modules.values():
            self.module_locks[mi.sf.module] = _module_locks(mi)
            for name, kind in self.module_locks[mi.sf.module].items():
                self.kinds[f"{mi.sf.module}.{name}"] = kind
            for cls in mi.classes.values():
                cm = _build_class(project, mi, cls)
                self.classes[(mi.sf.module, cls.name)] = cm
                for attr, kind in cm.locks.items():
                    self.kinds[f"{cm.module}.{cm.name}.{attr}"] = kind
        for mi in project.modules.values():
            for cls in mi.classes.values():
                cm = self.classes[(mi.sf.module, cls.name)]
                for node in cls.body:
                    if isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        self._summarize(mi, cm, node,
                                        ("method", mi.sf.module,
                                         cls.name, node.name))
            for name, fn in mi.functions.items():
                self._summarize(mi, None, fn,
                                ("func", mi.sf.module, name))

    def _summarize(self, mi: ModuleInfo, cm: Optional[ClassModel],
                   fn: ast.AST, key: Tuple) -> None:
        v = _FnVisitor(self, mi, cm)
        for stmt in fn.body:
            v.visit(stmt)
        self.summaries[key] = v.summary

    def transitive_acquires(self, key: Tuple, _seen: Optional[Set] = None
                            ) -> Dict[str, Tuple[Tuple, int]]:
        """lock id → (callable key, line) of one acquisition site
        reachable from ``key`` (including via callees)."""
        if _seen is None:
            _seen = set()
        if key in _seen:
            return {}
        _seen.add(key)
        out: Dict[str, Tuple[Tuple, int]] = {}
        s = self.summaries.get(key)
        if s is None:
            return out
        for _held, lock, _kind, line in s.acquires:
            out.setdefault(lock, (key, line))
        for _held, callee, line in s.calls:
            for lock, site in self.transitive_acquires(
                    callee, _seen).items():
                out.setdefault(lock, site)
        return out


def _fmt_key(key: Tuple) -> str:
    return ".".join(key[1:]) if key[0] == "method" else f"{key[1]}.{key[2]}"


@checker
def check(index: ProjectIndex) -> List[Finding]:
    project = project_for(index)
    a = analyzer_for(project)
    findings: List[Finding] = []
    #: edges: held → acquired → (path, line, note)
    edges: Dict[str, Dict[str, Tuple[str, int, str]]] = {}

    for key, s in a.summaries.items():
        mi = project.modules[key[1]]
        path = mi.sf.path
        for held, lock, kind, line in s.acquires:
            if lock in held and kind != "rlock":
                findings.append(Finding(
                    path, line, RULE,
                    f"re-acquisition of held non-reentrant lock "
                    f"`{lock}` in `{_fmt_key(key)}` — self-deadlock"))
            for h in held:
                if h != lock:
                    edges.setdefault(h, {}).setdefault(
                        lock, (path, line, f"in `{_fmt_key(key)}`"))
        for held, callee, line in s.calls:
            if not held:
                continue
            reached = a.transitive_acquires(callee)
            for lock, (site_key, _site_line) in reached.items():
                for h in held:
                    if lock == h and a.kinds.get(lock) != "rlock":
                        findings.append(Finding(
                            path, line, RULE,
                            f"`{_fmt_key(key)}` holds `{h}` and calls "
                            f"`{_fmt_key(callee)}`, which re-acquires "
                            f"it (via `{_fmt_key(site_key)}`) — "
                            f"self-deadlock"))
                    elif lock != h:
                        edges.setdefault(h, {}).setdefault(
                            lock, (path, line,
                                   f"`{_fmt_key(key)}` → "
                                   f"`{_fmt_key(callee)}`"))

    # cycle detection over the acquired-before graph (DFS, each cycle
    # reported once at its lexicographically-first lock)
    def _find_cycles() -> List[List[str]]:
        cycles, state = [], {}

        def dfs(node: str, stack: List[str]) -> None:
            state[node] = 1
            stack.append(node)
            for nxt in sorted(edges.get(node, ())):
                if state.get(nxt) == 1:
                    cyc = stack[stack.index(nxt):] + [nxt]
                    if min(cyc) == cyc[0]:
                        cycles.append(cyc)
                elif state.get(nxt, 0) == 0:
                    dfs(nxt, stack)
            stack.pop()
            state[node] = 2
        for node in sorted(edges):
            if state.get(node, 0) == 0:
                dfs(node, [])
        return cycles

    for cyc in _find_cycles():
        hops = []
        for src, dst in zip(cyc, cyc[1:]):
            p, line, note = edges[src][dst]
            hops.append(f"{src} → {dst} ({p}:{line}, {note})")
        p0, line0, _ = edges[cyc[0]][cyc[1]]
        findings.append(Finding(
            p0, line0, RULE,
            "lock-order cycle: " + "; ".join(hops)))
    return findings
check.emits = (RULE,)
