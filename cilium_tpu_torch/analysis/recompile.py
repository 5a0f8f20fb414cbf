"""recompile-hazard: per-call rebuilds on the serving path — in the
port, of kernel bindings and compiled graphs.

The reference's rule watches ``jax.jit``'s cache key. The port's
kernels are compiled once by ``nvcc`` into a library named by the hash
of its source (``engine/_build.py``) and bound with ``ctypes``; the
cost that a rebuild puts on the hot path is the binding itself (a
``dlopen``, a symbol lookup, and on a cold cache an ``nvcc`` run of
seconds), and, for a ``torch.compile`` / ``torch.jit`` wrap, a fresh
graph and its compile. The faces:

* **per-call re-building** — ``Kernel(...)``, ``ctypes.CDLL(...)``,
  the package's ``engine._build.build(...)``, ``torch.compile(fn)`` or
  ``torch.jit.script|trace(fn)`` executed *inside* a function body
  builds a fresh binding or graph per call. Module-level construction,
  decorator forms, and results memoized onto ``self``
  (``self._lib = …``, ``self._lib, self._fn = lib, fn``, or a
  ``self._cache[key] = …`` store), into a module global the function
  declares ``global``, or built by an ``lru_cache``'d factory are
  exempt.
* **shape-dependent Python branching** and **config/closure scalars in
  static positions** — these two faces remain only for the
  ``torch.compile`` / ``torch.jit`` entries, where a branch on a shape
  specializes the graph (a guard, then one compile per shape) and a
  config scalar in a shape argument bakes into it. The hand-written
  kernels take their shapes as runtime arguments and eager torch
  compiles nothing, so neither face exists for them. The port has no
  compiled entry: the faces are kept for the day it has one, and a
  corpus case shows that they find nothing elsewhere.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cilium_tpu_torch.analysis import dataflow
from cilium_tpu_torch.analysis.callgraph import ModuleInfo, Project, dotted
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker
from cilium_tpu_torch.analysis.dataflow import AbsVal, EventSink, Interp
from cilium_tpu_torch.analysis.purity import (_WRAPPERS, _is_jit_decorator,
                                              compiled_entries)

RULE = "recompile-hazard"

#: call forms that build a binding or a graph
_WRAP_CALLS = set(_WRAPPERS) | {"ctypes.CDLL", "ctypes.cdll.LoadLibrary"}

#: the package's own builders, relative to the run's package
_PACKAGE_WRAP_CALLS = ("engine._build.Kernel", "engine._build.build")


def _is_wrap_call(mi: ModuleInfo, node: ast.Call) -> Optional[str]:
    q = mi.qualify(node.func)
    if q is None:
        return None
    package = mi.sf.module.split(".")[0]
    if q in _WRAP_CALLS or q in {f"{package}.{c}"
                                 for c in _PACKAGE_WRAP_CALLS}:
        return ".".join(q.rsplit(".", 2)[-2:]) \
            if q.startswith(f"{package}.") else q
    if q in ("functools.partial", "partial") and node.args:
        inner = mi.qualify(node.args[0])
        if inner in _WRAPPERS:
            return f"partial({inner})"
    return None


def _is_memo_decorator(mi: ModuleInfo, dec: ast.expr) -> bool:
    q = mi.qualify(dec if not isinstance(dec, ast.Call) else dec.func)
    return q in ("functools.lru_cache", "lru_cache",
                 "functools.cache", "cache")


def _memoized_names(fn: ast.AST) -> Set[str]:
    """Names whose value is stored onto ``self`` (attribute or
    subscript) anywhere in ``fn`` — the memo idiom (``self._lib =
    lib``, ``self._lib, self._fn = lib, fn``, ``self._steps[k] =
    fn``)."""
    out: Set[str] = set()
    globals_ = _global_names(fn)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and tgt.id in globals_ \
                    and isinstance(node.value, ast.Name):
                out.add(node.value.id)      # a module-global memo
            pairs = [(tgt, node.value)]
            if isinstance(tgt, ast.Tuple) and isinstance(
                    node.value, ast.Tuple) \
                    and len(tgt.elts) == len(node.value.elts):
                pairs = list(zip(tgt.elts, node.value.elts))
            for t, v in pairs:
                base = t
                while isinstance(base, (ast.Attribute, ast.Subscript)):
                    base = base.value
                if isinstance(base, ast.Name) and base.id == "self" \
                        and isinstance(t, (ast.Attribute, ast.Subscript)) \
                        and isinstance(v, ast.Name):
                    out.add(v.id)
    return out


def _global_names(fn: ast.AST) -> Set[str]:
    """Names ``fn`` declares ``global`` (a module-level memo)."""
    return {n for node in ast.walk(fn) if isinstance(node, ast.Global)
            for n in node.names}


def _self_stored_directly(node: ast.Assign,
                          globals_: Set[str] = frozenset()) -> bool:
    for tgt in node.targets:
        if isinstance(tgt, ast.Name) and tgt.id in globals_:
            return True
        base = tgt.elts[0] if isinstance(tgt, ast.Tuple) and tgt.elts \
            else tgt
        while isinstance(base, (ast.Attribute, ast.Subscript)):
            base = base.value
        if isinstance(base, ast.Name) and base.id == "self":
            return True
    return False


def check_rewrap(index: ProjectIndex,
                 project: Optional[Project] = None) -> List[Finding]:
    """Face 1: per-call wrapper construction."""
    project = project or Project(index)
    findings: List[Finding] = []
    for mi in project.modules.values():
        # every function body (module-level wrap calls are the GOOD
        # pattern and are skipped by construction)
        for fns in mi.all_functions.values():
            for fn in fns:
                if any(_is_jit_decorator(mi, d)
                       for d in getattr(fn, "decorator_list", [])):
                    continue  # wrapper built at trace time only
                if any(_is_memo_decorator(mi, d)
                       for d in getattr(fn, "decorator_list", [])):
                    # an lru_cache'd factory builds each wrapper ONCE
                    # per key — the memoization fix itself
                    continue
                memo = _memoized_names(fn)
                for node in ast.iter_child_nodes(fn):
                    findings.extend(
                        self_scan(mi, fn, node, memo))
    return findings


def _walk_shallow(stmt: ast.AST):
    """ast.walk that does NOT descend into nested function defs —
    those get their own ``check_rewrap`` pass (double-reporting a
    nested def's wrap call against its parent would be noise)."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.append(child)


def self_scan(mi: ModuleInfo, fn: ast.AST, stmt: ast.stmt,
              memo: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    # immediate Assign owning each wrap call (the call may sit under
    # an `if fn is None:` memo guard, so the Assign is found by its
    # own shallow walk, not by being the top statement)
    owner: dict = {}
    for node in _walk_shallow(stmt):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            owner[id(node.value)] = node
    for node in _walk_shallow(stmt):
        if not isinstance(node, ast.Call):
            continue
        wrapped = _is_wrap_call(mi, node)
        if wrapped is None:
            continue
        # exempt: result memoized onto self (directly, or through a
        # local later stored into a self-held dict/attribute)
        assign = owner.get(id(node))
        if assign is not None:
            if _self_stored_directly(assign, _global_names(fn)):
                continue
            if len(assign.targets) == 1 \
                    and isinstance(assign.targets[0], ast.Name) \
                    and assign.targets[0].id in memo:
                continue
        name = getattr(fn, "name", "<lambda>")
        out.append(Finding(
            mi.sf.path, node.lineno, RULE,
            f"`{wrapped}` built per call inside `{name}` — every "
            f"invocation builds a fresh binding or graph (a dlopen, "
            f"a compile); hoist to module level or memoize it"))
    return out


class _Sink(EventSink):
    """Faces 2+3, fed by the dataflow interpreter over compiled
    bodies. Events land in the CALLEE's file under the
    interprocedural walk, hence the per-event ``path``."""

    def __init__(self, entry: str):
        self.entry = entry
        self.findings: List[Finding] = []
        self._seen: Set[Tuple[str, int, str]] = set()

    def _add(self, path: str, line: int, msg: str) -> None:
        key = (path, line, msg)
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(path, line, RULE, msg))

    def shape_branch(self, path: str, line: int, kind: str,
                     origin: str) -> None:
        self._add(path, line,
                  f"shape-dependent Python branch on {origin} inside "
                  f"compiled entry `{self.entry}` — one compile per "
                  f"distinct input shape reaching it")

    def shape_position(self, path: str, line: int, fn: str,
                       val: AbsVal) -> None:
        candidates = val.items if val.kind == "tuple" else [val]
        for v in candidates:
            if v.kind not in ("const", "host") or not v.origin:
                continue
            if not _is_config_origin(v.origin):
                continue
            self._add(path, line,
                      f"config-derived scalar {v.origin} fixes a "
                      f"shape (`{fn}`) inside compiled entry "
                      f"`{self.entry}` — every config change "
                      f"recompiles; freeze it at wrap time "
                      f"(a closure) deliberately")
            return


def _is_config_origin(origin: str) -> bool:
    low = origin.lower()
    return "cfg." in low or "config" in low or "environ" in low


def check_dynamic(index: ProjectIndex,
                  project: Optional[Project] = None) -> List[Finding]:
    """Faces 2+3: run the interpreter over every compiled entry."""
    project = project or Project(index)
    findings: List[Finding] = []
    seen: Set[int] = set()
    for mi, fn in compiled_entries(project):
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        sink = _Sink(getattr(fn, "name", "<lambda>"))
        interp = Interp(project, sink)
        env = _seed_with_config(mi, fn)
        interp.run_function(mi, fn, env)
        findings.extend(sink.findings)
    # one finding per site: the first entry to reach a shared helper
    # line owns the attribution
    out = {}
    for f in sorted(set(findings)):
        out.setdefault((f.path, f.line), f)
    return sorted(out.values())


def _seed_with_config(mi: ModuleInfo, fn: ast.AST
                      ) -> Dict[str, AbsVal]:
    env = dataflow.param_shapes(mi, fn)
    # free names that read like config objects seed as consts with a
    # config origin so shape-position hits can name the churn source
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute):
            d = dotted(node)
            if d is None:
                continue
            root = d.split(".")[0]
            if root in env:
                continue
            if _is_config_origin(d) or root in ("cfg", "config"):
                env.setdefault(root, AbsVal.host(origin=f"`{root}`"))
    return env


@checker
def check(index: ProjectIndex) -> List[Finding]:
    project = Project(index)
    findings = check_rewrap(index, project)
    findings.extend(check_dynamic(index, project))
    return sorted(set(findings))
check.emits = (RULE,)
