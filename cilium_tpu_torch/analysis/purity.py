"""jit-purity: nothing host-effectful reachable from a device entry.

The reference's rule guards ``jax.jit`` / ``pallas_call`` /
``shard_map`` bodies, which run at TRACE time. The port has no trace:
its device work is the hand-written kernels behind their wrappers and
the eager torch steps around them. The contract carries over all the
same — a device step must compute the verdict from its tensors and
nothing else, and must never make the host wait on the card:

* a ``time.*`` read or sleep, a host or torch RNG draw, socket/file
  I/O, a thread or lock, the metrics/tracing/fault/log registries
  (each takes a lock) — effects that make a verdict depend on the
  host, or serialize the launching threads;
* a host sync: ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``
  / ``np.asarray`` / ``torch.cuda.synchronize`` / ``Event.synchronize``
  — the host blocks until the card drains, in the middle of what must
  stay an asynchronous launch sequence;
* a Python branch on a device value (``if torch.any(x)`` /
  ``if x.any()``): a readback in eager torch, a graph break under
  ``torch.compile``.

Entry points (detected, not listed):

* the **kernel wrappers** — module-level functions of the package's
  ``engine/`` that launch a hand-written kernel (``KERNEL.launch(...)``;
  by convention named ``*_cuda``) — and their **plain versions** (the
  ``*_plain`` functions of the same module, which the CPU path runs).
  A measurement tool that launches a kernel to time it is not an entry;
* the **device steps** — module-level ``*_step`` / ``*_step_*``
  functions of the package's ``engine/`` (``fused_verdict_step``, ``verdict_step``,
  ``verdict_step_capture`` …);
* ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace``
  decorators and call forms (the port has none; the face is kept, and
  a corpus case shows it).

Reachability follows plain calls through the indexed project, and a
wrapper's ``KERNEL.launch`` into ``Kernel.launch`` (the binding idiom
of ``engine/_build.py``: a module constant taken from ``KERNELS``); an
unresolvable callee is skipped (miss, don't invent).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from cilium_tpu_torch.analysis.callgraph import ModuleInfo, Project, dotted
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "jit-purity"

#: qualified-name prefixes whose call is a host effect in a device
#: step; the package's registries are relative to the run's package
_IMPURE_PREFIXES: Tuple[Tuple[str, str], ...] = (
    ("time.", "wall-clock/sleep"),
    ("random.", "host RNG"),
    ("numpy.random", "host RNG"),
    ("torch.manual_seed", "RNG seeding"),
    ("socket.", "I/O"),
    ("os.", "I/O"),
    ("threading.", "thread/lock construction"),
)
_PACKAGE_IMPURE: Tuple[Tuple[str, str], ...] = (
    ("runtime.metrics.", "metrics lock"),
    ("runtime.tracing.", "tracer lock"),
    ("runtime.faults.", "fault-point lock+RNG"),
    ("runtime.logging.", "log I/O"),
)

#: exact qualified names that force a host sync / materialization
_HOST_SYNC = {
    "numpy.asarray": "host materialization of a device value",
    "numpy.array": "host materialization of a device value",
    "numpy.frombuffer": "host materialization",
    "torch.cuda.synchronize": "blocking device sync",
}

#: torch RNG draws (a verdict must not depend on one)
_TORCH_RNG = {"torch.rand", "torch.randn", "torch.randint",
              "torch.randperm", "torch.bernoulli", "torch.multinomial"}

#: builtins that are host I/O
_IO_BUILTINS = {"open", "print", "input"}

#: attribute calls that block on the device
_SYNC_ATTRS = {"item": "blocking .item() host sync",
               "tolist": "blocking .tolist() host sync",
               "cpu": "blocking .cpu() readback",
               "numpy": "blocking .numpy() readback",
               "synchronize": "blocking device sync"}

#: compile-wrapping call forms whose first Name argument is an entry
_WRAPPERS = ("torch.compile", "torch.jit.script", "torch.jit.trace")

#: where the device steps live, relative to the run's package
STEP_DIR = "engine/"


def _is_jit_decorator(mi: ModuleInfo, dec: ast.expr) -> bool:
    q = mi.qualify(dec if not isinstance(dec, ast.Call) else dec.func)
    if q in _WRAPPERS:
        return True
    if isinstance(dec, ast.Call) and q in ("functools.partial",
                                           "partial") and dec.args:
        inner = mi.qualify(dec.args[0])
        return inner in _WRAPPERS
    return False


def _launches(fn: ast.AST) -> bool:
    """Does ``fn``'s own body launch a kernel (``X.launch(...)``)?"""
    return any(isinstance(n, ast.Call)
               and isinstance(n.func, ast.Attribute)
               and n.func.attr == "launch" for n in ast.walk(fn))


def kernel_wrappers(mi: ModuleInfo) -> List[ast.AST]:
    """The module's kernel wrappers, then its plain versions."""
    wrappers = [fn for fn in mi.functions.values() if _launches(fn)]
    if not wrappers:
        return []
    return wrappers + [fn for name, fn in mi.functions.items()
                       if name.endswith("_plain")]


def find_entries(project: Project) -> List[Tuple[ModuleInfo, ast.AST]]:
    # memoized per project: five rule families ask for the device
    # entries of the same shared Project, and the discovery is a
    # whole-tree ast.walk — pay for it once per run (same idiom as
    # callgraph.project_for; the attribute rides the Project).
    cached = getattr(project, "_ctlint_jit_entries", None)
    if cached is not None:
        return cached
    entries: List[Tuple[ModuleInfo, ast.AST]] = []
    seen: Set[int] = set()
    compiled: Set[int] = set()
    step_dir = project.index.rel(STEP_DIR)

    def add(mi: ModuleInfo, fn: Optional[ast.AST],
            wrapped: bool = False) -> None:
        if fn is not None and wrapped:
            compiled.add(id(fn))
        if fn is not None and id(fn) not in seen:
            seen.add(id(fn))
            entries.append((mi, fn))

    for mi in project.modules.values():
        if mi.sf.path.startswith(step_dir):
            for fn in kernel_wrappers(mi):
                add(mi, fn)
            for name, fn in mi.functions.items():
                if name.endswith("_step") or "_step_" in name:
                    add(mi, fn)
        for fns in mi.all_functions.values():
            for fn in fns:
                if any(_is_jit_decorator(mi, d)
                       for d in fn.decorator_list):
                    add(mi, fn, wrapped=True)
        for node in ast.walk(mi.sf.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            q = mi.qualify(node.func)
            if q is None or q not in _WRAPPERS:
                continue
            arg = node.args[0]
            # compile(partial(fn, ...)) binds statics around a real
            # entry — unwrap to the inner function
            if isinstance(arg, ast.Call) and arg.args \
                    and mi.qualify(arg.func) in ("functools.partial",
                                                 "partial"):
                arg = arg.args[0]
            if isinstance(arg, ast.Name):
                resolved = project.resolve_function(mi, arg.id)
                if resolved is not None:
                    add(*resolved, wrapped=True)
            elif isinstance(arg, ast.Attribute):
                # module-qualified entry (`_mk.fused_verdict_step`)
                q2 = mi.qualify(arg) or dotted(arg) or ""
                owner, _, attr = q2.rpartition(".")
                target = project.modules.get(owner)
                if target is not None and attr in target.functions:
                    add(target, target.functions[attr], wrapped=True)
            elif isinstance(arg, (ast.FunctionDef, ast.Lambda)):
                add(mi, arg, wrapped=True)
    # benign race: concurrent checkers compute identical lists; the
    # last write wins and both results are correct
    project._ctlint_compiled = compiled
    project._ctlint_jit_entries = entries
    return entries


def compiled_entries(project: Project
                     ) -> List[Tuple[ModuleInfo, ast.AST]]:
    """The entries a ``torch.compile`` / ``torch.jit`` wrap builds a
    graph of — the only ones whose shapes are baked into a cache key."""
    entries = find_entries(project)
    compiled = getattr(project, "_ctlint_compiled", set())
    return [(mi, fn) for mi, fn in entries if id(fn) in compiled]


def _kernel_method(project: Project, mi: ModuleInfo, recv: str,
                   meth: str) -> Optional[Tuple[ModuleInfo, ast.AST]]:
    """``KERNEL.launch`` where ``KERNEL = <mod>.KERNELS[...]``: the
    ``launch`` method of the ``Kernel`` class in that module."""
    value = mi.constants.get(recv)
    if not isinstance(value, ast.Subscript):
        return None
    owner = mi.qualify(value.value) or ""
    mod, _, name = owner.rpartition(".")
    target = project.modules.get(mod) if name == "KERNELS" else None
    if target is None:
        return None
    for cls in target.classes.values():
        for stmt in cls.body:
            if isinstance(stmt, ast.FunctionDef) and stmt.name == meth:
                return target, stmt
    return None


def _callees(project: Project, mi: ModuleInfo, fn: ast.AST
             ) -> List[Tuple[ModuleInfo, ast.AST]]:
    out = []
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func)
        if d is None:
            continue
        if "." not in d:
            resolved = project.resolve_function(mi, d)
            if resolved is not None:
                out.append(resolved)
            continue
        # mod.fn where mod is an imported project module
        root, _, attr = d.rpartition(".")
        target = project.modules.get(mi.imports.get(root, ""))
        if target is not None and "." not in attr \
                and attr in target.functions:
            out.append((target, target.functions[attr]))
        elif "." not in root:
            method = _kernel_method(project, mi, root, attr)
            if method is not None:
                out.append(method)
    return out


def _scan_impure(mi: ModuleInfo, fn: ast.AST, entry_name: str,
                 findings: List[Finding], package: str) -> None:
    path = mi.sf.path
    impure = _IMPURE_PREFIXES + tuple(
        (f"{package}.{p}", why) for p, why in _PACKAGE_IMPURE)

    def report(line: int, what: str) -> None:
        findings.append(Finding(
            path, line, RULE,
            f"{what} inside `{getattr(fn, 'name', '<lambda>')}`, "
            f"reachable from device entry `{entry_name}`"))

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            q = mi.qualify(node.func)
            if q is not None:
                if q in _HOST_SYNC:
                    report(node.lineno, f"{_HOST_SYNC[q]} (`{q}`)")
                    continue
                if q in _IO_BUILTINS:
                    report(node.lineno, f"host I/O call `{q}`")
                    continue
                if q in _TORCH_RNG:
                    report(node.lineno, f"RNG draw `{q}`")
                    continue
                hit = next((why for p, why in impure
                            if q.startswith(p)), None)
                if hit is not None:
                    report(node.lineno, f"{hit} call `{q}`")
                    continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SYNC_ATTRS:
                report(node.lineno, _SYNC_ATTRS[node.func.attr])
        elif isinstance(node, ast.With):
            for item in node.items:
                d = dotted(item.context_expr) or ""
                leaf = d.rsplit(".", 1)[-1].lower()
                if "lock" in leaf or "cond" in leaf:
                    report(node.lineno,
                           f"lock acquisition `with {d}`")
        elif isinstance(node, (ast.If, ast.While)):
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Call):
                    q = mi.qualify(sub.func) or ""
                    leaf = q.rsplit(".", 1)[-1]
                    if q.startswith("torch.") and q.count(".") == 1 \
                            or isinstance(sub.func, ast.Attribute) \
                            and leaf in ("any", "all") \
                            and q.split(".")[0] not in (
                                "numpy", "np", "builtins"):
                        report(node.lineno,
                               "Python branch on a device value "
                               f"(`{dotted(sub.func)}` in the test)")
                        break


@checker
def check(index: ProjectIndex) -> List[Finding]:
    project = Project(index)
    findings: List[Finding] = []
    visited: Dict[int, str] = {}
    stack = [(mi, fn, getattr(fn, "name", "<lambda>"))
             for mi, fn in find_entries(project)]
    while stack:
        mi, fn, entry = stack.pop()
        if id(fn) in visited:
            continue
        visited[id(fn)] = entry
        _scan_impure(mi, fn, entry, findings, index.package)
        for cmi, cfn in _callees(project, mi, fn):
            if id(cfn) not in visited:
                stack.append((cmi, cfn, entry))
    return findings
check.emits = (RULE,)
