"""Shared symbol resolution: imports, constants, classes, call targets.

Everything here is best-effort and syntactic — when a name cannot be
resolved the rules skip it rather than guess. That bias (miss, don't
invent) keeps the lint lane quiet enough that a finding means
something.
"""

from __future__ import annotations

import ast
import threading
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.analysis.core import ProjectIndex, SourceFile

_MEMO_LOCK = threading.Lock()


def project_for(index: ProjectIndex) -> "Project":
    """One shared ``Project`` per index. Several rules (lock-order,
    thread-safety, registries) need the same symbol tables; building
    them once matters now that checkers run on a thread pool."""
    with _MEMO_LOCK:
        project = getattr(index, "_ctlint_project", None)
        if project is None:
            project = Project(index)
            index._ctlint_project = project
        return project


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class ModuleInfo:
    """Per-module symbol table: imports, top-level constants/functions/
    classes, and every (possibly nested) function definition."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        #: local name → fully qualified target ("time",
        #: "cilium_tpu.runtime.faults", "....metrics.METRICS")
        self.imports: Dict[str, str] = {}
        #: top-level NAME = <expr> assignments
        self.constants: Dict[str, ast.expr] = {}
        self.functions: Dict[str, ast.AST] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        #: every FunctionDef in the module by name (nested included);
        #: jitted entry points are often closures, so name-level lookup
        #: must see them
        self.all_functions: Dict[str, List[ast.AST]] = {}
        self._build()

    def _build(self) -> None:
        pkg = self.sf.module.rsplit(".", 1)[0] \
            if "." in self.sf.module else ""
        for node in self.sf.tree.body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    self.imports[local] = target
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    # relative import: climb from this module's package
                    parts = self.sf.module.split(".")
                    parts = parts[: len(parts) - node.level]
                    base = ".".join(parts + ([node.module]
                                             if node.module else []))
                elif not base:
                    base = pkg
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    self.imports[local] = f"{base}.{alias.name}"
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                self.constants[node.targets[0].id] = node.value
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
        for node in ast.walk(self.sf.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.all_functions.setdefault(node.name, []).append(node)

    def qualify(self, expr: ast.AST) -> Optional[str]:
        """Resolve a Name/Attribute chain through this module's
        imports: ``_time.monotonic`` → ``time.monotonic``,
        ``_faults.maybe_fail`` → ``cilium_tpu.runtime.faults
        .maybe_fail``. Unresolved roots stay as written."""
        d = dotted(expr)
        if d is None:
            return None
        root, _, rest = d.partition(".")
        target = self.imports.get(root, root)
        return f"{target}.{rest}" if rest else target


class Project:
    """ModuleInfo for every indexed file + cross-module resolution."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self.modules: Dict[str, ModuleInfo] = {
            name: ModuleInfo(sf) for name, sf in index.files.items()}

    def resolve_string(self, mi: ModuleInfo, expr: ast.AST,
                       _depth: int = 0) -> Optional[str]:
        """Constant-fold ``expr`` to a string: literals, module-level
        NAME constants, and from-imports of such constants in other
        indexed modules. Handles the ``POINT = register_point("x")``
        idiom by unwrapping single-call assignments whose first arg is
        a string."""
        if _depth > 8:
            return None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value
        if isinstance(expr, ast.Call) and expr.args:
            return self.resolve_string(mi, expr.args[0], _depth + 1)
        d = dotted(expr)
        if d is None:
            return None
        # local constant?
        if "." not in d and d in mi.constants:
            return self.resolve_string(mi, mi.constants[d], _depth + 1)
        q = mi.qualify(expr)
        if q is None:
            return None
        owner, _, attr = q.rpartition(".")
        target = self.modules.get(owner)
        if target is not None and attr in target.constants:
            return self.resolve_string(target, target.constants[attr],
                                       _depth + 1)
        return None

    def resolve_function(self, mi: ModuleInfo, name: str
                         ) -> Optional[Tuple[ModuleInfo, ast.AST]]:
        """Find the def behind a (possibly imported) function name."""
        fns = mi.all_functions.get(name)
        if fns:
            return mi, fns[0]
        q = mi.imports.get(name)
        if q is None:
            return None
        owner, _, attr = q.rpartition(".")
        for candidate in (self.modules.get(q.rsplit(".", 1)[0]),
                          self.modules.get(owner)):
            if candidate is not None and attr in candidate.functions:
                return candidate, candidate.functions[attr]
        return None

    def resolve_class(self, mi: ModuleInfo, name: str
                      ) -> Optional[Tuple[ModuleInfo, ast.ClassDef]]:
        if name in mi.classes:
            return mi, mi.classes[name]
        q = mi.imports.get(name)
        if q is None:
            return None
        owner, _, attr = q.rpartition(".")
        target = self.modules.get(owner)
        if target is not None and attr in target.classes:
            return target, target.classes[attr]
        return None
