"""unused-import: no dead module-level imports.

Dead imports hide real dependencies (and real cycles) and make the
purity/lock analyses resolve names that nothing uses. ``__init__.py``
files are exempt wholesale — their imports ARE the re-export surface.
``from __future__`` and explicit re-exports via ``__all__`` are
recognized as uses.
"""

from __future__ import annotations

import ast
from typing import List

from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "unused-import"


@checker
def check(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    for sf in index.files.values():
        if sf.path.endswith("__init__.py"):
            continue
        imported = {}  # local name → (line, display)
        import_nodes = []
        for node in sf.tree.body:
            if isinstance(node, ast.Import):
                import_nodes.append(node)
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    imported[local] = (node.lineno, alias.name)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                import_nodes.append(node)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    local = alias.asname or alias.name
                    imported[local] = (
                        node.lineno,
                        f"{node.module or '.'}.{alias.name}")
        if not imported:
            continue
        used = set()
        import_ids = {id(n) for node in import_nodes
                      for n in ast.walk(node)}
        for node in ast.walk(sf.tree):
            if id(node) in import_ids:
                continue
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                pass  # the root Name is walked separately
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                continue
        # __all__ re-exports count as uses
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name)
                            and t.id == "__all__"
                            for t in node.targets):
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Constant) \
                            and isinstance(sub.value, str):
                        used.add(sub.value)
        for local, (line, display) in sorted(imported.items()):
            if local not in used:
                findings.append(Finding(
                    sf.path, line, RULE,
                    f"`{display}` imported as `{local}` but never "
                    f"used at module level"))
    return findings
check.emits = (RULE,)
