"""swallowed-exception: no silent failure on the serving paths.

A bare ``except:`` catches ``KeyboardInterrupt``/``SystemExit`` and
hides programming errors; an ``except Exception:`` whose body only
``pass``es turns a broken verdict/stream/loader path into silent wrong
behavior (a stream stall can hide in exactly this shape). Handlers that DO something — log, count a metric, degrade to a
fallback, re-raise — are fine; handlers for narrow exception types
are the caller's business and not flagged.
"""

from __future__ import annotations

import ast
from typing import List

from cilium_tpu_torch.analysis.callgraph import ModuleInfo, dotted
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "swallowed-exception"

_BROAD = {"Exception", "BaseException"}


def _is_broad(mi: ModuleInfo, handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    names = [handler.type] if not isinstance(handler.type, ast.Tuple) \
        else list(handler.type.elts)
    return any((dotted(n) or "") in _BROAD for n in names)


def _is_silent(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Continue):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                     ast.Constant):
            continue  # a docstring/ellipsis is not handling
        return False
    return True


@checker
def check(index: ProjectIndex) -> List[Finding]:
    from cilium_tpu_torch.analysis.callgraph import Project

    project = Project(index)
    findings: List[Finding] = []
    for mi in project.modules.values():
        for node in ast.walk(mi.sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                findings.append(Finding(
                    mi.sf.path, node.lineno, RULE,
                    "bare `except:` — catches KeyboardInterrupt/"
                    "SystemExit and hides programming errors; name "
                    "the exceptions"))
            elif _is_broad(mi, node) and _is_silent(node):
                findings.append(Finding(
                    mi.sf.path, node.lineno, RULE,
                    "`except Exception` with a body that only passes "
                    "— the failure vanishes; log it, count it, or "
                    "narrow the type"))
    return findings
check.emits = (RULE,)
