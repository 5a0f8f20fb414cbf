"""unbounded-queue: every queue in the threaded runtime carries a
bound or a shed path.

The overload failure this rule exists for: ``MicroBatcher._pending`` was
a bare list — under saturation every request queued without bound,
callers that timed out still consumed device batch slots, and p99
diverged instead of shedding. The fix (runtime/admission.py) is a
bounded queue with explicit sheds; this rule keeps the property from
regressing anywhere in the threaded runtime:

* ``queue.Queue()`` / ``LifoQueue()`` / ``PriorityQueue()`` built
  WITHOUT a ``maxsize`` in a module that imports ``threading`` is a
  finding — an unbounded stdlib queue between threads is exactly the
  buffer-forever failure mode.
* **List-as-queue**: a class that spawns threads
  (``threading.Thread(...)`` anywhere in its body), initializes an
  attribute to an empty list (``self._x = []``), and ``append``\\ s to
  it is flagged UNLESS the class also compares ``len(self._x)``
  somewhere — the bound/shed evidence. The heuristic is deliberately
  syntactic: a real bound check (``if len(self._pending) >=
  self.max_pending: shed``) satisfies it, and a queue with no length
  test anywhere cannot be bounded.

Intentional unbounded growth (a transition log read only by tests, a
batch accumulated then immediately consumed) carries the standard
justified pragma::

    # ctlint: disable=unbounded-queue  # why growth is bounded elsewhere
"""

from __future__ import annotations

import ast
from typing import List, Optional

from cilium_tpu_torch.analysis.callgraph import dotted
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "unbounded-queue"

#: stdlib queue constructors that accept (and default to no) maxsize
_QUEUE_CLASSES = ("Queue", "LifoQueue", "PriorityQueue")


def _imports_threading(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] == "threading"
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] == "threading":
                return True
    return False


def _queue_ctor(call: ast.Call, mi) -> Optional[str]:
    """The queue class name when ``call`` constructs a stdlib queue
    (``queue.Queue(...)`` or a ``from queue import Queue`` name)."""
    d = dotted(call.func)
    if d is None:
        return None
    qualified = mi.qualify(call.func) or d
    for cls in _QUEUE_CLASSES:
        if qualified == f"queue.{cls}":
            return cls
    return None


def _has_maxsize(call: ast.Call) -> bool:
    if call.args:  # maxsize is the first positional
        return True
    return any(kw.arg == "maxsize" for kw in call.keywords)


def _self_attr(node: ast.AST) -> Optional[str]:
    """``x`` for a ``self.x`` attribute access."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _spawns_threads(cls: ast.ClassDef, mi) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            q = mi.qualify(node.func) or (dotted(node.func) or "")
            if q in ("threading.Thread", "Thread"):
                return True
    return False


def _len_compared_attrs(cls: ast.ClassDef) -> set:
    """Attrs whose ``len(self.x)`` appears under a comparison anywhere
    in the class — the bound/shed evidence."""
    out = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Compare):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Name) \
                    and sub.func.id == "len" and sub.args:
                attr = _self_attr(sub.args[0])
                if attr is not None:
                    out.add(attr)
    return out


def _check_class(cls: ast.ClassDef, mi, path: str) -> List[Finding]:
    if not _spawns_threads(cls, mi):
        return []
    # attrs initialized to an empty list anywhere in the class
    empty_list_attrs = {}
    appended = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            attr = _self_attr(node.targets[0])
            if attr is None:
                continue
            val = node.value
            is_empty_list = (
                (isinstance(val, ast.List) and not val.elts)
                or (isinstance(val, ast.Call)
                    and isinstance(val.func, ast.Name)
                    and val.func.id == "list" and not val.args))
            if is_empty_list and attr not in empty_list_attrs:
                empty_list_attrs[attr] = node.lineno
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "append":
            attr = _self_attr(node.func.value)
            if attr is not None and attr not in appended:
                appended[attr] = node.lineno
    bounded = _len_compared_attrs(cls)
    findings = []
    for attr in sorted(set(empty_list_attrs) & set(appended)):
        if attr in bounded:
            continue
        findings.append(Finding(
            path, appended[attr], RULE,
            f"`self.{attr}` in threaded class `{cls.name}` is a "
            f"list used as a queue with no bound — under overload it "
            f"grows without limit; enforce a max occupancy with an "
            f"explicit shed (compare `len(self.{attr})`), or justify "
            f"with a disable pragma"))
    return findings


@checker
def check(index: ProjectIndex) -> List[Finding]:
    from cilium_tpu_torch.analysis.callgraph import Project

    project = Project(index)
    findings: List[Finding] = []
    for mi in project.modules.values():
        if not _imports_threading(mi.sf.tree):
            continue
        for node in ast.walk(mi.sf.tree):
            if isinstance(node, ast.Call):
                cls = _queue_ctor(node, mi)
                if cls is not None and not _has_maxsize(node):
                    findings.append(Finding(
                        mi.sf.path, node.lineno, RULE,
                        f"`{cls}()` without `maxsize` in a threaded "
                        f"module — an unbounded inter-thread queue "
                        f"buffers forever under overload; pass a "
                        f"bound (producers block or shed)"))
        for cls_node in ast.walk(mi.sf.tree):
            if isinstance(cls_node, ast.ClassDef):
                findings.extend(_check_class(cls_node, mi, mi.sf.path))
    return findings
check.emits = (RULE,)
