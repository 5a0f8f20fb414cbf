"""unbounded-registry: every long-lived registry in the serving plane
carries a bound, an eviction path, or a TTL.

The fleet-scale failure this rule exists for: the policy plane's
content-addressed stores (bank registry, artifact cache, fingerprint
maps) each started life as a bare dict that only ever grew — fine at
27 banks, a slow memory leak at 5k-CNP churn, where every update
inserts new content keys and nothing ever leaves. The fix is
byte-bounded LRU shards; this rule keeps the property from regressing
anywhere in the long-lived serving modules:

* scope: modules under ``<package>/runtime/``, ``<package>/engine/``
  and ``<package>/policy/`` — the processes that live for the
  daemon's lifetime and take request/event traffic;
* an **instance attribute** initialized to an empty dict/set/
  OrderedDict/defaultdict and **inserted into outside ``__init__``**
  (``self._x[k] = v`` / ``.setdefault`` / ``.add`` / ``.update``) is
  a finding UNLESS the class shows bound/eviction evidence for it:
  ``del self._x[...]``, ``.pop``/``.popitem``/``.clear``, a
  ``len(self._x)`` comparison, or a wholesale rebuild
  (``self._x = ...`` reassignment outside ``__init__`` — the pruning
  idiom);
* a **module-level** dict/set with an insertion inside any function
  is flagged under the same evidence rules (import-time registries
  that only grow with module count are the classic justified
  allowlist).

The heuristic is deliberately syntactic, like ``unbounded-queue``: a
real bound satisfies it, and a registry with no eviction syntax
anywhere cannot be bounded. Provably-bounded growth (keys drawn from
a finite static set, test-only ledgers) carries the standard
justified pragma::

    # ctlint: disable=unbounded-registry  # why growth is bounded
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from cilium_tpu_torch.analysis.callgraph import dotted
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "unbounded-registry"

#: path prefixes of the long-lived serving modules in scope, relative
#: to the run's package (``ProjectIndex.rel``)
_SCOPED = ("runtime/", "engine/", "policy/")

#: ctor calls that build a growable mapping/set registry
_REGISTRY_CTORS = ("dict", "set", "OrderedDict",
                   "collections.OrderedDict", "defaultdict",
                   "collections.defaultdict")

#: method calls that insert into a registry
_INSERT_METHODS = ("setdefault", "add", "update")

#: method calls that evict/bound a registry
_EVICT_METHODS = ("pop", "popitem", "clear", "discard", "remove")


def _is_registry_ctor(node: ast.AST) -> bool:
    if isinstance(node, ast.Dict) and not node.keys:
        return True
    if isinstance(node, ast.Set):
        return False            # literal non-empty set: not a registry
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        return d in _REGISTRY_CTORS
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _name(node: ast.AST) -> Optional[str]:
    return node.id if isinstance(node, ast.Name) else None


class _ClassScan:
    """One class's registry attrs, insertions, and bound evidence."""

    def __init__(self, cls: ast.ClassDef):
        self.inits: Dict[str, int] = {}       # attr → init lineno
        self.inserts: Dict[str, int] = {}     # attr → insertion lineno
        self.evidence: Set[str] = set()
        for fn in (n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))):
            in_init = fn.name == "__init__"
            for node in ast.walk(fn):
                self._visit(node, in_init)

    def _visit(self, node: ast.AST, in_init: bool) -> None:
        # annotated (`self._x: Dict = {}`) and plain assignments both
        # initialize registries
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            node = ast.Assign(targets=[node.target], value=node.value,
                              lineno=node.lineno)
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            attr = _self_attr(tgt)
            if attr is not None:
                if _is_registry_ctor(node.value):
                    if in_init:
                        self.inits.setdefault(attr, node.lineno)
                    else:
                        # re-init outside __init__: the rebuild/prune
                        # idiom — evidence AND a fresh registration
                        self.inits.setdefault(attr, node.lineno)
                        self.evidence.add(attr)
                elif not in_init:
                    # wholesale reassignment (comprehension, filtered
                    # rebuild): eviction evidence
                    self.evidence.add(attr)
            elif isinstance(tgt, ast.Subscript):
                a = _self_attr(tgt.value)
                if a is not None and not in_init:
                    self.inserts.setdefault(a, node.lineno)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    a = _self_attr(t.value)
                    if a is not None:
                        self.evidence.add(a)
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            a = _self_attr(node.func.value)
            if a is not None:
                if node.func.attr in _EVICT_METHODS:
                    self.evidence.add(a)
                elif node.func.attr in _INSERT_METHODS \
                        and not in_init:
                    self.inserts.setdefault(a, node.lineno)
        elif isinstance(node, ast.Compare):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Name) \
                        and sub.func.id == "len" and sub.args:
                    a = _self_attr(sub.args[0])
                    if a is not None:
                        self.evidence.add(a)


def _scan_module_level(tree: ast.Module):
    """(name → init lineno, name → insert lineno, evidence names) for
    module-global registries."""
    inits: Dict[str, int] = {}
    inserts: Dict[str, int] = {}
    evidence: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and node.value is not None:
            node = ast.Assign(targets=[node.target], value=node.value,
                              lineno=node.lineno)
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = _name(node.targets[0])
            if name is not None and _is_registry_ctor(node.value):
                inits.setdefault(name, node.lineno)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign) \
                        and len(sub.targets) == 1:
                    tgt = sub.targets[0]
                    if isinstance(tgt, ast.Subscript):
                        name = _name(tgt.value)
                        if name in inits:
                            inserts.setdefault(name, sub.lineno)
                    elif _name(tgt) in inits:
                        evidence.add(_name(tgt))   # rebuild
                elif isinstance(sub, ast.Delete):
                    for t in sub.targets:
                        if isinstance(t, ast.Subscript):
                            name = _name(t.value)
                            if name in inits:
                                evidence.add(name)
                elif isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute):
                    name = _name(sub.func.value)
                    if name in inits:
                        if sub.func.attr in _EVICT_METHODS:
                            evidence.add(name)
                        elif sub.func.attr in _INSERT_METHODS:
                            inserts.setdefault(name, sub.lineno)
                elif isinstance(sub, ast.Compare):
                    for s2 in ast.walk(sub):
                        if isinstance(s2, ast.Call) \
                                and isinstance(s2.func, ast.Name) \
                                and s2.func.id == "len" and s2.args:
                            name = _name(s2.args[0])
                            if name in inits:
                                evidence.add(name)
    return inits, inserts, evidence


@checker
def check(index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []
    scoped = tuple(index.rel(p) for p in _SCOPED)
    for sf in index.files.values():
        path = sf.path.replace("\\", "/")
        if not any(path.startswith(p) or f"/{p}" in path
                   for p in scoped):
            continue
        # instance-level registries
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            scan = _ClassScan(node)
            for attr in sorted(set(scan.inits) & set(scan.inserts)):
                if attr in scan.evidence:
                    continue
                findings.append(Finding(
                    sf.path, scan.inserts[attr], RULE,
                    f"`self.{attr}` in `{node.name}` is a registry "
                    f"(dict/set) inserted into on an event path with "
                    f"no eviction, bound, or TTL — under sustained "
                    f"churn it grows without limit; add a byte/len "
                    f"bound with eviction, prune it, or justify with "
                    f"a disable pragma"))
        # module-level registries
        inits, inserts, evidence = _scan_module_level(sf.tree)
        for name in sorted(set(inits) & set(inserts)):
            if name in evidence:
                continue
            findings.append(Finding(
                sf.path, inserts[name], RULE,
                f"module-level `{name}` is a registry (dict/set) "
                f"inserted into from function bodies with no "
                f"eviction, bound, or TTL — if growth is provably "
                f"bounded (import-time registration), justify with a "
                f"disable pragma"))
    return findings
check.emits = (RULE,)
