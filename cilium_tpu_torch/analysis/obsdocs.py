"""obs-doc-parity: the observability surface ⇄ docs/OBSERVABILITY.md.

The perf ledger made docs/OBSERVABILITY.md the operator's
catalog of every metric family and every phase label the system can
emit — and a catalog that drifts is worse than none: a dashboard built
from stale docs reads dead series, and an undocumented phase label is
attribution output nobody can interpret. This rule closes the drift
both ways:

* every metric family declared in ``runtime/metrics.py``
  (``METRICS.describe``) must be mentioned in the doc;
* every phase label value — the tracing ``PHASE_*`` constants, the
  engine-probe ``ENGINE_PHASES`` / ``CAPTURE_PHASES`` tuples
  (``engine/phases.py``), and every ``_StagePhase("...")`` staging
  phase used anywhere — must be mentioned in the doc;
* every ``cilium_tpu_*``-shaped token the doc mentions must still be a
  declared family (stale docs teach dead series); derived histogram
  suffixes (``_bucket``/``_count``/``_sum``) of declared families are
  fine;
* every **reason-label VALUE** the system can emit — shed reasons
  (the ``SHED_*`` constants in ``runtime/admission.py``), memo
  invalidation reasons (``engine/memo.INVALIDATION_REASONS`` plus any
  literal ``reason=`` at engine/runtime call sites), and every
  literal ``{"reason"/"result": ...}`` metric label value anywhere in
  the package — must appear in the doc's **Reason-label catalog**
  section, and a catalog row whose value is no longer emitted
  anywhere is a stale-doc finding (a dashboard filtering on a dead
  label value silently matches nothing);
* every **fleet journal event KIND** — the ``JOURNAL_KINDS`` tuple in
  ``runtime/fleetserve.py`` plus every literal ``journal.record(...)``
  first argument — must appear in the doc's **Fleet event-journal
  catalog** section, both ways: an undocumented kind is an event an
  operator cannot interpret, a catalog row for a kind the journal
  never records is a stale doc.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.analysis.callgraph import Project
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "obs-doc-parity"

#: modules relative to the run's package (``ProjectIndex.mod``)
METRICS_MODULE = "runtime.metrics"
TRACING_MODULE = "runtime.tracing"
PHASES_MODULE = "engine.phases"
DOC_PATH = os.path.join("docs", "OBSERVABILITY.md")

#: phase-label tuple constants whose VALUES the doc must cover
_PHASE_TUPLES = ("ENGINE_PHASES", "CAPTURE_PHASES")

_DOC_FAMILY_RE = re.compile(r"\bcilium_tpu_[a-z0-9_]*[a-z0-9]\b")

ADMISSION_MODULE = "runtime.admission"
MEMO_MODULE = "engine.memo"
#: module prefixes whose literal ``reason=`` call kwargs / bare
#: ``invalidate("...")`` args are reason-label values
_REASON_CALL_PREFIXES = ("engine", "runtime", "policy")
#: label keys whose literal values are reason-label values
_LABEL_KEYS = ("reason", "result")
#: the doc section holding the reason-label catalog; rows are
#: ``| `value` | ... |`` table lines
REASON_SECTION = "## Reason-label catalog"
_REASON_ROW_RE = re.compile(r"^\|\s*`([a-z0-9*_-]+)`")

FLEETSERVE_MODULE = "runtime.fleetserve"
#: the doc section holding the fleet event-journal catalog; rows are
#: ``| `kind` | ... |`` table lines (same row shape as reasons)
JOURNAL_SECTION = "## Fleet event-journal catalog"


def _declared_families(project: Project) -> Dict[str, Tuple[str, int]]:
    mi = project.modules.get(project.index.mod(METRICS_MODULE))
    if mi is None:
        return {}
    out: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(mi.sf.tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "describe" and node.args:
            name = project.resolve_string(mi, node.args[0])
            if name is not None:
                out.setdefault(name, (mi.sf.path, node.lineno))
    return out


def _phase_values(project: Project) -> Dict[str, Tuple[str, int]]:
    """Phase label value → declaring (path, line)."""
    out: Dict[str, Tuple[str, int]] = {}
    mi = project.modules.get(project.index.mod(TRACING_MODULE))
    if mi is not None:
        for node in mi.sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id.startswith("PHASE_") \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                out.setdefault(node.value.value,
                               (mi.sf.path, node.lineno))
    pm = project.modules.get(project.index.mod(PHASES_MODULE))
    if pm is not None:
        for node in pm.sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id in _PHASE_TUPLES \
                    and isinstance(node.value, ast.Tuple):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) \
                            and isinstance(elt.value, str):
                        out.setdefault(elt.value,
                                       (pm.sf.path, node.lineno))
    # _StagePhase("...") call sites anywhere in the package (the
    # capture-staging phase labels are literals at their seams)
    for mod in project.modules.values():
        for node in ast.walk(mod.sf.tree):
            if isinstance(node, ast.Call) and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) \
                    else fn.id if isinstance(fn, ast.Name) else ""
                if name == "_StagePhase":
                    out.setdefault(node.args[0].value,
                                   (mod.sf.path, node.lineno))
    return out


def _const_strs(node: ast.AST) -> List[str]:
    """String constants of a value expression: a bare constant, or
    both branches of a conditional (``"a" if x else "b"`` — the
    explained/unexplained shape)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, ast.IfExp):
        return _const_strs(node.body) + _const_strs(node.orelse)
    if isinstance(node, ast.BoolOp):
        # `dynamic or "fallback"` — the fallback is emittable
        out: List[str] = []
        for v in node.values:
            out.extend(_const_strs(v))
        return out
    return []


def _reason_values(project: Project) -> Dict[str, Tuple[str, int]]:
    """Every reason-label VALUE the tree can emit → declaring
    (path, line): shed reasons (``SHED_*``), the memo invalidation
    registry (``INVALIDATION_REASONS``), literal ``reason=`` call
    kwargs / ``invalidate("...")`` args in the serving modules, and
    literal ``{"reason"/"result": ...}`` metric label values
    anywhere."""
    out: Dict[str, Tuple[str, int]] = {}

    def note(value: str, path: str, line: int) -> None:
        if value:
            out.setdefault(value, (path, line))

    mi = project.modules.get(project.index.mod(ADMISSION_MODULE))
    if mi is not None:
        for node in mi.sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id.startswith("SHED_") \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                note(node.value.value, mi.sf.path, node.lineno)
    mm = project.modules.get(project.index.mod(MEMO_MODULE))
    if mm is not None:
        for node in mm.sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "INVALIDATION_REASONS" \
                    and isinstance(node.value, ast.Tuple):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) \
                            and isinstance(elt.value, str):
                        note(elt.value, mm.sf.path, node.lineno)
    reason_prefixes = tuple(project.index.mod(p)
                            for p in _REASON_CALL_PREFIXES)
    for name, mod in project.modules.items():
        reason_module = name.startswith(reason_prefixes)
        for node in ast.walk(mod.sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            fn_name = fn.attr if isinstance(fn, ast.Attribute) \
                else fn.id if isinstance(fn, ast.Name) else ""
            if reason_module:
                if fn_name == "invalidate" and node.args:
                    for v in _const_strs(node.args[0]):
                        note(v, mod.sf.path, node.lineno)
                for kw in node.keywords:
                    if kw.arg == "reason":
                        for v in _const_strs(kw.value):
                            note(v, mod.sf.path, node.lineno)
            # literal {"reason"/"result": ...} metric label values,
            # tree-wide (the artifact-fetch result shape)
            for kw in node.keywords:
                if kw.arg != "labels" \
                        or not isinstance(kw.value, ast.Dict):
                    continue
                for k, v in zip(kw.value.keys, kw.value.values):
                    if isinstance(k, ast.Constant) \
                            and k.value in _LABEL_KEYS:
                        for s in _const_strs(v):
                            note(s, mod.sf.path, node.lineno)
    return out


def _journal_kinds(project: Project) -> Dict[str, Tuple[str, int]]:
    """Every fleet journal event KIND the tree can record →
    declaring (path, line): the ``JOURNAL_KINDS`` tuple in
    ``runtime/fleetserve.py`` plus literal first args of
    ``journal.record("...")`` call sites (a recorded kind missing
    from the tuple is caught at runtime; here both feed the doc
    diff)."""
    out: Dict[str, Tuple[str, int]] = {}
    mi = project.modules.get(project.index.mod(FLEETSERVE_MODULE))
    if mi is None:
        return out
    for node in mi.sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "JOURNAL_KINDS" \
                and isinstance(node.value, ast.Tuple):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) \
                        and isinstance(elt.value, str):
                    out.setdefault(elt.value, (mi.sf.path,
                                               node.lineno))
    for node in ast.walk(mi.sf.tree):
        if not (isinstance(node, ast.Call) and node.args
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "record"):
            continue
        owner = node.func.value
        owner_name = owner.attr if isinstance(owner, ast.Attribute) \
            else owner.id if isinstance(owner, ast.Name) else ""
        if owner_name != "journal":
            continue
        for v in _const_strs(node.args[0]):
            out.setdefault(v, (mi.sf.path, node.lineno))
    return out


def _documented_rows(doc_text: str, section: str) -> Dict[str, int]:
    """Value → doc line of every ``| `value` |`` row under one
    ``## ...`` section."""
    out: Dict[str, int] = {}
    in_section = False
    for i, line in enumerate(doc_text.splitlines(), 1):
        if line.strip().startswith("## "):
            in_section = line.strip() == section.strip()
            continue
        if not in_section:
            continue
        m = _REASON_ROW_RE.match(line.strip())
        if m:
            out.setdefault(m.group(1), i)
    return out


def _documented_reasons(doc_text: str) -> Dict[str, int]:
    """Value → doc line of every Reason-label catalog row."""
    return _documented_rows(doc_text, REASON_SECTION)


def check_obs_docs(index: ProjectIndex,
                   doc_text: Optional[str] = None) -> List[Finding]:
    if doc_text is None:
        if index.root is None:
            return []  # in-memory corpus without a doc: nothing to diff
        path = os.path.join(index.root, DOC_PATH)
        try:
            with open(path, encoding="utf-8") as fp:
                doc_text = fp.read()
        except OSError:
            mi = index.get(index.mod(METRICS_MODULE))
            if mi is None:
                return []
            return [Finding(mi.path, 1, RULE,
                            f"{DOC_PATH} is missing — the metric/phase "
                            f"catalog has no doc to agree with")]

    project = Project(index)
    findings: List[Finding] = []
    families = _declared_families(project)
    for name, (path, line) in sorted(families.items()):
        if name not in doc_text:
            findings.append(Finding(
                path, line, RULE,
                f"metric family `{name}` is not documented in "
                f"{DOC_PATH} (add it to the family catalog)"))
    for value, (path, line) in sorted(_phase_values(project).items()):
        if value not in doc_text:
            findings.append(Finding(
                path, line, RULE,
                f"phase label `{value}` is not documented in "
                f"{DOC_PATH}"))
    # reason-label parity, both directions (only when the tree has a
    # reason surface at all — in-memory rule corpora without the
    # admission module are not judged)
    reasons = _reason_values(project)
    documented = _documented_reasons(doc_text)
    if reasons:
        for value, (path, line) in sorted(reasons.items()):
            if value not in documented:
                findings.append(Finding(
                    path, line, RULE,
                    f"reason-label value `{value}` is not in "
                    f"{DOC_PATH}'s Reason-label catalog (an operator "
                    f"cannot interpret an undocumented reason)"))
        for value, line in sorted(documented.items()):
            if value not in reasons:
                findings.append(Finding(
                    DOC_PATH, line, RULE,
                    f"{DOC_PATH} catalogs reason-label value "
                    f"`{value}` but nothing in the tree emits it — "
                    f"stale doc or typo"))
    # fleet journal-kind parity, both directions (only when the tree
    # has a journal at all — corpora without fleetserve are not
    # judged)
    kinds = _journal_kinds(project)
    if kinds:
        doc_kinds = _documented_rows(doc_text, JOURNAL_SECTION)
        for kind, (path, line) in sorted(kinds.items()):
            if kind not in doc_kinds:
                findings.append(Finding(
                    path, line, RULE,
                    f"fleet journal event kind `{kind}` is not in "
                    f"{DOC_PATH}'s Fleet event-journal catalog (an "
                    f"operator cannot interpret an undocumented "
                    f"event)"))
        for kind, line in sorted(doc_kinds.items()):
            if kind not in kinds:
                findings.append(Finding(
                    DOC_PATH, line, RULE,
                    f"{DOC_PATH} catalogs fleet journal event kind "
                    f"`{kind}` but runtime/fleetserve.py never "
                    f"records it — stale doc or typo"))
    # stale direction: doc tokens that are no longer declared families
    if families:
        derived = set()
        for name in families:
            derived.update((name + "_bucket", name + "_count",
                            name + "_sum"))
        for i, line_text in enumerate(doc_text.splitlines(), 1):
            for tok in _DOC_FAMILY_RE.findall(line_text):
                if tok not in families and tok not in derived:
                    findings.append(Finding(
                        DOC_PATH, i, RULE,
                        f"{DOC_PATH} mentions `{tok}` but "
                        f"runtime/metrics.py declares no such family "
                        f"— stale doc or typo"))
    return findings


@checker
def check(index: ProjectIndex) -> List[Finding]:
    return check_obs_docs(index)
check.emits = (RULE,)
