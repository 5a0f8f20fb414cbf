"""Registry consistency: the string registries producer and consumer
sites must agree on.

Three registries, three failure smells this rule set closes:

* **metric-registry** — a typo'd ``METRICS.inc`` name silently creates
  a dead Prometheus series (and the dashboard keeps reading the old,
  now-frozen one). Every metric family must be declared exactly once
  (``METRICS.describe`` in ``runtime/metrics.py``), be
  Prometheus-legal and ``cilium_tpu_``-prefixed, be written with
  exactly one instrument kind (counter/gauge/histogram — a family
  exposed twice with two TYPEs is invalid exposition), follow the
  counter ``_total`` suffix convention, and never be read
  (``get``/``quantile``/``histo_*``) under a name nothing writes.
* **fault-registry** — a ``faults.maybe_fail`` seam naming an
  unregistered point is unreachable from every FaultPlan (the chaos
  suite thinks it covered an outage it never injected); a registered
  point with no seam is dead coverage.
* **frame-kind** — every ``KIND_*`` stream frame constant must be
  dispatched in both the server worker and the client receive loop,
  or a peer speaking that kind gets its payload misparsed.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Tuple

from cilium_tpu_torch.analysis.callgraph import ModuleInfo, Project, dotted
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

METRIC_RULE = "metric-registry"
FAULT_RULE = "fault-registry"
FRAME_RULE = "frame-kind"

#: the one module allowed to declare metric families, and the other
#: registries' modules — relative to the run's package
#: (``ProjectIndex.mod``)
METRICS_MODULE = "runtime.metrics"
FAULTS_MODULE = "runtime.faults"
STREAM_MODULE = "runtime.stream"

_PROM_NAME = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
METRIC_PREFIX = "cilium_tpu_"

_WRITE_KIND = {"inc": "counter", "set_gauge": "gauge",
               "observe": "histogram"}
_READ_METHODS = {"get", "quantile", "histo_sum", "histo_count",
                 "samples_since"}


def _metrics_receiver(project: Project, mi: ModuleInfo,
                      call: ast.Call) -> Optional[str]:
    """The Metrics method name if this call targets the global
    registry (``METRICS.inc`` / ``self.metrics.observe``), else
    None."""
    if not isinstance(call.func, ast.Attribute):
        return None
    recv = dotted(call.func.value)
    if recv is None:
        return None
    if recv in ("METRICS", "self.metrics", "self._metrics"):
        return call.func.attr
    q = mi.qualify(call.func.value)
    if q == f"{project.index.mod(METRICS_MODULE)}.METRICS":
        return call.func.attr
    return None


def check_metrics(index: ProjectIndex,
                  decl_module: Optional[str] = None) -> List[Finding]:
    decl_module = decl_module or index.mod(METRICS_MODULE)
    project = Project(index)
    declared: Dict[str, Tuple[str, int]] = {}
    findings: List[Finding] = []
    decl = project.modules.get(decl_module)

    # pass 1: declarations (describe calls in the metrics module) +
    # string constants there (the shared-name surface other modules
    # import)
    if decl is not None:
        for node in ast.walk(decl.sf.tree):
            if isinstance(node, ast.Call):
                meth = _metrics_receiver(project, decl, node)
                if meth == "describe" and node.args:
                    name = project.resolve_string(decl, node.args[0])
                    if name is None:
                        continue
                    if name in declared:
                        findings.append(Finding(
                            decl.sf.path, node.lineno, METRIC_RULE,
                            f"metric `{name}` declared more than once "
                            f"(first at line {declared[name][1]})"))
                    else:
                        declared[name] = (decl.sf.path, node.lineno)

    writes: Dict[str, Dict[str, Tuple[str, int]]] = {}
    reads: Dict[str, Tuple[str, int]] = {}
    for mi in project.modules.values():
        # class-level string constants make `self.gauge_name`-style
        # metric names resolvable: call node → enclosing class attrs
        cls_attrs: Dict[int, Dict[str, str]] = {}
        for cls in mi.classes.values():
            # a class-level name constant too (the port's
            # ``gauge_name = IDENTITIES_CLUSTER``)
            attrs = {st.targets[0].id: value
                     for st in cls.body
                     if isinstance(st, ast.Assign)
                     and len(st.targets) == 1
                     and isinstance(st.targets[0], ast.Name)
                     and isinstance(st.value, (ast.Constant, ast.Name,
                                               ast.Attribute))
                     for value in [project.resolve_string(mi, st.value)]
                     if value is not None}
            if attrs:
                for node in ast.walk(cls):
                    if isinstance(node, ast.Call):
                        cls_attrs[id(node)] = attrs
        for node in ast.walk(mi.sf.tree):
            if not isinstance(node, ast.Call):
                continue
            meth = _metrics_receiver(project, mi, node)
            if meth is None or not node.args:
                continue
            site = (mi.sf.path, node.lineno)
            name = project.resolve_string(mi, node.args[0])
            if name is None:
                arg = node.args[0]
                d = dotted(arg) or ""
                if d.startswith("self.") and d.count(".") == 1:
                    name = cls_attrs.get(id(node), {}).get(
                        d.split(".", 1)[1])
            if meth in _WRITE_KIND or meth in _READ_METHODS:
                if name is None:
                    findings.append(Finding(
                        *site, METRIC_RULE,
                        "metric name is not a resolvable string "
                        "constant — the registry cannot be checked"))
                    continue
            else:
                continue
            if not _PROM_NAME.match(name):
                findings.append(Finding(
                    *site, METRIC_RULE,
                    f"`{name}` is not a legal Prometheus metric name"))
            elif not name.startswith(METRIC_PREFIX):
                findings.append(Finding(
                    *site, METRIC_RULE,
                    f"`{name}` lacks the `{METRIC_PREFIX}` namespace "
                    f"prefix"))
            if meth in _WRITE_KIND:
                writes.setdefault(name, {}).setdefault(
                    _WRITE_KIND[meth], site)
                if meth == "inc" and not name.endswith("_total"):
                    findings.append(Finding(
                        *site, METRIC_RULE,
                        f"counter `{name}` must end in `_total` "
                        f"(Prometheus counter convention)"))
                if meth != "inc" and name.endswith("_total"):
                    findings.append(Finding(
                        *site, METRIC_RULE,
                        f"`{name}` ends in `_total` but is written as "
                        f"a {_WRITE_KIND[meth]}"))
                if name not in declared:
                    findings.append(Finding(
                        *site, METRIC_RULE,
                        f"metric `{name}` written here but never "
                        f"declared — add METRICS.describe(...) in "
                        f"runtime/metrics.py"))
            else:
                reads.setdefault(name, site)

    for name, kinds in writes.items():
        if len(kinds) > 1:
            sites = ", ".join(f"{k} at {p}:{ln}"
                              for k, (p, ln) in sorted(kinds.items()))
            p, ln = sorted(kinds.values())[0]
            findings.append(Finding(
                p, ln, METRIC_RULE,
                f"metric `{name}` written with conflicting instrument "
                f"kinds ({sites}) — one family, one TYPE"))
    for name, (p, ln) in reads.items():
        if name not in writes:
            findings.append(Finding(
                p, ln, METRIC_RULE,
                f"metric `{name}` is read here but nothing in the "
                f"package writes it — dead series or typo"))
    return findings


def check_faults(index: ProjectIndex,
                 faults_module: Optional[str] = None) -> List[Finding]:
    faults_module = faults_module or index.mod(FAULTS_MODULE)
    project = Project(index)
    findings: List[Finding] = []
    registered: Dict[str, Tuple[str, int]] = {}
    seams: Dict[str, Tuple[str, int]] = {}
    for mi in project.modules.values():
        for node in ast.walk(mi.sf.tree):
            if not isinstance(node, ast.Call):
                continue
            q = mi.qualify(node.func) or ""
            if q == f"{faults_module}.register_point" and node.args:
                name = project.resolve_string(mi, node.args[0])
                if name is None:
                    continue
                if name in registered and mi.sf.module != faults_module:
                    findings.append(Finding(
                        mi.sf.path, node.lineno, FAULT_RULE,
                        f"fault point `{name}` registered more than "
                        f"once (first at "
                        f"{registered[name][0]}:{registered[name][1]})"))
                registered.setdefault(name, (mi.sf.path, node.lineno))
            elif q == f"{faults_module}.maybe_fail" and node.args:
                name = project.resolve_string(mi, node.args[0])
                if name is None:
                    findings.append(Finding(
                        mi.sf.path, node.lineno, FAULT_RULE,
                        "maybe_fail point is not a resolvable string "
                        "constant — use `POINT = "
                        "faults.register_point(...)`"))
                    continue
                seams.setdefault(name, (mi.sf.path, node.lineno))
    for name, (p, ln) in seams.items():
        if name not in registered:
            findings.append(Finding(
                p, ln, FAULT_RULE,
                f"maybe_fail(`{name}`) names an unregistered point — "
                f"no FaultPlan can target it by registry"))
    for name, (p, ln) in registered.items():
        if name not in seams and p.endswith(".py") \
                and not p.endswith("faults.py"):
            findings.append(Finding(
                p, ln, FAULT_RULE,
                f"fault point `{name}` is registered but no seam "
                f"calls maybe_fail with it — dead injection point"))
    return findings


#: (module, class, methods) pairs that must each dispatch every frame
#: kind — the stream protocol's two ends
FRAME_DISPATCH_SITES: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    (STREAM_MODULE, "StreamSession", ("_work",)),
    (STREAM_MODULE, "StreamClient", ("_recv_loop",)),
)


def check_frames(index: ProjectIndex,
                 defs_module: Optional[str] = None,
                 sites: Optional[Sequence[Tuple[str, str,
                                                Tuple[str, ...]]]]
                 = None) -> List[Finding]:
    defs_module = defs_module or index.mod(STREAM_MODULE)
    if sites is None:
        sites = tuple((index.mod(m), c, fns)
                      for m, c, fns in FRAME_DISPATCH_SITES)
    project = Project(index)
    findings: List[Finding] = []
    mi = project.modules.get(defs_module)
    if mi is None:
        return findings
    kinds: Dict[str, Tuple[int, int]] = {}   # name → (value, line)
    for name, value in mi.constants.items():
        if name.startswith("KIND_") and isinstance(value, ast.Constant) \
                and isinstance(value.value, int):
            line = next((n.lineno for n in mi.sf.tree.body
                         if isinstance(n, ast.Assign)
                         and isinstance(n.targets[0], ast.Name)
                         and n.targets[0].id == name), 1)
            kinds[name] = (value.value, line)
    by_value: Dict[int, str] = {}
    for name, (value, line) in sorted(kinds.items()):
        if value in by_value:
            findings.append(Finding(
                mi.sf.path, line, FRAME_RULE,
                f"`{name}` reuses wire value {value} of "
                f"`{by_value[value]}`"))
        else:
            by_value[value] = name
    for site_module, cls_name, methods in sites:
        smi = project.modules.get(site_module)
        if smi is None or cls_name not in smi.classes:
            continue
        cls = smi.classes[cls_name]
        names_seen = set()
        for node in cls.body:
            if isinstance(node, ast.FunctionDef) \
                    and node.name in methods:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Name):
                        names_seen.add(sub.id)
        for name, (_value, line) in sorted(kinds.items()):
            if name not in names_seen:
                findings.append(Finding(
                    mi.sf.path, line, FRAME_RULE,
                    f"frame kind `{name}` is not handled in "
                    f"`{cls_name}.{'/'.join(methods)}` — a peer "
                    f"sending it gets its payload misparsed"))
    return findings


@checker
def check(index: ProjectIndex) -> List[Finding]:
    return (check_metrics(index) + check_faults(index)
            + check_frames(index))
check.emits = (METRIC_RULE, FAULT_RULE, FRAME_RULE)
