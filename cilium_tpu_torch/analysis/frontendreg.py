"""frontend-registry: the ``l7proto`` universe has ONE registry and
the family enums can't drift from it.

The unified frontend registry closed the gap where ``proxylib``
parser selection and the engine's L7-type enum were maintained by hand
in two places: a parser could exist that no policy could legally name
(or worse — a policy could name a proto the engine silently matched
as plain generic while the proxy dispatched a real state machine).
This rule keeps the halves pinned together statically:

* every ``register_parser("<name>", ...)`` in ``<package>/proxylib/``
  must either have an engine frontend (a ``FrontendSpec(name=
  "<name>", ...)`` under ``<package>/policy/compiler/frontends/``)
  or carry a justified proxy-only pragma
  (``# ctlint: disable=frontend-registry  # why``) — http/kafka are
  the canonical allowlist entries (the engine speaks them natively),
  the ``test.*`` fixtures ride the generic pair path by design;
* every frontend's declared ``family``/``family_name`` must appear in
  each family enum a verdict's lifecycle reads: the ``L7Type``
  member universe (``core/flow.py``), the memo/delta family map
  (``engine/memo.py FAMILY_OF_L7TYPE`` — what bank-reference
  invalidation keys on), and the attribution decode table
  (``engine/attribution.py FAMILY_NAMES`` — what the explain plane
  resolves through). A frontend missing from any of them would
  verdict on a family the rest of the plane can't invalidate or
  explain;
* every frontend ``name`` must have a ``register_parser`` under
  ``proxylib/`` — the ``OnData`` parser is the family's differential
  CPU oracle, and a frontend without one is untestable.

The checks are literal-level (AST over the four declaration sites),
like the other registry rules: a real registration satisfies them, a
drifted enum cannot.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "frontend-registry"

#: paths relative to the run's package (``ProjectIndex.rel``)
_PROXYLIB_PREFIX = "proxylib/"
_FRONTENDS_PREFIX = "policy/compiler/frontends/"
_FLOW_PATH = "core/flow.py"
_MEMO_PATH = "engine/memo.py"
_ATTR_PATH = "engine/attribution.py"


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _const_int(node) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    return None


def _parser_registrations(index: ProjectIndex
                          ) -> Dict[str, Tuple[str, int]]:
    """name → (path, line) of every proxylib ``register_parser``."""
    out: Dict[str, Tuple[str, int]] = {}
    for f in index.files.values():
        if not f.path.startswith(index.rel(_PROXYLIB_PREFIX)):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute)
                    else None)
            if name != "register_parser" or not node.args:
                continue
            pname = _const_str(node.args[0])
            if pname is not None:
                out.setdefault(pname, (f.path, node.lineno))
    return out


def _frontend_specs(index: ProjectIndex) -> List[Dict]:
    """Every ``FrontendSpec(...)`` literal under the frontends
    package: {name, family, family_name, path, line}."""
    out: List[Dict] = []
    for f in index.files.values():
        if not f.path.startswith(index.rel(_FRONTENDS_PREFIX)):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            cname = (fn.id if isinstance(fn, ast.Name)
                     else fn.attr if isinstance(fn, ast.Attribute)
                     else None)
            if cname != "FrontendSpec":
                continue
            kw = {k.arg: k.value for k in node.keywords}
            name = _const_str(kw.get("name"))
            family = _const_int(kw.get("family"))
            family_name = _const_str(kw.get("family_name"))
            if name is None:
                continue  # the base-class docstring example, if any
            out.append({"name": name, "family": family,
                        "family_name": family_name,
                        "path": f.path, "line": node.lineno})
    return out


def _l7type_values(index: ProjectIndex) -> Dict[int, str]:
    """L7Type enum literal: value → member name."""
    f = index.by_path.get(index.rel(_FLOW_PATH))
    out: Dict[int, str] = {}
    if f is None:
        return out
    for node in ast.walk(f.tree):
        if isinstance(node, ast.ClassDef) and node.name == "L7Type":
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and len(stmt.targets) \
                        == 1 and isinstance(stmt.targets[0], ast.Name):
                    v = _const_int(stmt.value)
                    if v is not None:
                        out[v] = stmt.targets[0].id
    return out


def _dict_literal(index: ProjectIndex, path: str, var: str,
                  l7types: Dict[int, str]) -> Dict[int, str]:
    """An ``{int-or-int(L7Type.X): "name"}`` module-level dict."""
    f = index.by_path.get(path)
    out: Dict[int, str] = {}
    if f is None:
        return out
    name_to_val = {n: v for v, n in l7types.items()}
    for node in ast.walk(f.tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == var
                and isinstance(node.value, ast.Dict)):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            key = _const_int(k)
            if key is None and isinstance(k, ast.Call) and k.args:
                # int(L7Type.X)
                arg = k.args[0]
                if isinstance(arg, ast.Attribute):
                    key = name_to_val.get(arg.attr)
            val = _const_str(v)
            if key is not None and val is not None:
                out[key] = val
    return out


@checker
def check_frontend_registry(index: ProjectIndex) -> List[Finding]:
    parsers = _parser_registrations(index)
    specs = _frontend_specs(index)
    if not parsers and not specs:
        return []  # corpus without either surface: nothing to hold
    l7types = _l7type_values(index)
    memo_fams = _dict_literal(index, index.rel(_MEMO_PATH), "FAMILY_OF_L7TYPE",
                              l7types)
    attr_fams = _dict_literal(index, index.rel(_ATTR_PATH), "FAMILY_NAMES",
                              l7types)
    frontend_names = {s["name"] for s in specs}
    findings: List[Finding] = []

    for pname, (path, line) in sorted(parsers.items()):
        if pname not in frontend_names:
            findings.append(Finding(
                path, line, RULE,
                f"register_parser({pname!r}) has no engine frontend "
                f"under policy/compiler/frontends/ — add one (see "
                f"frontends/r2d2.py) or justify proxy-only with "
                f"`# ctlint: disable={RULE}  # why`"))

    for s in specs:
        where = (s["path"], s["line"])
        fam, fname = s["family"], s["family_name"]
        if s["name"] not in parsers:
            findings.append(Finding(
                *where, RULE,
                f"frontend {s['name']!r} has no proxylib "
                f"register_parser — the OnData parser is the "
                f"family's differential CPU oracle and must exist"))
        if fam is None or fname is None:
            continue  # dynamically-built spec: nothing literal to pin
        if fam not in l7types and l7types:
            findings.append(Finding(
                *where, RULE,
                f"frontend {s['name']!r} family {fam} has no L7Type "
                f"member (core/flow.py)"))
        if memo_fams and memo_fams.get(fam) != fname:
            findings.append(Finding(
                *where, RULE,
                f"frontend {s['name']!r} family {fam}/{fname!r} "
                f"missing from engine/memo.py FAMILY_OF_L7TYPE "
                f"(got {memo_fams.get(fam)!r}) — bank-reference "
                f"invalidation would skip its rows"))
        if attr_fams and attr_fams.get(fam) != fname \
                and attr_fams.get(fam) != s["name"]:
            findings.append(Finding(
                *where, RULE,
                f"frontend {s['name']!r} family {fam} missing from "
                f"engine/attribution.py FAMILY_NAMES — the explain "
                f"plane could not decode its verdicts"))
    return findings
check_frontend_registry.emits = (RULE,)
