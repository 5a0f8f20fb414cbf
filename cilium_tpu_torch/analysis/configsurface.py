"""config-surface: four-way parity across the knob surfaces.

A configuration knob exists four times: as a ``Config`` dataclass
field, as a TOML key ``Config.from_toml`` accepts, as a
``CILIUM_TPU_*`` environment override, and as a documented contract
in ``docs/``. Nothing ties those together — ``from_toml`` silently
drops unknown keys, ``from_env`` silently ignores typo'd variables,
and an ad-hoc ``os.environ`` read deep in a kernel module bypasses
``Config`` entirely. Each drift face is a check:

* **env ⇄ field** — every variable ``from_env`` reads must assign a
  real field (a typo'd setattr is a knob that never takes effect);
* **env ⇄ docs** — every ``CILIUM_TPU_*`` variable read anywhere in
  the package must be documented in ``docs/``/``README.md`` (ad-hoc
  knobs the operator cannot discover), and every variable the docs
  mention must still be read by code (stale docs teach dead knobs);
* **toml ⇄ field** — every explicit top-level key ``from_toml``
  copies must name a real field (section keys are hasattr-guarded by
  construction);
* **field ⇄ docs** — every ``Config``/section field must appear in
  the docs (the operator-facing catalog is docs/CONFIG.md);
* **field ⇄ code** — a field no module outside ``core/config.py``
  reads is a dead knob (checked by attribute name; a shared name
  anywhere keeps it alive — miss, don't invent).

The docs are shared by the reference and the port (``docs/``,
``README.md``). A knob the docs name for a reference module that has
no port is not stale for the port: :data:`UNPORTED_ENV` lists each,
by package, with the reason, and only the stale-docs direction skips
it.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "config-surface"

#: relative to the run's package (``ProjectIndex.mod``)
CONFIG_MODULE = "core.config"
ENV_PREFIX = "CILIUM_TPU_"
#: doc surfaces scanned for mentions (repo-relative)
DOC_SOURCES = ("docs", "README.md")
#: env vars owned by the bench/watch tooling, not the daemon config
#: surface — they live in bench scripts outside the package
_ENV_EXEMPT_PREFIXES = ("CILIUM_TPU_BENCH_", "CILIUM_TPU_WATCH_")

#: env vars the docs name for a reference module with no port, by
#: package, with the reason (the stale-docs direction skips them)
UNPORTED_ENV: Dict[str, Dict[str, str]] = {
    "cilium_tpu_torch": {
        "CILIUM_TPU_XLA_CACHE":
            "runtime/xla_cache.py gets no port: the port compiles no "
            "XLA; its kernels are nvcc-built libraries cached under "
            "cilium_tpu_torch/_build, keyed by their sources' hash",
    },
}

_ENV_RE = re.compile(r"\b%s[A-Z0-9_]+\b" % ENV_PREFIX)


class ConfigModel:
    """The parsed config surface of ``core/config.py``."""

    def __init__(self) -> None:
        #: "" → top-level Config field names; section attr → fields
        self.fields: Dict[str, Dict[str, int]] = {"": {}}
        #: env var → (field path it assigns or None, line)
        self.env_reads: Dict[str, Tuple[Optional[str], int]] = {}
        #: explicit top-level TOML keys → line
        self.toml_keys: Dict[str, int] = {}
        #: section attr name → section class name
        self.sections: Dict[str, str] = {}
        self.path = ""


def _class_fields(cls: ast.ClassDef) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out[node.target.id] = node.lineno
    return out


def _assigned_field(stmt: ast.stmt) -> Optional[str]:
    """``cfg.engine.bank_size = …`` → "engine.bank_size"; ``cfg.x = …``
    → "x"."""
    targets = []
    if isinstance(stmt, ast.Assign):
        targets = stmt.targets
    elif isinstance(stmt, ast.AugAssign):
        targets = [stmt.target]
    for tgt in targets:
        parts: List[str] = []
        node = tgt
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name) and node.id == "cfg" and parts:
            return ".".join(reversed(parts))
    return None


def _strings_in(node: ast.AST) -> List[str]:
    return [n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def parse_config(index: ProjectIndex,
                 config_module: Optional[str] = None
                 ) -> Optional[ConfigModel]:
    sf = index.get(config_module or index.mod(CONFIG_MODULE))
    if sf is None:
        return None
    model = ConfigModel()
    model.path = sf.path
    classes: Dict[str, ast.ClassDef] = {
        n.name: n for n in sf.tree.body if isinstance(n, ast.ClassDef)}
    cfg_cls = classes.get("Config")
    if cfg_cls is None:
        return None
    model.fields[""] = _class_fields(cfg_cls)
    # section fields: a Config field whose default_factory names
    # another local dataclass
    for node in cfg_cls.body:
        if not (isinstance(node, ast.AnnAssign)
                and isinstance(node.target, ast.Name)):
            continue
        val = node.value
        if isinstance(val, ast.Call):
            for kw in val.keywords:
                if kw.arg == "default_factory" \
                        and isinstance(kw.value, ast.Name) \
                        and kw.value.id in classes:
                    section = node.target.id
                    model.sections[section] = kw.value.id
                    model.fields[section] = _class_fields(
                        classes[kw.value.id])
    # from_env: each `if env.get("X")…: cfg.y = …` / `if "X" in env:`
    for node in cfg_cls.body:
        if isinstance(node, ast.FunctionDef) and node.name == "from_env":
            for stmt in node.body:
                if not isinstance(stmt, ast.If):
                    continue
                env_vars = [s for s in _strings_in(stmt.test)
                            if s.startswith(ENV_PREFIX)]
                field = None
                for sub in stmt.body:
                    field = _assigned_field(sub) or field
                for var in env_vars:
                    model.env_reads[var] = (field, stmt.lineno)
        if isinstance(node, ast.FunctionDef) and node.name == "from_toml":
            for sub in ast.walk(node):
                # explicit key copies: data.get("key"…) /
                # "key" in data / for key in ("a", "b"…)
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "get" \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id == "data" and sub.args \
                        and isinstance(sub.args[0], ast.Constant) \
                        and isinstance(sub.args[0].value, str):
                    model.toml_keys[sub.args[0].value] = sub.lineno
                elif isinstance(sub, ast.Compare) \
                        and isinstance(sub.left, ast.Constant) \
                        and isinstance(sub.left.value, str) \
                        and any(isinstance(op, ast.In)
                                for op in sub.ops) \
                        and any(isinstance(c, ast.Name)
                                and c.id == "data"
                                for c in sub.comparators):
                    model.toml_keys[sub.left.value] = sub.lineno
                elif isinstance(sub, ast.For) \
                        and isinstance(sub.iter, (ast.Tuple, ast.List)):
                    keys = [e.value for e in sub.iter.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)]
                    # only the `for key in (…): if key in data` idiom
                    body_txt = ast.dump(sub)
                    if "'data'" in body_txt and keys:
                        for k in keys:
                            model.toml_keys[k] = sub.lineno
    return model


def _env_vars_in_tree(index: ProjectIndex, config_module: str
                      ) -> Dict[str, Tuple[str, int]]:
    """Every CILIUM_TPU_* string literal in the package outside the
    config module (ad-hoc knob reads), var → (path, line)."""
    out: Dict[str, Tuple[str, int]] = {}
    for name, sf in sorted(index.files.items()):
        if name == config_module:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                for var in _ENV_RE.findall(node.value):
                    out.setdefault(var, (sf.path, node.lineno))
    return out


def _load_docs(root: Optional[str],
               docs: Optional[Dict[str, str]]) -> Dict[str, str]:
    if docs is not None:
        return docs
    out: Dict[str, str] = {}
    if root is None:
        return out
    for target in DOC_SOURCES:
        full = os.path.join(root, target)
        if os.path.isfile(full):
            with open(full, encoding="utf-8") as f:
                out[target] = f.read()
        elif os.path.isdir(full):
            for name in sorted(os.listdir(full)):
                if name.endswith(".md"):
                    with open(os.path.join(full, name),
                              encoding="utf-8") as f:
                        out[os.path.join(target, name)] = f.read()
    return out


def _doc_mentions(docs: Dict[str, str], token: str) -> bool:
    pat = re.compile(r"\b%s\b" % re.escape(token))
    return any(pat.search(text) for text in docs.values())


def _names_used_outside(index: ProjectIndex,
                        config_module: str) -> Set[str]:
    """Every attribute/keyword/string-constant name appearing outside
    the config module — one tree walk, shared by every dead-knob
    check. Name-level: a shared name keeps a dead knob alive (miss,
    don't invent)."""
    used: Set[str] = set()
    for name, sf in index.files.items():
        if name == config_module:
            continue
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Attribute):
                used.add(node.attr)
            elif isinstance(node, ast.keyword) and node.arg:
                used.add(node.arg)
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str):
                used.add(node.value)
    return used


def check_config(index: ProjectIndex,
                 config_module: Optional[str] = None,
                 docs: Optional[Dict[str, str]] = None
                 ) -> List[Finding]:
    config_module = config_module or index.mod(CONFIG_MODULE)
    model = parse_config(index, config_module)
    if model is None:
        return []
    root = getattr(index, "root", None)
    doc_texts = _load_docs(root, docs)
    findings: List[Finding] = []

    def field_exists(path: str) -> bool:
        if "." in path:
            section, leaf = path.split(".", 1)
            return leaf in model.fields.get(section, {})
        return path in model.fields[""]

    # env ⇄ field
    for var, (field, line) in sorted(model.env_reads.items()):
        if field is None:
            findings.append(Finding(
                model.path, line, RULE,
                f"from_env reads `{var}` but assigns no Config "
                f"field — the override never takes effect"))
        elif not field_exists(field):
            findings.append(Finding(
                model.path, line, RULE,
                f"from_env maps `{var}` to `cfg.{field}`, which is "
                f"not a Config field"))

    # toml ⇄ field
    for key, line in sorted(model.toml_keys.items()):
        if not field_exists(key):
            findings.append(Finding(
                model.path, line, RULE,
                f"from_toml copies key `{key}`, which is not a "
                f"Config field"))

    # env ⇄ docs (both directions) over the whole package
    tree_envs = _env_vars_in_tree(index, config_module)
    all_code_envs: Set[str] = set(tree_envs) | set(model.env_reads)
    if doc_texts:
        for var in sorted(all_code_envs):
            if var.startswith(_ENV_EXEMPT_PREFIXES):
                continue
            if not _doc_mentions(doc_texts, var):
                path, line = tree_envs.get(var, (model.path, 1))
                if var in model.env_reads:
                    path, line = model.path, model.env_reads[var][1]
                findings.append(Finding(
                    path, line, RULE,
                    f"env knob `{var}` is read here but documented "
                    f"nowhere under docs/ — operators cannot "
                    f"discover it"))
        doc_envs: Set[str] = set()
        for text in doc_texts.values():
            doc_envs.update(_ENV_RE.findall(text))
        unported = UNPORTED_ENV.get(index.package, {})
        for var in sorted(doc_envs - all_code_envs):
            if var.startswith(_ENV_EXEMPT_PREFIXES) or var in unported:
                continue
            findings.append(Finding(
                model.path, 1, RULE,
                f"docs mention env var `{var}` but nothing in the "
                f"package reads it — stale documentation"))

    # field ⇄ docs and field ⇄ code
    used_names = _names_used_outside(index, config_module)
    for section, fields in sorted(model.fields.items()):
        for field, line in sorted(fields.items()):
            label = f"{section}.{field}" if section else field
            if doc_texts and not _doc_mentions(doc_texts, field):
                findings.append(Finding(
                    model.path, line, RULE,
                    f"Config field `{label}` is documented nowhere "
                    f"under docs/ — add it to the docs/CONFIG.md "
                    f"catalog"))
            if field not in used_names:
                findings.append(Finding(
                    model.path, line, RULE,
                    f"Config field `{label}` is never read outside "
                    f"{model.path} — dead knob (delete it or wire "
                    f"it up)"))
    return findings


def field_count(index: ProjectIndex,
                config_module: Optional[str] = None) -> int:
    """Config fields visible to the rule — non-vacuity guard hook."""
    model = parse_config(index, config_module)
    if model is None:
        return 0
    return sum(len(f) for f in model.fields.values())


@checker
def check(index: ProjectIndex) -> List[Finding]:
    return check_config(index)
check.emits = (RULE,)
