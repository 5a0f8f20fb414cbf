"""abi-surface: the C↔Python ctypes contract, machine-diffed.

The reference crosses the language boundary twice: the proxylib-ABI
shim (``shim/cilium_shim.cpp`` → ``cshim_*``) and the capture codec
(``native/capture/capture.cpp`` → ``ct_capture_*``). The port crosses
it at its hand-written CUDA kernels: each ``<package>/engine/csrc/*.cu``
exports one ``extern "C"`` launcher (``ct_dfa_dense``,
``ct_nfa_scan``, ``ct_dfa_oblivious``, ``ct_resolve_groups``) and
``ct_error_string``; its tests bind the reference's shim too. All are
loaded with raw ``ctypes.CDLL`` — there is no header parser, no stub
generator, nothing that fails at import time when a C signature gains
an argument or changes a width. The failure mode of drift is a
segfault (wrong arity / wrong pointer marshaling) or silent value
truncation (a ``long`` return read through the ``c_int`` default),
neither of which a green unit test on the happy path rules out.

This rule parses every ``extern "C"`` function in the repo's C++
sources and diffs the surface **bidirectionally** against every
Python use — ``argtypes``/``restype`` declarations and raw call
arity — in the package *and* in the test/bench surfaces that bind
the shim directly:

* a Python binding or call of an unknown ``cshim_*``/``ct_capture_*``
  symbol (deleted or typo'd on the C side);
* ``argtypes`` arity or per-position type drift (each C type has a
  small set of legal ctypes spellings);
* a missing/wrong ``restype`` where the ctypes default (``c_int``)
  truncates or misreads the C return (``long``, ``uint32_t``,
  ``double``, ``void``);
* a call through a symbol that takes pointers but was never given
  ``argtypes`` in that file (nothing checks the marshaling);
* call-site arity that disagrees with the C parameter count;
* a C symbol no scanned Python file binds or calls (dead ABI).

The port binds a kernel's symbol through its ``Kernel(name, source,
symbol, argtypes, replaces)`` declaration (``engine/_build.py``): the
``symbol`` and ``argtypes`` arguments (a list expression of module
aliases such as ``[_P] * 7 + [_I] * 5 + [_P]``) are read as an
``argtypes`` declaration of that symbol (in the package's modules;
a test's probe ``Kernel`` is not a binding); ``Kernel.launch`` calls
through the bound function, whose arity ctypes itself checks against
those argtypes. A Python use counts only for the symbol families of
the C sources in the run's surface (:data:`SYMBOL_PREFIXES` of the
symbols parsed), so a test that binds a kernel the indexed package
does not have is not read as drift of that package.

Surfaces a package does not bind are named in
:data:`UNBOUND_SURFACES` with the reason; they are not read for it.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker
from cilium_tpu_torch.analysis.callgraph import dotted

RULE = "abi-surface"

#: repo-relative C++ sources carrying the extern "C" surfaces
CPP_SOURCES = ("shim/cilium_shim.cpp", "native/capture/capture.cpp")

#: the package's own CUDA kernels: every ``*.cu`` under
#: ``<package>/engine/csrc`` (the port's K1, K2, KD and KR)
KERNEL_SOURCES = "engine/csrc"

#: C sources a package does not bind, by package, with the reason
UNBOUND_SURFACES: Dict[str, Dict[str, str]] = {
    "cilium_tpu_torch": {
        "native/capture/capture.cpp":
            "the port reads and writes captures with numpy only "
            "(ingest/binary.py is the reference's byte-identical "
            "fallback); its one native surface is its kernels",
    },
}

#: extra Python surfaces (outside the package) that bind the ABI
EXTRA_PY = ("tests", "bench_service.py")

#: symbol prefixes that mark our ABI (anything else is ignored)
SYMBOL_PREFIXES = ("cshim_", "ct_capture_", "ct_dfa_", "ct_nfa_",
                   "ct_resolve_", "ct_error_string")

# -- C side -----------------------------------------------------------------

_FN_RE = re.compile(
    r"^\s*(?:extern\s+\"C\"\s+)?"
    r"(?P<ret>[A-Za-z_][A-Za-z0-9_ ]*?[\*\s])\s*"
    r"(?P<name>(?:%s)[A-Za-z0-9_]*)\s*\("
    % "|".join(SYMBOL_PREFIXES), re.M)


#: C-side allowlist: ``// ctlint: disable=abi-surface  # why`` on the
#: signature line or a comment line directly above exempts the symbol
#: from the dead-ABI (unbound) check — Python pragmas cannot annotate
#: a .cpp file. A justification is still required (bare pragmas are
#: ignored, so the finding stays).
_CPP_DISABLE_RE = re.compile(
    r"//\s*ctlint:\s*disable=abi-surface\s*#\s*\S")


class CSymbol:
    def __init__(self, name: str, ret: str, params: List[str],
                 path: str, line: int, allow_unbound: bool = False):
        self.name = name
        self.ret = ret          # normalized C return type
        self.params = params    # normalized C param types
        self.path = path
        self.line = line
        self.allow_unbound = allow_unbound


def _norm_ctype(t: str) -> str:
    t = t.replace("const", " ").replace("struct", " ")
    t = re.sub(r"\s+", " ", t).strip()
    t = t.replace(" *", "*").replace("* ", "*")
    return t


def _split_params(blob: str) -> List[str]:
    blob = blob.strip()
    if blob in ("", "void"):
        return []
    out = []
    for part in blob.split(","):
        part = _norm_ctype(part)
        # drop the trailing parameter name (last identifier not part
        # of the type); pointer stars belong to the type
        m = re.match(r"^(.*?)([A-Za-z_][A-Za-z0-9_]*)$", part)
        ty = m.group(1).strip() if m else part
        if not ty:            # unnamed param: the whole token is a type
            ty = part
        out.append(_norm_ctype(ty))
    return out


def parse_extern_c(source: str, path: str) -> List[CSymbol]:
    """All ABI-prefixed function definitions/declarations in one C++
    source (regex over the flat text: the shim surface is plain
    C-style signatures, which is the point of ``extern "C"``)."""
    out: List[CSymbol] = []
    for m in _FN_RE.finditer(source):
        start = m.end()
        depth = 1
        i = start
        while i < len(source) and depth:
            if source[i] == "(":
                depth += 1
            elif source[i] == ")":
                depth -= 1
            i += 1
        params = _split_params(source[start:i - 1])
        line = source.count("\n", 0, m.start()) + 1
        lines = source.splitlines()
        context = lines[max(0, line - 2):line]
        allow = any(_CPP_DISABLE_RE.search(t) for t in context)
        out.append(CSymbol(m.group("name"), _norm_ctype(m.group("ret")),
                           params, path, line, allow_unbound=allow))
    return out


#: C type → legal ctypes spellings for argtypes
_ARG_OK: Dict[str, Set[str]] = {
    "char*": {"c_char_p", "c_void_p"},
    "uint8_t*": {"c_void_p", "c_char_p", "POINTER(c_uint8)"},
    "void*": {"c_void_p", "c_char_p", "POINTER(c_uint8)"},
    "uint16_t*": {"POINTER(c_uint16)"},
    "uint32_t*": {"POINTER(c_uint32)"},
    "uint64_t*": {"POINTER(c_uint64)"},
    "int32_t*": {"POINTER(c_int32)"},
    "int64_t*": {"POINTER(c_int64)"},
    "long long*": {"c_void_p", "POINTER(c_longlong)",
                   "POINTER(c_int64)"},
    "size_t": {"c_size_t", "c_uint64"},
    "uint64_t": {"c_uint64"},
    "uint32_t": {"c_uint32"},
    "uint16_t": {"c_uint16"},
    "uint8_t": {"c_uint8"},
    "int": {"c_int"},
    "long": {"c_long"},
    "double": {"c_double"},
    "float": {"c_float"},
}

#: C return type → (required restype spellings, None-default is safe)
_RET_OK: Dict[str, Tuple[Set[str], bool]] = {
    "int": ({"c_int"}, True),          # ctypes default IS c_int
    "long": ({"c_long"}, False),       # default truncates on LP64
    "void": ({"None"}, False),         # default reads garbage
    "uint32_t": ({"c_uint32"}, False),  # default sign-misreads
    "uint64_t": ({"c_uint64"}, False),
    "double": ({"c_double"}, False),
    "char*": ({"c_char_p"}, False),
}


def _arg_ok(cty: str, spelling: str) -> bool:
    allowed = _ARG_OK.get(cty)
    if allowed is None:
        return True  # unknown C type: miss, don't invent
    return spelling in allowed


# -- Python side ------------------------------------------------------------

class PyUse:
    """Everything one Python file says about one symbol."""

    def __init__(self) -> None:
        self.argtypes: Optional[Tuple[List[str], int]] = None
        self.restype: Optional[Tuple[str, int]] = None
        self.calls: List[Tuple[int, int]] = []   # (arity, line)
        self.hasattr_probe = False


def _ctypes_spelling(node: ast.expr) -> str:
    """`ctypes.c_uint32` → "c_uint32"; `ctypes.POINTER(ctypes.c_int32)`
    → "POINTER(c_int32)"; `None` → "None"."""
    if isinstance(node, ast.Constant) and node.value is None:
        return "None"
    d = dotted(node)
    if d is not None:
        return d.rsplit(".", 1)[-1]
    if isinstance(node, ast.Call):
        f = dotted(node.func) or ""
        leaf = f.rsplit(".", 1)[-1]
        inner = _ctypes_spelling(node.args[0]) if node.args else "?"
        return f"{leaf}({inner})"
    return "?"


def _module_aliases(tree: ast.AST) -> Dict[str, str]:
    """Top-level ``_P = ctypes.c_void_p`` aliases → their spelling."""
    out: Dict[str, str] = {}
    for node in getattr(tree, "body", ()):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            d = dotted(node.value) or ""
            if d.startswith("ctypes."):
                out[node.targets[0].id] = d.rsplit(".", 1)[-1]
    return out


def _list_spellings(node: ast.expr, aliases: Dict[str, str]
                    ) -> Optional[List[str]]:
    """An argtypes list expression: a list literal, ``[x] * n`` and
    ``a + b`` of those; None when it is anything else."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return [aliases.get(e.id, e.id) if isinstance(e, ast.Name)
                and e.id in aliases else _ctypes_spelling(e)
                for e in node.elts]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a = _list_spellings(node.left, aliases)
        b = _list_spellings(node.right, aliases)
        return a + b if a is not None and b is not None else None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        lst, n = node.left, node.right
        if isinstance(lst, ast.Constant):
            lst, n = n, lst
        a = _list_spellings(lst, aliases)
        if a is not None and isinstance(n, ast.Constant) \
                and isinstance(n.value, int):
            return a * n.value
    return None


def _kernel_binding(node: ast.Call, aliases: Dict[str, str]
                    ) -> Optional[Tuple[str, List[str]]]:
    """``Kernel(name, source, symbol, argtypes, replaces)`` → (symbol,
    argtypes spellings); None for any other call."""
    if (dotted(node.func) or "").rsplit(".", 1)[-1] != "Kernel":
        return None
    args = {i: a for i, a in enumerate(node.args)}
    kws = {k.arg: k.value for k in node.keywords}
    sym = kws.get("symbol", args.get(2))
    types = kws.get("argtypes", args.get(3))
    if not (isinstance(sym, ast.Constant) and isinstance(sym.value, str)
            and sym.value.startswith(SYMBOL_PREFIXES)) or types is None:
        return None
    spelt = _list_spellings(types, aliases)
    return None if spelt is None else (sym.value, spelt)


def scan_python(tree: ast.AST, kernels: bool = True) -> Dict[str, PyUse]:
    """Collect argtypes/restype/call uses of ABI symbols in one
    module; ``kernels`` reads ``Kernel(...)`` declarations as bindings
    (the package's own modules — a test's probe ``Kernel`` stubs its C
    function and never loads the library)."""
    uses: Dict[str, PyUse] = {}
    aliases = _module_aliases(tree)

    def use(sym: str) -> PyUse:
        return uses.setdefault(sym, PyUse())

    for node in ast.walk(tree):
        if kernels and isinstance(node, ast.Call):
            bound = _kernel_binding(node, aliases)
            if bound is not None:
                use(bound[0]).argtypes = (bound[1], node.lineno)
                continue
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Attribute):
            tgt = node.targets[0]
            if tgt.attr in ("argtypes", "restype") \
                    and isinstance(tgt.value, ast.Attribute):
                sym = tgt.value.attr
                if sym.startswith(SYMBOL_PREFIXES):
                    if tgt.attr == "argtypes" and isinstance(
                            node.value, (ast.List, ast.Tuple)):
                        use(sym).argtypes = (
                            [_ctypes_spelling(e)
                             for e in node.value.elts],
                            node.lineno)
                    elif tgt.attr == "restype":
                        use(sym).restype = (
                            _ctypes_spelling(node.value), node.lineno)
        elif isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and f.attr.startswith(SYMBOL_PREFIXES):
                use(f.attr).calls.append((len(node.args), node.lineno))
            elif isinstance(f, ast.Name) and f.id == "hasattr" \
                    and len(node.args) == 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str) \
                    and node.args[1].value.startswith(SYMBOL_PREFIXES):
                use(node.args[1].value).hasattr_probe = True
    return uses


# -- the diff ---------------------------------------------------------------

def diff(c_symbols: Sequence[CSymbol],
         py_files: Dict[str, Dict[str, PyUse]],
         surfaces: Sequence[str] = CPP_SOURCES) -> List[Finding]:
    by_name = {s.name: s for s in c_symbols}
    findings: List[Finding] = []
    bound: Set[str] = set()
    #: only the symbol families the parsed C sources export are read
    live = tuple(p for p in SYMBOL_PREFIXES
                 if any(s.name.startswith(p) for s in c_symbols))

    for path, uses in sorted(py_files.items()):
        for sym, use in sorted(uses.items()):
            if not sym.startswith(live):
                continue
            bound.add(sym)
            c = by_name.get(sym)
            line = (use.argtypes[1] if use.argtypes
                    else use.restype[1] if use.restype
                    else use.calls[0][1] if use.calls else 1)
            if c is None:
                findings.append(Finding(
                    path, line, RULE,
                    f"`{sym}` is bound/called here but no extern "
                    f"\"C\" symbol of that name exists in "
                    f"{', '.join(surfaces)}"))
                continue
            if use.argtypes is not None:
                spelt, aline = use.argtypes
                if len(spelt) != len(c.params):
                    findings.append(Finding(
                        path, aline, RULE,
                        f"`{sym}` argtypes declares {len(spelt)} "
                        f"parameter(s) but the C signature has "
                        f"{len(c.params)} ({c.path}:{c.line})"))
                else:
                    for i, (py, cty) in enumerate(zip(spelt, c.params)):
                        if not _arg_ok(cty, py):
                            findings.append(Finding(
                                path, aline, RULE,
                                f"`{sym}` argtypes[{i}] is `{py}` "
                                f"but the C parameter is `{cty}` "
                                f"({c.path}:{c.line})"))
            ret_rule = _RET_OK.get(c.ret)
            if use.restype is not None and ret_rule is not None:
                spelt, rline = use.restype
                if spelt not in ret_rule[0]:
                    findings.append(Finding(
                        path, rline, RULE,
                        f"`{sym}` restype `{spelt}` does not match "
                        f"the C return `{c.ret}` "
                        f"({c.path}:{c.line})"))
            if use.restype is None and use.calls and ret_rule is not None \
                    and not ret_rule[1]:
                findings.append(Finding(
                    path, use.calls[0][1], RULE,
                    f"`{sym}` returns C `{c.ret}` but this file "
                    f"never sets restype — the ctypes default "
                    f"(c_int) misreads it"))
            if use.argtypes is None and use.calls \
                    and any("*" in p for p in c.params):
                findings.append(Finding(
                    path, use.calls[0][1], RULE,
                    f"`{sym}` takes pointer parameters but this "
                    f"file calls it without declaring argtypes — "
                    f"nothing checks the marshaling"))
            for arity, cline in use.calls:
                if arity != len(c.params):
                    findings.append(Finding(
                        path, cline, RULE,
                        f"`{sym}` called with {arity} argument(s) "
                        f"but the C signature has {len(c.params)} "
                        f"({c.path}:{c.line})"))

    for s in c_symbols:
        if s.name not in bound and not s.allow_unbound:
            findings.append(Finding(
                s.path, s.line, RULE,
                f"extern \"C\" `{s.name}` is never bound or called "
                f"from any scanned Python surface — dead ABI or a "
                f"missing binding"))
    return findings


# -- wiring -----------------------------------------------------------------

def _root_of(index: ProjectIndex) -> Optional[str]:
    return getattr(index, "root", None)


def surfaces(index: ProjectIndex) -> List[str]:
    """The C sources the run's package binds: :data:`CPP_SOURCES` but
    its :data:`UNBOUND_SURFACES`, then its own kernel directory's
    ``*.cu`` files when the tree has them."""
    unbound = UNBOUND_SURFACES.get(index.package, {})
    out = [rel for rel in CPP_SOURCES if rel not in unbound]
    root = _root_of(index)
    kdir = index.rel(KERNEL_SOURCES)
    if root is not None and os.path.isdir(os.path.join(root, kdir)):
        out.extend(f"{kdir}/{n}" for n in sorted(
            os.listdir(os.path.join(root, kdir))) if n.endswith(".cu"))
    return out


def _iter_extra_py(root: str):
    for target in EXTRA_PY:
        full = os.path.join(root, target)
        if os.path.isfile(full):
            yield target, full
        elif os.path.isdir(full):
            for name in sorted(os.listdir(full)):
                if name.endswith(".py"):
                    yield os.path.join(target, name), \
                        os.path.join(full, name)


def check_abi(index: ProjectIndex,
              cpp_sources: Optional[Dict[str, str]] = None,
              extra_py: Optional[Dict[str, str]] = None
              ) -> List[Finding]:
    """``cpp_sources``/``extra_py`` map repo-relative path → text; the
    corpus-test face. Defaults read the real tree off ``index.root``."""
    root = _root_of(index)
    names = surfaces(index)
    if cpp_sources is None:
        cpp_sources = {}
        if root is not None:
            for rel in names:
                full = os.path.join(root, rel)
                if os.path.exists(full):
                    with open(full, encoding="utf-8") as f:
                        cpp_sources[rel] = f.read()
    if not cpp_sources:
        return []   # in-memory corpus with no C side: nothing to diff

    c_symbols: List[CSymbol] = []
    for rel, text in sorted(cpp_sources.items()):
        c_symbols.extend(parse_extern_c(text, rel))

    py_files: Dict[str, Dict[str, PyUse]] = {}
    for sf in index.files.values():
        uses = scan_python(sf.tree)
        if uses:
            py_files[sf.path] = uses
    if extra_py is None:
        extra_py = {}
        if root is not None:
            for rel, full in _iter_extra_py(root):
                try:
                    with open(full, encoding="utf-8") as f:
                        text = f.read()
                except OSError:
                    continue
                if any(p in text for p in SYMBOL_PREFIXES):
                    extra_py[rel] = text
    for rel, text in sorted(extra_py.items()):
        try:
            tree = ast.parse(text, filename=rel)
        except SyntaxError:
            continue  # parse errors in extra surfaces are not ABI drift
        uses = scan_python(tree, kernels=False)
        if uses:
            py_files[rel] = uses

    return diff(c_symbols, py_files,
                [n for n in names if not n.endswith(".cu")]
                + ([f"{index.rel(KERNEL_SOURCES)}/*.cu"]
                   if any(n.endswith(".cu") for n in names) else []))


def symbol_count(index: ProjectIndex) -> int:
    """C symbols visible to the rule — the non-vacuity guard hook."""
    root = _root_of(index)
    n = 0
    if root is None:
        return 0
    for rel in surfaces(index):
        full = os.path.join(root, rel)
        if os.path.exists(full):
            with open(full, encoding="utf-8") as f:
                n += len(parse_extern_c(f.read(), rel))
    return n


@checker
def check(index: ProjectIndex) -> List[Finding]:
    return check_abi(index)
check.emits = (RULE,)
