"""pallas-block-shape: launch-shape hygiene for the hand-written
kernels — in the port, Hopper's.

The reference's rule holds its Pallas kernels to the (8, 128) TPU tile
and pins their matmul accumulators. The port has no Pallas: its kernels
are CUDA C++ for ``sm_90a`` (``<package>/engine/csrc``), launched from
C entry points, and its plain versions run torch's matmuls. The same
two classes of silent hazard have Hopper counterparts, and the rule id
stays the reference's:

* **(a) launch shapes** — read as ``abi-surface`` reads C++ (regex over
  the flat text of each ``.cu`` and the local ``.cuh`` headers it
  includes): every CTA thread count that can be proven literally (a
  ``constexpr int`` expression of integer literals, such as
  ``kThreads = 32 * kWarps``) at a ``<<<grid, block, smem, stream>>>``
  launch must be a multiple of the warp (32), no more than the most
  threads a block may have (1024), and equal to the launched kernel's
  ``__launch_bounds__`` (a block larger than its bounds fails to
  launch; a smaller one wastes the registers the bounds reserved).
  Dynamic shared memory above the default 48 KB per block needs an
  opt-in before the launch: a launch whose dynamic shared memory is
  not provably at most 48 KB is allowed only where the same source
  calls ``cudaFuncSetAttribute(..., cudaFuncAttributeMaxDynamicShared
  MemorySize, ...)`` for that kernel (the kernel named in the call, or
  in the statements just before it — the kernel-pointer array idiom;
  a launch or a definition there does not count).
  An opt-in value, and the Python-side ``SMEM_MAX`` of the package's
  kernel modules, must not exceed Hopper's opt-in limit per block
  (227 KB, 232448 bytes). Without the opt-in the launch fails with
  ``cudaErrorInvalidValue`` only on the card — a CPU test never sees it.
* **(b) exact float products** — a float ``torch.bmm`` /
  ``torch.matmul`` / ``torch.mm`` / ``torch.einsum`` / ``@`` over
  integer-valued one-hots (a ``one_hot`` call, or a comparison cast to
  float, in the same function) computes state ids and counts that must
  stay exact. Under ``torch.backends.cuda.matmul.allow_tf32`` or a
  ``float32_matmul_precision`` below ``"highest"``, CUDA rounds each
  input to TF32's 10-bit mantissa, so integers past 2^11 round: the
  torch counterpart of the reference's unpinned bf16 accumulator. Such
  a product must be guarded the way ``parallel/tp.py``'s
  ``_check_exact_matmul`` guards it (a call that reads the TF32
  settings, in the function or one that encloses it), or carry a
  justified pragma saying why its values stay exact.

The limits (:data:`WARP`, :data:`MAX_THREADS`, :data:`DEFAULT_SMEM`,
:data:`SMEM_OPTIN`) are the H100's; ``chip_smoke.py`` phase 21 checks
them against the card's own properties.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from cilium_tpu_torch.analysis.abi import KERNEL_SOURCES
from cilium_tpu_torch.analysis.callgraph import ModuleInfo, dotted
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "pallas-block-shape"

#: threads per warp
WARP = 32
#: most threads a block may have
MAX_THREADS = 1024
#: dynamic shared memory a block gets without the opt-in
DEFAULT_SMEM = 48 * 1024
#: Hopper's opt-in limit of dynamic shared memory per block (227 KB)
SMEM_OPTIN = 232448

_OPTIN_ATTR = "cudaFuncAttributeMaxDynamicSharedMemorySize"
_CONST_RE = re.compile(
    r"constexpr\s+(?:int|unsigned|size_t|int32_t|uint32_t)\s+"
    r"(?P<name>\w+)\s*=\s*(?P<expr>[^;]+);")
_INCLUDE_RE = re.compile(r'#include\s+"(?P<name>[^"]+)"')
_BOUNDS_RE = re.compile(
    r"__global__\s+void\s+__launch_bounds__\s*\(\s*(?P<bounds>[^,)]+)"
    r"[^)]*\)\s*(?P<name>\w+)\s*\(")
_LAUNCH_RE = re.compile(
    r"(?P<name>\w+)\s*(?:<[^<>;]*>)?\s*<<<(?P<cfg>[^>]*)>>>")
_OPTIN_RE = re.compile(r"cudaFuncSetAttribute\s*\(")


# -- face (a): the C++ side --------------------------------------------------

def _eval_int(expr: str, consts: Dict[str, int]) -> Optional[int]:
    """An integer expression of literals and known constants, else
    None (a runtime value is not guessed at)."""
    expr = expr.strip()
    try:
        tree = ast.parse(expr.replace("/", "//"), mode="eval")
    except SyntaxError:
        return None

    def ev(n: ast.AST) -> Optional[int]:
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name):
            return consts.get(n.id)
        if isinstance(n, ast.BinOp):
            a, b = ev(n.left), ev(n.right)
            if a is None or b is None:
                return None
            ops = {ast.Add: a + b, ast.Sub: a - b, ast.Mult: a * b}
            if isinstance(n.op, ast.FloorDiv) and b:
                return a // b
            if isinstance(n.op, ast.LShift) and 0 <= b < 64:
                return a << b
            return ops.get(type(n.op))
        return None

    return ev(tree.body)


def _line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _with_headers(rel: str, sources: Dict[str, str],
                  seen: Optional[set] = None) -> str:
    """A source's text with its local headers' text before it."""
    seen = seen if seen is not None else set()
    if rel in seen or rel not in sources:
        return ""
    seen.add(rel)
    text = sources[rel]
    base = os.path.dirname(rel)
    head = "".join(_with_headers(os.path.join(base, m.group("name"))
                                 .replace(os.sep, "/"), sources, seen)
                   for m in _INCLUDE_RE.finditer(text))
    return head + "\n" + text


def check_launches(sources: Dict[str, str]) -> List[Finding]:
    """Face (a) over ``{repo-relative path: CUDA text}`` (``.cu`` and
    the ``.cuh`` headers they include)."""
    findings: List[Finding] = []
    for rel in sorted(sources):
        if not rel.endswith(".cu"):
            continue
        text = sources[rel]
        full = _with_headers(rel, sources)
        consts: Dict[str, int] = {}
        for m in _CONST_RE.finditer(full):
            v = _eval_int(m.group("expr"), consts)
            if v is not None:
                consts[m.group("name")] = v
        bounds = {m.group("name"): _eval_int(m.group("bounds"), consts)
                  for m in _BOUNDS_RE.finditer(full)}
        optins = [m.start() for m in _OPTIN_RE.finditer(text)]
        lines = text.splitlines()
        for m in _LAUNCH_RE.finditer(text):
            name = m.group("name")
            cfg = [c.strip() for c in m.group("cfg").split(",")]
            line = _line_of(text, m.start())
            if len(cfg) >= 2:
                threads = _eval_int(cfg[1], consts)
                findings.extend(_thread_findings(rel, line, name, threads,
                                                 bounds.get(name)))
            smem = _eval_int(cfg[2], consts) if len(cfg) >= 3 else 0
            if smem is not None and smem <= DEFAULT_SMEM:
                continue
            if not any(_opts_in(text, lines, pos, name) for pos in optins):
                findings.append(Finding(
                    rel, line, RULE,
                    f"`{name}` launches with dynamic shared memory "
                    f"`{cfg[2]}` that is not provably at most "
                    f"{DEFAULT_SMEM} bytes, and this source never sets "
                    f"{_OPTIN_ATTR} for it — above 48 KB the launch "
                    f"fails on the card"))
        for pos in optins:
            end = text.find(";", pos)
            call = text[pos:end]
            if _OPTIN_ATTR not in call:
                continue
            value = call.split(_OPTIN_ATTR, 1)[1].strip(" ,\n)")
            v = _eval_int(value, consts)
            if v is not None and v > SMEM_OPTIN:
                findings.append(Finding(
                    rel, _line_of(text, pos), RULE,
                    f"shared-memory opt-in of {v} bytes exceeds "
                    f"Hopper's {SMEM_OPTIN} per block"))
    return findings


def _thread_findings(rel: str, line: int, name: str,
                     threads: Optional[int],
                     bound: Optional[int]) -> List[Finding]:
    if threads is None:
        return []   # a runtime block size is not guessed at
    out = []
    if threads % WARP:
        out.append(Finding(
            rel, line, RULE,
            f"`{name}` launches {threads} threads per CTA, not a "
            f"multiple of the {WARP}-thread warp — the last warp runs "
            f"partly empty"))
    if threads > MAX_THREADS:
        out.append(Finding(
            rel, line, RULE,
            f"`{name}` launches {threads} threads per CTA, above the "
            f"{MAX_THREADS} a block may have — the launch fails"))
    if bound is not None and bound != threads:
        out.append(Finding(
            rel, line, RULE,
            f"`{name}` launches {threads} threads per CTA but its "
            f"__launch_bounds__ is {bound}"))
    return out


def _opts_in(text: str, lines: List[str], pos: int, name: str) -> bool:
    """Does the ``cudaFuncSetAttribute`` call at ``pos`` raise the
    dynamic shared memory of kernel ``name``?"""
    end = text.find(";", pos)
    call = text[pos:end]
    if _OPTIN_ATTR not in call:
        return False
    line = _line_of(text, pos)
    # the kernel-pointer array idiom: the kernel named in a statement
    # just before the call (a launch or a definition is not one)
    window = "\n".join(t for t in lines[max(0, line - 9):line - 1]
                       if "<<<" not in t and "__global__" not in t)
    return re.search(rf"\b{re.escape(name)}\b", call + window) is not None


def kernel_sources(index: ProjectIndex) -> Dict[str, str]:
    """The package's ``.cu`` / ``.cuh`` texts, read off the tree."""
    root = getattr(index, "root", None)
    out: Dict[str, str] = {}
    if root is None:
        return out
    kdir = index.rel(KERNEL_SOURCES)
    full = os.path.join(root, kdir)
    if not os.path.isdir(full):
        return out
    for n in sorted(os.listdir(full)):
        if n.endswith((".cu", ".cuh")):
            with open(os.path.join(full, n), encoding="utf-8") as f:
                out[f"{kdir}/{n}"] = f.read()
    return out


def _smem_max_findings(index: ProjectIndex) -> List[Finding]:
    """Python-side ``SMEM_MAX`` constants of the kernel modules."""
    out = []
    prefix = index.rel("engine/")
    for sf in index.files.values():
        if not sf.path.startswith(prefix):
            continue
        for node in sf.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == "SMEM_MAX" \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, int) \
                    and node.value.value > SMEM_OPTIN:
                out.append(Finding(
                    sf.path, node.lineno, RULE,
                    f"SMEM_MAX {node.value.value} exceeds Hopper's "
                    f"opt-in limit of {SMEM_OPTIN} bytes per block"))
    return out


# -- face (b): exact float products ------------------------------------------

_MATMULS = {"torch.bmm", "torch.matmul", "torch.mm", "torch.einsum"}
_GUARD_ATTRS = ("allow_tf32", "get_float32_matmul_precision")


def _own_nodes(fn: ast.AST):
    """``fn``'s nodes, nested defs excluded (they are checked on
    their own, with ``fn`` as an enclosing scope)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _is_indicator(node: ast.AST) -> bool:
    """A one-hot: a ``one_hot`` call, or a comparison cast to float."""
    if not isinstance(node, ast.Call):
        return False
    d = dotted(node.func) or ""
    if d.rsplit(".", 1)[-1] == "one_hot":
        return True
    if isinstance(node.func, ast.Attribute) \
            and isinstance(node.func.value, ast.Compare):
        if node.func.attr == "float":
            return True
        if node.func.attr == "to" and node.args and \
                (dotted(node.args[0]) or "").endswith("float32"):
            return True
    return False


def _guards(fn: ast.AST, guard_fns: set) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and node.attr in _GUARD_ATTRS:
            return True
        if isinstance(node, ast.Call):
            d = dotted(node.func) or ""
            if d.rsplit(".", 1)[-1] in guard_fns:
                return True
    return False


def check_products(index: ProjectIndex) -> List[Finding]:
    """Face (b) over the indexed modules."""
    findings: List[Finding] = []
    for sf in index.files.values():
        # the guard functions of this module: they read the settings
        mi = ModuleInfo(sf)
        guard_fns = {n.name for n in ast.walk(sf.tree)
                     if isinstance(n, ast.FunctionDef)
                     and any(isinstance(a, ast.Attribute)
                             and a.attr in _GUARD_ATTRS
                             for a in ast.walk(n))}
        stack: List[Tuple[ast.AST, Tuple[ast.AST, ...]]] = [
            (n, ()) for n in sf.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))]
        while stack:
            node, outer = stack.pop()
            if isinstance(node, ast.ClassDef):
                stack.extend((n, outer) for n in node.body
                             if isinstance(n, (ast.FunctionDef,
                                               ast.AsyncFunctionDef)))
                continue
            scopes = outer + (node,)
            for sub in _own_nodes(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    stack.append((sub, scopes))
            findings.extend(_product_findings(mi, node, scopes,
                                              guard_fns))
    return findings


def _product_findings(mi: ModuleInfo, fn: ast.AST,
                      scopes: Tuple[ast.AST, ...],
                      guard_fns: set) -> List[Finding]:
    path = mi.sf.path
    products = []
    for node in _own_nodes(fn):
        if isinstance(node, ast.Call):
            d = dotted(node.func) or ""
            q = mi.qualify(node.func) or d
            # torch's own product, or a tensor's method (a module's
            # function of another library is not CUDA's)
            module_fn = d.split(".")[0] in mi.imports
            if q in _MATMULS or (isinstance(node.func, ast.Attribute)
                                 and node.func.attr in ("bmm", "matmul",
                                                        "mm")
                                 and not module_fn):
                products.append((node.lineno, d or node.func.attr))
        elif isinstance(node, ast.BinOp) and isinstance(node.op,
                                                         ast.MatMult):
            products.append((node.lineno, "@"))
    if not products:
        return []
    if not any(_is_indicator(n) for s in scopes for n in ast.walk(s)):
        return []
    if any(_guards(s, guard_fns) for s in scopes):
        return []
    name = getattr(fn, "name", "<lambda>")
    return [Finding(
        path, line, RULE,
        f"float product `{what}` over integer-valued one-hots in "
        f"`{name}` with no TF32 guard — under allow_tf32 or a float32 "
        f"matmul precision below 'highest' CUDA rounds its inputs to "
        f"a 10-bit mantissa (integers past 2^11 round); check the "
        f"settings (as parallel/tp.py's _check_exact_matmul does) or "
        f"justify why the values stay exact")
        for line, what in products]


@checker
def check(index: ProjectIndex,
          cuda_sources: Optional[Dict[str, str]] = None
          ) -> List[Finding]:
    if cuda_sources is None:
        cuda_sources = kernel_sources(index)
    return (check_launches(cuda_sources) + _smem_max_findings(index)
            + check_products(index))
check.emits = (RULE,)
