"""ctlint's dataflow core: a forward abstract interpreter for the
device surface — in the port, torch tensors.

The syntactic rules can see a call to ``torch.sum`` but not what flows
*into* it. This module adds the missing half: an abstract-value
lattice for the Python/torch values that appear in this
codebase (arrays with partially-known shapes and dtypes, const host
scalars, shape-derived scalars, opaque host objects) and a forward
interpreter that propagates them through a function body — across
assignments, tuple unpacking, branches (joined), loops (widened), and
interprocedurally through calls the project index can resolve
(depth-bounded; an unresolvable callee degrades to ⊤, never guesses).

Shape seeding exploits this repo's kernel-comment convention: a
device entry may document its parameters as ``trans,  # [S, K]
int32``. The interpreter parses those trailing comments into symbolic
shapes (``S``/``K`` become symbolic dims, equal symbols compare
equal), which is what lets it prove e.g. that a ``take_along_axis``
rank mismatch is real rather than merely possible. The bias
everywhere is the framework's: **miss, don't invent** — two distinct
symbols are *unknown*-compatible, not incompatible.

The op vocabulary is torch's: ``torch.<op>`` calls and tensor methods
(``.sum``, ``.reshape``, ``.to``, ``.gather`` …) alongside numpy's
host ops. Residency follows torch's rules, not jnp's: a ``torch.*``
constructor is device-resident only when it is given a ``device=``
(other than the literal ``"cpu"``), ``.to(dev)`` / ``.cuda()`` move a
host value to the card, every other op's result lies where its tensor
inputs lie, and ``.cpu()`` / ``.numpy()`` / ``np.asarray`` /
``.item()`` / ``.tolist()`` / ``float()`` bring it back.

Rule families consume the interpreter through an :class:`EventSink`:
the core reports semantic events (a broadcast, a reduction, a
shape-derived branch, a closure scalar reaching a shape position) and
the rule modules (``shapes.py``, ``recompile.py``) turn the ones they
care about into findings. The core itself emits nothing.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Tuple

from cilium_tpu_torch.analysis.callgraph import ModuleInfo, Project, dotted

# -- the value lattice ------------------------------------------------------

#: dimensions are ints (known), Sym (named symbolic — equal name ⇒
#: equal extent), or None (unknown)
class Sym(str):
    """A named symbolic dimension (``B``, ``S``, ``L``…)."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return str(self)


Dim = object  # int | Sym | None

_INT_DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32",
               "int64", "uint64")
_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")
_DTYPES = ("bool",) + _INT_DTYPES + _FLOAT_DTYPES

#: value range of each integer dtype (for weak-type wrap detection)
_INT_RANGE = {
    "int8": (-128, 127), "uint8": (0, 255),
    "int16": (-32768, 32767), "uint16": (0, 65535),
    "int32": (-2**31, 2**31 - 1), "uint32": (0, 2**32 - 1),
    "int64": (-2**63, 2**63 - 1), "uint64": (0, 2**64 - 1),
}


class AbsVal:
    """One abstract value. ``kind`` ∈ {"const", "tuple", "array",
    "host", "devref", "top"}.

    * const — a known host scalar (``.const``); ``from_shape`` marks
      values derived from a traced array's ``.shape`` (a symbolic dim
      is a const whose value is a :class:`Sym`).
    * tuple — a fixed-length sequence of AbsVals (``.items``).
    * array — a (possibly traced) array: ``.shape`` is a tuple of
      dims or None (unknown rank), ``.dtype`` a dtype string or None,
      ``.weak`` marks weak-typed scalars promoted from Python consts.
    * host — a non-array host object (lock, dict, config…).
    * devref — a tensor's ``.device``: ``device`` says whether that
      tensor is device-resident (so ``torch.zeros(…, device=x.device)``
      lies where ``x`` lies).
    * top — unknown.

    ``origin`` is a human-readable provenance ("param `trans`",
    "closure `block`", "cfg.engine.batch_size") carried into findings.

    ``device`` is the v4 residency dimension: True when the value is
    (provably) device-resident — produced by a kernel wrapper or a
    device step, a ``torch.*`` constructor given ``device=``,
    ``.to(dev)`` / ``.cuda()``, an op over device tensors, or a staged
    device table. ``dev_chain`` is its def-site provenance — the chain
    of ``path:line what`` sites that made it device-resident — carried
    into device-dataflow findings as the ``residency`` field. The join
    bias is the framework's: residency survives a join only when BOTH
    sides are device (miss, don't invent).
    """

    __slots__ = ("kind", "const", "items", "shape", "dtype", "weak",
                 "from_shape", "origin", "device", "dev_chain")

    def __init__(self, kind: str, const=None, items=None, shape=None,
                 dtype: Optional[str] = None, weak: bool = False,
                 from_shape: bool = False, origin: str = "",
                 device: bool = False,
                 dev_chain: Tuple[str, ...] = ()):
        self.kind = kind
        self.const = const
        self.items = items
        self.shape = shape
        self.dtype = dtype
        self.weak = weak
        self.from_shape = from_shape
        self.origin = origin
        self.device = device
        self.dev_chain = dev_chain

    # constructors
    @staticmethod
    def top(origin: str = "") -> "AbsVal":
        return AbsVal("top", origin=origin)

    @staticmethod
    def host(origin: str = "") -> "AbsVal":
        return AbsVal("host", origin=origin)

    @staticmethod
    def const_(value, from_shape: bool = False,
               origin: str = "") -> "AbsVal":
        return AbsVal("const", const=value, from_shape=from_shape,
                      origin=origin)

    @staticmethod
    def tuple_(items: Sequence["AbsVal"], origin: str = "") -> "AbsVal":
        return AbsVal("tuple", items=list(items), origin=origin)

    @staticmethod
    def array(shape: Optional[Tuple], dtype: Optional[str],
              weak: bool = False, origin: str = "",
              device: bool = False,
              dev_chain: Tuple[str, ...] = ()) -> "AbsVal":
        return AbsVal("array", shape=shape, dtype=dtype, weak=weak,
                      origin=origin, device=device,
                      dev_chain=dev_chain)

    @property
    def is_array(self) -> bool:
        return self.kind == "array"

    @property
    def rank(self) -> Optional[int]:
        return None if self.shape is None else len(self.shape)

    def describe(self) -> str:
        if self.kind == "array":
            dims = "?" if self.shape is None else \
                "[" + ", ".join(str(d) if d is not None else "?"
                                for d in self.shape) + "]"
            return f"{dims} {self.dtype or '?'}"
        if self.kind == "const":
            return f"const {self.const!r}"
        return self.kind

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<AbsVal {self.describe()}>"


def join(a: AbsVal, b: AbsVal) -> AbsVal:
    """Least upper bound — degrade to the weakest description that
    covers both."""
    if a is b:
        return a
    if a.kind == "top" or b.kind == "top":
        return AbsVal.top(origin=a.origin or b.origin)
    if a.kind != b.kind:
        return AbsVal.top(origin=a.origin or b.origin)
    fs = a.from_shape or b.from_shape
    if a.kind == "const":
        if a.const == b.const and type(a.const) is type(b.const):
            return AbsVal.const_(a.const, from_shape=fs, origin=a.origin)
        return AbsVal("const", const=None, from_shape=fs,
                      origin=a.origin or b.origin)
    if a.kind == "tuple":
        if len(a.items) != len(b.items):
            return AbsVal.host(origin=a.origin)
        return AbsVal.tuple_([join(x, y)
                              for x, y in zip(a.items, b.items)],
                             origin=a.origin)
    if a.kind == "devref":
        dev = a.device and b.device
        return AbsVal("devref", origin=a.origin or b.origin, device=dev,
                      dev_chain=(a.dev_chain or b.dev_chain)
                      if dev else ())
    if a.kind == "array":
        shape = None
        if a.shape is not None and b.shape is not None \
                and len(a.shape) == len(b.shape):
            shape = tuple(x if _dim_eq(x, y) else None
                          for x, y in zip(a.shape, b.shape))
        dtype = a.dtype if a.dtype == b.dtype else None
        # residency survives only when BOTH arms are device-resident
        dev = a.device and b.device
        return AbsVal.array(shape, dtype, weak=a.weak and b.weak,
                            origin=a.origin or b.origin,
                            device=dev,
                            dev_chain=(a.dev_chain or b.dev_chain)
                            if dev else ())
    return AbsVal.host(origin=a.origin or b.origin)


def widen(old: AbsVal, new: AbsVal) -> AbsVal:
    """Loop widening: any still-changing component jumps straight to
    unknown so the fixpoint terminates in two passes."""
    j = join(old, new)
    if j.kind == "array":
        if old.kind == "array" and old.shape != j.shape:
            j = AbsVal.array(None, j.dtype, weak=j.weak,
                             origin=j.origin, device=j.device,
                             dev_chain=j.dev_chain)
    elif j.kind == "const" and old.kind == "const" \
            and old.const != new.const:
        j = AbsVal("const", const=None, from_shape=j.from_shape,
                   origin=j.origin)
    return j


def _dim_eq(a: Dim, b: Dim) -> bool:
    if a is None or b is None:
        return False
    if isinstance(a, Sym) or isinstance(b, Sym):
        return isinstance(a, Sym) and isinstance(b, Sym) and str(a) == str(b)
    return a == b


def _dim_conflict(a: Dim, b: Dim) -> bool:
    """True only when both extents are KNOWN and provably unequal —
    two distinct symbols are unknown-compatible (miss, don't invent)."""
    if isinstance(a, int) and isinstance(b, int):
        return a != b
    if isinstance(a, Sym) and isinstance(b, Sym):
        return False
    return False


def broadcast_shapes(a: Optional[Tuple], b: Optional[Tuple]
                     ) -> Tuple[Optional[Tuple], Optional[Tuple[Dim, Dim, int]]]:
    """Numpy broadcasting over symbolic shapes. Returns
    ``(result_shape, conflict)`` where conflict is ``(dim_a, dim_b,
    axis_from_end)`` for a provable mismatch, else None."""
    if a is None or b is None:
        return None, None
    out: List[Dim] = []
    for i in range(1, max(len(a), len(b)) + 1):
        da = a[-i] if i <= len(a) else 1
        db = b[-i] if i <= len(b) else 1
        if da == 1:
            out.append(db)
        elif db == 1:
            out.append(da)
        elif _dim_eq(da, db):
            out.append(da)
        elif _dim_conflict(da, db):
            return None, (da, db, i)
        else:
            out.append(None)
    return tuple(reversed(out)), None


def promote(a: AbsVal, b: AbsVal) -> Optional[str]:
    """Result dtype of a binary op (torch's type promotion between
    tensors; a Python scalar is the weak operand). A weak
    operand adopts the strong side's dtype; otherwise widest wins,
    floats beat ints."""
    da, db = a.dtype, b.dtype
    if da is None or db is None:
        return None
    if da == db:
        return da
    if a.weak and not b.weak:
        if da in _INT_DTYPES and db in _FLOAT_DTYPES + _INT_DTYPES:
            return db
        if da in _FLOAT_DTYPES and db in _FLOAT_DTYPES:
            return db
    if b.weak and not a.weak:
        if db in _INT_DTYPES and da in _FLOAT_DTYPES + _INT_DTYPES:
            return da
        if db in _FLOAT_DTYPES and da in _FLOAT_DTYPES:
            return da
    for f in ("float64", "float32", "bfloat16", "float16"):
        if f in (da, db):
            return f
    order = list(_INT_DTYPES)
    if da in order and db in order:
        return max(da, db, key=order.index)
    return None


# -- event sink -------------------------------------------------------------

class EventSink:
    """Rule modules subclass this; every hook default is a no-op. The
    interpreter calls hooks with enough context for a finding message
    (entry name threading is the caller's business). ``path`` is the
    repo-relative file the event's ``line`` belongs to — under the
    interprocedural walk that is the CALLEE's module, not the
    entry's."""

    def binop_conflict(self, path: str, line: int, op: str, a: AbsVal,
                       b: AbsVal, conflict) -> None:
        pass

    def rank_mismatch(self, path: str, line: int, what: str, a: AbsVal,
                      b: AbsVal) -> None:
        pass

    def matmul_conflict(self, path: str, line: int, a: AbsVal,
                        b: AbsVal) -> None:
        pass

    def reshape_mismatch(self, path: str, line: int, src: AbsVal,
                         want: Tuple) -> None:
        pass

    def reduction(self, path: str, line: int, fn: str, operand: AbsVal,
                  extent, has_dtype: bool,
                  dtype: Optional[str] = None) -> None:
        """``dtype`` is the accumulator dtype an explicit ``dtype=``
        names (None when the call names none)."""

    def weak_wrap(self, path: str, line: int, op: str, arr: AbsVal,
                  value) -> None:
        pass

    def shape_branch(self, path: str, line: int, kind: str,
                     origin: str) -> None:
        pass

    def shape_position(self, path: str, line: int, fn: str,
                       val: AbsVal) -> None:
        pass

    # -- v4 device-residency events (devicedataflow.py) ----------------

    def host_sync(self, path: str, line: int, how: str, val: AbsVal,
                  in_loop: bool, branch_depth: int = 0) -> None:
        """A device-resident value was coerced to host, or the host
        waited on the card: ``np.asarray`` / ``.cpu()`` / ``.numpy()``
        / a blocking ``copy_`` into a host tensor / ``float()`` /
        ``int()`` / ``bool()`` / ``.item()`` / ``.tolist()`` /
        truthiness branching / ``torch.cuda.synchronize`` /
        ``Event.synchronize`` / an op whose output size is data
        dependent (``nonzero``, a boolean-mask index,
        ``masked_select``, ``unique``, ``repeat_interleave`` without
        ``output_size``). ``how`` names the coercion."""

    def h2d(self, path: str, line: int, how: str, val: AbsVal,
            in_loop: bool, staged: bool,
            branch_depth: int = 0) -> None:
        """Host data crossed to device (``torch.as_tensor(...,
        device=)`` / ``torch.tensor(..., device=)`` / ``.to(dev)`` /
        ``.cuda()`` of a host value, or a device tensor's ``copy_``
        from one). ``staged`` marks the double-buffer idiom: the
        transferred value is stored into instance state (an
        attribute/container) for a LATER iteration rather than
        consumed by this one."""

    def device_dispatch(self, path: str, line: int, label: str,
                        arg_chains: Tuple[Tuple[str, ...], ...],
                        out_chain: Tuple[str, ...], in_loop: bool,
                        branch_depth: int = 0) -> None:
        """A device dispatch was issued (a kernel wrapper or device
        step call, or a staged-step/memo-serve attribute call the
        resolver cannot see through). ``arg_chains`` are the residency chains of its
        device arguments; ``out_chain`` the chain stamped on its
        result."""


# -- comment-shape seeding --------------------------------------------------

#: ``# [S, K] int32``, ``# [B, L] uint8/int32 …``, ``# scalar int32``,
#: ``# [NB] int32 — …``
_SHAPE_COMMENT = re.compile(
    r"#\s*(?:(scalar)|\[(?P<dims>[^\]]*)\])\s*(?P<dtype>[A-Za-z0-9_/]+)?")


def _parse_dim(tok: str) -> Dim:
    tok = tok.strip()
    if not tok:
        return None
    if tok.isdigit():
        return int(tok)
    if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*(/[A-Za-z0-9_]+)?", tok):
        return Sym(tok)
    return None


def _parse_dtype(tok: Optional[str]) -> Optional[str]:
    if not tok:
        return None
    first = tok.split("/")[0].lower()
    return first if first in _DTYPES else None


def param_shapes(mi: ModuleInfo, fn: ast.AST) -> Dict[str, AbsVal]:
    """Seed abstract values for a function's parameters from the
    kernel-comment convention (``name,   # [S, K] int32``). Parameters
    with no comment seed as unknown arrays only when the function
    looks like a kernel (the caller decides); here they seed ⊤-array.
    """
    out: Dict[str, AbsVal] = {}
    args = getattr(fn, "args", None)
    if args is None:
        return out
    lines = mi.sf.lines
    for arg in list(args.args) + list(args.kwonlyargs):
        val = AbsVal.array(None, None, origin=f"param `{arg.arg}`")
        line = lines[arg.lineno - 1] if arg.lineno - 1 < len(lines) else ""
        m = _SHAPE_COMMENT.search(line)
        if m is not None:
            if m.group(1):  # scalar
                shape: Optional[Tuple] = ()
            else:
                dims = m.group("dims")
                shape = tuple(_parse_dim(t) for t in dims.split(",")) \
                    if dims.strip() else ()
            val = AbsVal.array(shape, _parse_dtype(m.group("dtype")),
                               origin=f"param `{arg.arg}`")
        out[arg.arg] = val
    return out


# -- the interpreter --------------------------------------------------------

#: reductions whose accumulator dtype follows the operand (overflow
#: surface when the operand is a narrow int)
_REDUCTIONS = {"sum", "cumsum", "prod", "cumprod", "dot", "matmul",
               "einsum", "mean", "trace"}

#: np dtype-constructor names usable as casts (np.uint32(x))
_DTYPE_CASTS = {d: d for d in _DTYPES}

#: torch's dtype aliases (``torch.long`` is int64, ``torch.int`` int32)
#: and its tensor cast methods (``x.long()``)
_TORCH_DTYPE_ALIASES = {"long": "int64", "int": "int32",
                        "short": "int16", "float": "float32",
                        "double": "float64", "half": "float16",
                        "byte": "uint8", "char": "int8", "bool": "bool"}

#: torch ops whose output SIZE depends on the data: the host must read
#: the device's count before it can allocate the result — a hidden sync
_SIZE_SYNC_OPS = frozenset({"nonzero", "argwhere", "masked_select",
                            "unique", "unique_consecutive",
                            "repeat_interleave"})

#: tensor metadata methods: host values, no device traffic
_META_METHODS = frozenset({"data_ptr", "element_size", "stride",
                           "is_contiguous", "storage_offset",
                           "get_device", "is_pinned", "nelement"})

#: torch constructors a ``device=`` places on the card
_TORCH_CTORS = frozenset({"zeros", "ones", "empty", "full", "arange",
                          "zeros_like", "ones_like", "empty_like",
                          "full_like", "eye", "linspace", "rand",
                          "randn", "randint", "randperm",
                          "empty_strided"})

#: call argument positions that are SHAPE positions (static under a
#: compiled graph)
_SHAPE_ARG_FNS = {
    "zeros": 0, "ones": 0, "full": 0, "empty": 0, "arange": 0,
    "broadcast_to": 1, "reshape": 1, "one_hot": 1, "iota": 1,
    "tile": 1, "repeat": 1,
}

_MAX_DEPTH = 4      # interprocedural call depth bound
_MAX_LOOP = 2       # loop body passes before widening


class Interp:
    """Forward abstract interpreter over one function (and, depth-
    bounded, its resolvable callees).

    Subclasses may set :attr:`state_cls` to a ``_State`` subclass —
    the v4 device-dataflow family plugs its residency-aware state in
    this way rather than duplicating the interpreter. ``loop_depth``
    / ``branch_depth`` / ``staged_assign`` live on the Interp (not
    the per-function state) so the context survives interprocedural
    steps: a sync inside a callee reached from a caller's loop still
    reports ``in_loop``."""

    #: _State subclass run_function constructs (None → _State)
    state_cls = None

    def __init__(self, project: Project, sink: EventSink,
                 max_depth: int = _MAX_DEPTH):
        self.project = project
        self.sink = sink
        self.max_depth = max_depth
        #: (id(fn)) currently on the call stack — cycle breaker
        self._active: set = set()
        #: nesting depth of Python loops on the current walk path
        self.loop_depth = 0
        #: nesting depth of joined branches (if/try arms) — events at
        #: depth 0 are straight-line and safely ordered
        self.branch_depth = 0
        #: True while evaluating the RHS of an attribute/container
        #: store (the double-buffer staging idiom)
        self.staged_assign = False
        #: id(expr) → value already evaluated by a handler that looked
        #: at it before delegating (``_State._pre_eval``)
        self.pre: Dict[int, AbsVal] = {}

    # -- entry ---------------------------------------------------------

    def run_function(self, mi: ModuleInfo, fn: ast.AST,
                     env: Optional[Dict[str, AbsVal]] = None,
                     depth: int = 0) -> AbsVal:
        """Interpret ``fn``'s body under ``env`` (parameter bindings +
        visible closure values); returns the join of its returns."""
        if id(fn) in self._active or depth > self.max_depth:
            return AbsVal.top()
        self._active.add(id(fn))
        try:
            st = (self.state_cls or _State)(self, mi, dict(env or {}),
                                            depth)
            st.local_imports = _local_imports(fn)
            args = getattr(fn, "args", None)
            st.params = {a.arg for a in (args.args + args.kwonlyargs)} \
                if args is not None else set()
            body = fn.body if isinstance(
                fn, (ast.FunctionDef, ast.AsyncFunctionDef)) else [
                    ast.Return(value=fn.body)]
            if isinstance(fn, ast.Lambda):
                body = [ast.Return(value=fn.body)]
            st.exec_block(body)
            ret = st.ret
            return ret if ret is not None else AbsVal.const_(None)
        finally:
            self._active.discard(id(fn))


class _State:
    """Mutable interpretation state for one function body."""

    def __init__(self, interp: Interp, mi: ModuleInfo,
                 env: Dict[str, AbsVal], depth: int):
        self.interp = interp
        self.mi = mi
        self.env = env
        self.depth = depth
        self.ret: Optional[AbsVal] = None
        #: ``from mod import fn`` inside the function body (the lazy
        #: imports of the device paths) → ``mod.fn``
        self.local_imports: Dict[str, str] = {}
        #: the function's parameter names
        self.params: set = set()

    @property
    def sink(self) -> EventSink:
        return self.interp.sink

    # -- statements ----------------------------------------------------

    def exec_block(self, body: Sequence[ast.stmt]) -> None:
        for node in body:
            self.exec_stmt(node)

    def exec_stmt(self, node: ast.stmt) -> None:
        if isinstance(node, ast.Assign):
            staged = any(isinstance(t, (ast.Attribute, ast.Subscript))
                         for t in node.targets)
            if staged:
                prev = self.interp.staged_assign
                self.interp.staged_assign = True
                try:
                    val = self.eval(node.value)
                finally:
                    self.interp.staged_assign = prev
            else:
                val = self.eval(node.value)
            for tgt in node.targets:
                self.bind(tgt, val)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self.bind(node.target, self.eval(node.value))
        elif isinstance(node, ast.AugAssign):
            cur = self.eval(node.target)
            val = self._binop(node, cur, self.eval(node.value),
                              type(node.op).__name__)
            self.bind(node.target, val)
        elif isinstance(node, ast.Return):
            val = self.eval(node.value) if node.value is not None \
                else AbsVal.const_(None)
            self.ret = val if self.ret is None else join(self.ret, val)
        elif isinstance(node, ast.If):
            arm = self._cuda_arm(node.test)
            if arm is not None:
                # `if t.is_cuda:` over a device-resident t: the card's
                # arm is the one that runs (the plain arm takes CPU
                # tensors)
                self.exec_block(node.body if arm else node.orelse)
                return
            self._branch_event(node)
            self._exec_branches([node.body, node.orelse])
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            it = self.eval(node.iter)
            self._exec_loop(node.body, node.target, _element_of(it))
            self.exec_block(node.orelse)
        elif isinstance(node, ast.While):
            self._branch_event(node)
            self._exec_loop(node.body, None, None)
            self.exec_block(node.orelse)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, AbsVal.host())
            self.exec_block(node.body)
        elif isinstance(node, ast.Try):
            self._exec_branches([node.body])
            for h in node.handlers:
                if h.name:
                    self.env[h.name] = AbsVal.host()
                self._exec_branches([h.body])
            self.exec_block(node.orelse)
            self.exec_block(node.finalbody)
        elif isinstance(node, ast.Expr):
            self.eval(node.value)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def is a host value; callees resolve through
            # all_functions when invoked by name
            self.env[node.name] = AbsVal.host(origin=f"def {node.name}")
        elif isinstance(node, (ast.Assert, ast.Raise, ast.Pass,
                               ast.Break, ast.Continue, ast.Global,
                               ast.Nonlocal, ast.Import,
                               ast.ImportFrom, ast.Delete,
                               ast.ClassDef)):
            pass
        # anything else: ignore (miss, don't invent)

    def _cuda_arm(self, test: ast.expr) -> Optional[bool]:
        """True/False when ``test`` is ``t.is_cuda`` or
        ``isinstance(t, torch.Tensor)`` (or its ``not``) of a
        device-resident ``t`` — a device value is a CUDA tensor; else
        None."""
        neg = isinstance(test, ast.UnaryOp) and isinstance(test.op,
                                                           ast.Not)
        t = test.operand if neg else test
        if isinstance(t, ast.Attribute) and t.attr == "is_cuda":
            subject = t.value
        elif isinstance(t, ast.Call) and isinstance(t.func, ast.Name) \
                and t.func.id == "isinstance" and len(t.args) == 2 \
                and self.mi.qualify(t.args[1]) == "torch.Tensor":
            subject = t.args[0]
        else:
            return None
        return (not neg) if self.eval(subject).device else None

    def _exec_branches(self, blocks: Sequence[Sequence[ast.stmt]]) -> None:
        """Run each block against a copy of the env; join results."""
        base = dict(self.env)
        merged: Optional[Dict[str, AbsVal]] = None
        ret = self.ret
        self.interp.branch_depth += 1
        try:
            for block in blocks:
                self.env = dict(base)
                self.ret = ret
                self.exec_block(block)
                if merged is None:
                    merged = self.env
                else:
                    merged = _join_envs(merged, self.env)
                ret = self.ret
        finally:
            self.interp.branch_depth -= 1
        self.env = merged if merged is not None else base
        self.ret = ret

    def _exec_loop(self, body, target,
                   elem: Optional[AbsVal]) -> None:
        self.interp.loop_depth += 1
        try:
            self._exec_loop_passes(body, target, elem)
        finally:
            self.interp.loop_depth -= 1

    def _exec_loop_passes(self, body, target,
                          elem: Optional[AbsVal]) -> None:
        for i in range(_MAX_LOOP):
            before = dict(self.env)
            if target is not None:
                self.bind(target, elem or AbsVal.top())
            self.exec_block(body)
            after = self.env
            nxt = {}
            changed = False
            for k in set(before) | set(after):
                b, a = before.get(k), after.get(k)
                if b is None or a is None:
                    nxt[k] = a or b
                    changed = changed or b is None
                    continue
                w = widen(b, a) if i == _MAX_LOOP - 1 else join(b, a)
                nxt[k] = w
                if w.kind != b.kind or w.shape != b.shape \
                        or w.const != b.const:
                    changed = True
            self.env = nxt
            if not changed:
                break

    def _branch_event(self, node) -> None:
        """Report shape-derived / config-derived Python branching."""
        test = getattr(node, "test", None)
        if test is not None:
            try:
                tv = self.eval(test)
            except RecursionError:  # pragma: no cover
                return
            if tv.device:
                # branching on a device value blocks on its readback —
                # the truthiness face of an implicit host sync (and
                # where a len()/shape compare of device data lands)
                self.sink.host_sync(
                    self.mi.sf.path, node.lineno, "truthiness", tv,
                    self.interp.loop_depth > 0,
                    self.interp.branch_depth)
        body = getattr(node, "body", None)
        if isinstance(body, list) and body \
                and all(isinstance(s, (ast.Raise, ast.Assert))
                        for s in body) and not getattr(node, "orelse",
                                                       None):
            return  # a shape guard that only raises is trace-time
            # validation, not cache-key churn
        test = node.test
        for sub in ast.walk(test):
            if isinstance(sub, (ast.Name, ast.Attribute)):
                try:
                    v = self.eval(sub)
                except RecursionError:  # pragma: no cover
                    return
                if v.kind == "const" and v.from_shape:
                    self.sink.shape_branch(self.mi.sf.path, node.lineno, "shape",
                                           v.origin or _src_of(sub))
                    return

    # -- binding -------------------------------------------------------

    def bind(self, target: ast.expr, val: AbsVal) -> None:
        if isinstance(target, ast.Name):
            if not val.origin:
                val = _with_origin(val, f"`{target.id}`")
            self.env[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            items = None
            if val.kind == "tuple" and len(val.items) == len(target.elts):
                items = val.items
            elif val.kind == "array" and val.shape is not None \
                    and len(val.shape):
                # unpacking an array's leading axis / a .shape tuple
                items = [_dim_val(d, val) for d in val.shape] \
                    if len(val.shape) == len(target.elts) else None
            # unpacking an UNKNOWN-rank .shape: the dims are unknown
            # consts but still shape-derived — branching on them is
            # still one-compile-per-shape
            fallback = AbsVal("const", const=None, from_shape=True,
                              origin=val.origin) \
                if val.kind == "const" and val.from_shape \
                else AbsVal.top()
            if items is None and val.kind == "array" and val.device:
                # unpacking a device container: the parts are still
                # device-resident even when we can't count them
                fallback = AbsVal.array(None, None, origin=val.origin,
                                        device=True,
                                        dev_chain=val.dev_chain)
            for i, elt in enumerate(target.elts):
                if isinstance(elt, ast.Starred):
                    self.bind(elt.value, AbsVal.host())
                    continue
                self.bind(elt, items[i] if items else fallback)
        elif isinstance(target, (ast.Attribute, ast.Subscript)):
            self.eval(target.value)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, AbsVal.host())

    # -- expressions ---------------------------------------------------

    def eval(self, node: ast.expr) -> AbsVal:
        pre = self.interp.pre
        if pre and id(node) in pre:
            return pre.pop(id(node))
        try:
            return self._eval(node)
        except RecursionError:  # pragma: no cover - pathological input
            return AbsVal.top()

    def _pre_eval(self, node: ast.expr) -> AbsVal:
        """Evaluate ``node`` now and hand the same value to the next
        ``eval`` of it, so a handler that inspects an argument before
        delegating does not report its events twice."""
        v = self.eval(node)
        self.interp.pre[id(node)] = v
        return v

    def _eval(self, node: ast.expr) -> AbsVal:
        if isinstance(node, ast.Constant):
            return AbsVal.const_(node.value)
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            return self._free_name(node)
        if isinstance(node, (ast.Tuple, ast.List)):
            return AbsVal.tuple_([self.eval(e) for e in node.elts])
        if isinstance(node, ast.Attribute):
            return self._attribute(node)
        if isinstance(node, ast.Subscript):
            return self._subscript(node)
        if isinstance(node, ast.BinOp):
            a = self.eval(node.left)
            b = self.eval(node.right)
            return self._binop(node, a, b, type(node.op).__name__)
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand)
            if v.kind == "const" and isinstance(v.const, (int, float)) \
                    and isinstance(node.op, ast.USub):
                return AbsVal.const_(-v.const, from_shape=v.from_shape,
                                     origin=v.origin)
            return v
        if isinstance(node, ast.Compare) and all(
                isinstance(o, (ast.In, ast.NotIn)) for o in node.ops):
            # a membership test: a key in a step's output dict (the
            # lattice cannot tell that dict from a tensor) — read as a
            # host test unless a tensor is looked up in a tensor
            a = self.eval(node.left)
            dev = [b for b in map(self.eval, node.comparators)
                   if b.device and a.is_array]
            if dev:
                return AbsVal.array((), "bool", origin=a.origin,
                                    device=True,
                                    dev_chain=dev[0].dev_chain)
            return AbsVal("const", const=None)
        if isinstance(node, ast.Compare):
            a = self.eval(node.left)
            if all(isinstance(o, (ast.Is, ast.IsNot))
                   for o in node.ops):
                # identity tests never touch array contents — no
                # residency, no sync
                for cmp in node.comparators:
                    self.eval(cmp)
                return AbsVal("const", const=None)
            out = a
            for cmp in node.comparators:
                b = self.eval(cmp)
                out = self._binop(node, out, b, "Compare")
            if out.kind == "array":
                return AbsVal.array(out.shape, "bool", origin=out.origin,
                                    device=out.device,
                                    dev_chain=out.dev_chain)
            return AbsVal("const", const=None,
                          from_shape=a.from_shape or out.from_shape)
        if isinstance(node, ast.BoolOp):
            vals = [self.eval(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = join(out, v)
            return out
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.IfExp):
            self._branch_event(node)
            return join(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            # a comprehension IS a loop: its body runs per element, so
            # a sync/transfer inside it is per-iteration, and its
            # target carries the iterated value's residency (the
            # `{k: np.asarray(v) for k, v in out.items()}` per-lane
            # readback idiom)
            for gen in node.generators:
                it = self.eval(gen.iter)
                self.bind(gen.target, _element_of(it))
            self.interp.loop_depth += 1
            try:
                for gen in node.generators:
                    for cond in gen.ifs:
                        cv = self.eval(cond)
                        if cv.device:
                            self.sink.host_sync(
                                self.mi.sf.path, cond.lineno,
                                "truthiness", cv, True,
                                self.interp.branch_depth)
                if isinstance(node, ast.DictComp):
                    self.eval(node.key)
                    body = self.eval(node.value)
                else:
                    body = self.eval(node.elt)
            finally:
                self.interp.loop_depth -= 1
            if body.device:
                # a container of device values stays device-resident
                return AbsVal.array(None, None, origin="comprehension",
                                    device=True,
                                    dev_chain=body.dev_chain)
            return AbsVal.host()
        if isinstance(node, ast.Lambda):
            return AbsVal.host(origin="<lambda>")
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            return AbsVal.const_(None)
        if isinstance(node, ast.Dict):
            for v in node.values:
                if v is not None:
                    self.eval(v)
            return AbsVal.host()
        return AbsVal.top()

    # -- name / attribute resolution -----------------------------------

    def _free_name(self, node: ast.Name) -> AbsVal:
        name = node.id
        mi = self.mi
        if name in mi.constants:
            c = mi.constants[name]
            if isinstance(c, ast.Constant):
                return AbsVal.const_(c.value,
                                     origin=f"module const `{name}`")
            return AbsVal.host(origin=f"module global `{name}`")
        if name in mi.imports:
            return AbsVal.host(origin=f"import `{name}`")
        if name in mi.functions or name in mi.all_functions:
            return AbsVal.host(origin=f"def {name}")
        if name in ("True", "False", "None"):  # pragma: no cover
            return AbsVal.const_({"True": True, "False": False,
                                  "None": None}[name])
        if name in ("range", "len", "min", "max", "int", "float",
                    "enumerate", "zip", "sorted", "list", "tuple",
                    "abs", "bool", "str"):
            return AbsVal.host(origin=f"builtin `{name}`")
        return AbsVal.top(origin=f"free `{name}`")

    def _attribute(self, node: ast.Attribute) -> AbsVal:
        base = self.eval(node.value)
        attr = node.attr
        if base.is_array:
            if attr == "shape":
                if base.shape is None:
                    return AbsVal("const", const=None, from_shape=True,
                                  origin=f"{base.origin}.shape")
                return AbsVal.tuple_(
                    [_dim_val(d, base) for d in base.shape],
                    origin=f"{base.origin}.shape")
            if attr == "ndim":
                return AbsVal.const_(base.rank, from_shape=True,
                                     origin=f"{base.origin}.ndim")
            if attr == "size":
                return AbsVal("const", const=_shape_size(base.shape),
                              from_shape=True,
                              origin=f"{base.origin}.size")
            if attr == "T":
                shape = None if base.shape is None \
                    else tuple(reversed(base.shape))
                return AbsVal.array(shape, base.dtype, origin=base.origin,
                                    device=base.device,
                                    dev_chain=base.dev_chain)
            if attr == "dtype":
                return AbsVal.const_(base.dtype)
            if attr == "device":
                return AbsVal("devref", origin=f"{base.origin}.device",
                              device=base.device,
                              dev_chain=base.dev_chain)
            if attr in ("is_cuda", "layout", "requires_grad"):
                # metadata: reading where a tensor lies never waits
                # on the card
                return AbsVal.host(origin=f"{base.origin}.{attr}")
            # bound array method (astype/reshape/sum/…): handled at
            # the Call site via _method_call
            return AbsVal.host(origin=f"{base.origin}.{attr}")
        if base.kind == "tuple" and attr == "shape":
            return AbsVal.host()
        if base.kind == "top" and attr == "device":
            # the device of an unknown value: not provably the card
            return AbsVal("devref", origin=f"{base.origin}.device")
        q = self.mi.qualify(node)
        if q is not None:
            leaf = q.rsplit(".", 1)[-1]
            if leaf in _DTYPE_CASTS and _is_np_root(q):
                return AbsVal.const_(("dtype", leaf))
            if _is_torch_root(q) and (leaf in _DTYPES
                                      or leaf in _TORCH_DTYPE_ALIASES):
                return AbsVal.const_(
                    ("dtype", _TORCH_DTYPE_ALIASES.get(leaf, leaf)))
        return AbsVal.host(origin=_src_of(node))

    # -- subscripts ----------------------------------------------------

    def _subscript(self, node: ast.Subscript) -> AbsVal:
        base = self.eval(node.value)
        if base.is_array and not isinstance(node.slice, (ast.Slice,
                                                         ast.Tuple)):
            iv = self._pre_eval(node.slice)
            if iv.is_array and iv.dtype == "bool" \
                    and (iv.device or base.device):
                # x[mask]: the result's length is the mask's count
                self.sink.host_sync(
                    self.mi.sf.path, node.lineno, "boolean-mask index",
                    iv if iv.device else base,
                    self.interp.loop_depth > 0,
                    self.interp.branch_depth)
        out = self._subscript_with(node, base)
        self.interp.pre.pop(id(node.slice), None)
        if base.device and out.is_array and not out.device:
            # lazy device slicing: the piece stays on device
            out = AbsVal.array(out.shape, out.dtype, weak=out.weak,
                               origin=out.origin, device=True,
                               dev_chain=base.dev_chain)
        return out

    def _subscript_with(self, node: ast.Subscript,
                        base: AbsVal) -> AbsVal:
        idx = node.slice
        if base.kind == "tuple":
            iv = self.eval(idx)
            if iv.kind == "const" and isinstance(iv.const, int):
                i = iv.const
                if -len(base.items) <= i < len(base.items):
                    return base.items[i]
            if isinstance(idx, ast.Slice):
                lo = _const_int(self.eval(idx.lower)) if idx.lower else 0
                hi = _const_int(self.eval(idx.upper)) if idx.upper \
                    else len(base.items)
                if lo is not None and hi is not None:
                    return AbsVal.tuple_(base.items[lo:hi])
            return AbsVal.top()
        if not base.is_array:
            return AbsVal.top()
        if base.shape is None:
            return AbsVal.array(None, base.dtype, origin=base.origin)
        parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
        out: List[Dim] = []
        consumed = 0
        adv: List[AbsVal] = []
        ok = True
        for p in parts:
            if isinstance(p, ast.Slice):
                if consumed < len(base.shape):
                    full = p.lower is None and p.upper is None \
                        and p.step is None
                    out.append(base.shape[consumed] if full
                               else _slice_extent(self, p,
                                                  base.shape[consumed]))
                    consumed += 1
                else:
                    ok = False
            elif isinstance(p, ast.Constant) and p.value is None:
                out.append(1)
            elif isinstance(p, ast.Constant) and p.value is Ellipsis:
                ok = False
            else:
                v = self.eval(p)
                if v.kind == "const" and isinstance(v.const, int):
                    consumed += 1          # integer index drops the dim
                elif v.is_array:
                    adv.append(v)
                    consumed += 1
                else:
                    consumed += 1
                    ok = False
        if not ok:
            return AbsVal.array(None, base.dtype, origin=base.origin)
        rest = list(base.shape[consumed:])
        if adv:
            # advanced indexing: index arrays broadcast; their common
            # shape replaces the consumed axes (approximate: single
            # index-array case exact, multi-array joined)
            ishape: Optional[Tuple] = adv[0].shape
            for v in adv[1:]:
                ishape, conflict = broadcast_shapes(ishape, v.shape)
            pre = list(ishape) if ishape is not None else [None]
            return AbsVal.array(tuple(pre + rest) if ishape is not None
                                else None,
                                base.dtype, origin=base.origin)
        return AbsVal.array(tuple(out + rest), base.dtype,
                            origin=base.origin)

    # -- operators -----------------------------------------------------

    def _binop(self, node, a: AbsVal, b: AbsVal, op: str) -> AbsVal:
        line = getattr(node, "lineno", 0)
        if op == "MatMult":
            return self._matmul(line, a, b)
        # const folding (host arithmetic, shape math)
        if a.kind == "const" and b.kind == "const" \
                and isinstance(a.const, (int, float)) \
                and isinstance(b.const, (int, float)):
            folded = _fold(op, a.const, b.const)
            return AbsVal("const", const=folded,
                          from_shape=a.from_shape or b.from_shape,
                          origin=a.origin or b.origin)
        if a.kind == "const" and b.kind == "const":
            return AbsVal("const", const=None,
                          from_shape=a.from_shape or b.from_shape)
        # array ⊗ array
        if a.is_array and b.is_array:
            shape, conflict = broadcast_shapes(a.shape, b.shape)
            if conflict is not None:
                self.sink.binop_conflict(self.mi.sf.path, line, op, a, b, conflict)
            dtype = promote(a, b)
            return AbsVal.array(shape, dtype,
                                weak=a.weak and b.weak,
                                origin=a.origin or b.origin,
                                device=a.device or b.device,
                                dev_chain=a.dev_chain or b.dev_chain)
        # array ⊗ const scalar: weak promotion — the const must fit
        arr, const = (a, b) if a.is_array else \
            (b, a) if b.is_array else (None, None)
        if arr is not None and const.kind == "const":
            if isinstance(const.const, int) and arr.dtype in _INT_RANGE \
                    and op in ("Add", "Sub", "Mult", "BitOr", "BitAnd",
                               "BitXor", "Mod", "FloorDiv"):
                lo, hi = _INT_RANGE[arr.dtype]
                if not (lo <= const.const <= hi):
                    self.sink.weak_wrap(self.mi.sf.path, line, op, arr, const.const)
            dtype = arr.dtype
            if isinstance(const.const, float) \
                    and arr.dtype in _INT_DTYPES:
                dtype = "float32"
            return AbsVal.array(arr.shape, dtype, weak=arr.weak,
                                origin=arr.origin, device=arr.device,
                                dev_chain=arr.dev_chain)
        if arr is not None:
            return AbsVal.array(arr.shape, arr.dtype, origin=arr.origin,
                                device=arr.device,
                                dev_chain=arr.dev_chain)
        return AbsVal.top()

    def _matmul(self, line: int, a: AbsVal, b: AbsVal) -> AbsVal:
        if not (a.is_array and b.is_array):
            return AbsVal.top()
        if a.shape is None or b.shape is None or len(a.shape) < 1 \
                or len(b.shape) < 1:
            return AbsVal.array(None, promote(a, b))
        ka = a.shape[-1]
        kb = b.shape[-2] if len(b.shape) >= 2 else b.shape[-1]
        if _dim_conflict(ka, kb):
            self.sink.matmul_conflict(self.mi.sf.path, line, a, b)
        if len(a.shape) >= 2 and len(b.shape) >= 2:
            batch, _ = broadcast_shapes(a.shape[:-2], b.shape[:-2])
            shape = None if batch is None else \
                tuple(batch) + (a.shape[-2], b.shape[-1])
        else:
            shape = None
        return AbsVal.array(shape, promote(a, b), origin=a.origin,
                            device=a.device or b.device,
                            dev_chain=a.dev_chain or b.dev_chain)

    # -- calls ---------------------------------------------------------

    def _call(self, node: ast.Call) -> AbsVal:
        fn = node.func
        # bound array method: x.astype(...), x.reshape(...), x.sum(...)
        if isinstance(fn, ast.Attribute):
            base = self.eval(fn.value)
            if base.is_array:
                return self._method_call(node, base, fn.attr)
        q = self.mi.qualify(fn) or ""
        leaf = q.rsplit(".", 1)[-1]
        args = node.args
        # the host waits on the card: the whole stream, or one event's
        # (or stream's) work
        if q == "torch.cuda.synchronize" or (
                isinstance(fn, ast.Attribute)
                and fn.attr == "synchronize"):
            how = "torch.cuda.synchronize" \
                if q == "torch.cuda.synchronize" else "Event.synchronize"
            self.sink.host_sync(
                self.mi.sf.path, node.lineno, how,
                AbsVal.array(None, None, origin="the card's queued work",
                             device=True,
                             dev_chain=(f"{self.mi.sf.path}:"
                                        f"{node.lineno} {how}",)),
                self.interp.loop_depth > 0, self.interp.branch_depth)
            return AbsVal.const_(None)
        # shape-position event (static under a compiled graph)
        if leaf in _SHAPE_ARG_FNS and (_is_np_root(q)
                                       or _is_torch_root(q)):
            pos = _SHAPE_ARG_FNS[leaf]
            if pos < len(args):
                v = self.eval(args[pos])
                self.sink.shape_position(self.mi.sf.path, node.lineno, leaf, v)
        if _is_np_root(q):
            return self._numpy_call(node, leaf, q)
        if _is_torch_root(q):
            return self._torch_call(node, leaf)
        if leaf == "one_hot" and "nn" in q.split("."):
            x = self.eval(args[0]) if args else AbsVal.top()
            n = _const_int(self.eval(args[1])) if len(args) > 1 else None
            shape = None if x.shape is None else tuple(x.shape) + (n,)
            return AbsVal.array(shape, "int64", origin=x.origin,
                                device=x.device, dev_chain=x.dev_chain)
        if leaf in _DTYPE_CASTS and _is_np_root(q):
            v = self.eval(args[0]) if args else AbsVal.top()
            if v.is_array:
                return AbsVal.array(v.shape, leaf, origin=v.origin)
            return AbsVal.array((), leaf)
        if leaf in ("len",) and q == "len" and args:
            v = self.eval(args[0])
            if v.kind == "tuple":
                return AbsVal.const_(len(v.items))
            if v.is_array and v.shape is not None and v.shape:
                return AbsVal("const",
                              const=v.shape[0] if isinstance(
                                  v.shape[0], int) else None,
                              from_shape=True, origin=v.origin)
            return AbsVal("const", const=None)
        if q in ("list", "tuple", "sorted", "reversed") and args:
            # a container of device values stays device-resident
            v = self.eval(args[0])
            for extra in args[1:]:
                self.eval(extra)
            if v.device or _any_device(v):
                return AbsVal.array(None, None, origin=v.origin,
                                    device=True, dev_chain=_first_chain(v))
            return AbsVal.host(origin=v.origin)
        if q in ("int", "float", "bool", "abs", "min", "max") and args:
            v = self.eval(args[0])
            if v.device and q in ("int", "float", "bool"):
                # scalar coercion of a device value blocks the host on
                # the readback — the canonical implicit sync
                self.sink.host_sync(self.mi.sf.path, node.lineno,
                                    f"{q}()", v,
                                    self.interp.loop_depth > 0,
                                    self.interp.branch_depth)
            if v.kind == "const":
                return AbsVal("const", const=None,
                              from_shape=v.from_shape, origin=v.origin)
            return AbsVal("const", const=None,
                          from_shape=getattr(v, "from_shape", False))
        # project-resolvable call → interprocedural step
        for kw in node.keywords:
            if kw.value is not None:
                self.eval(kw.value)
        argvals = [self.eval(a) for a in args]
        return self._project_call(node, q, argvals)

    def _pre_eval_args(self, node: ast.Call) -> List[AbsVal]:
        """Every argument and keyword value, evaluated once (the
        handlers below delegate to impls that evaluate some of them
        again; those get the same value, and its events once)."""
        vals = [self._pre_eval(a) for a in node.args]
        vals += [self._pre_eval(kw.value) for kw in node.keywords
                 if kw.value is not None]
        return vals

    def _drop_pre(self, node: ast.Call) -> None:
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if a is not None:
                self.interp.pre.pop(id(a), None)

    def _nonblocking(self, node: ast.Call) -> bool:
        return any(kw.arg == "non_blocking" and isinstance(
            kw.value, ast.Constant) and kw.value.value is True
            for kw in node.keywords)

    def _on_card(self, expr: ast.expr) -> bool:
        """Is a device expression the card? The literal ``"cpu"`` (or
        None) is not, a tensor's ``.device`` is where that tensor lies,
        and any other expression (``"cuda"``, ``dev``, ``self.device``)
        is — torch's meaning of ``device=``."""
        if isinstance(expr, ast.Constant):
            return not (expr.value is None
                        or str(expr.value).split(":")[0] == "cpu")
        v = self.interp.pre.get(id(expr)) or self.eval(expr)
        return v.device if v.kind == "devref" else True

    def _transfer_target(self, node: ast.Call) -> Optional[str]:
        """What ``x.to(...)`` moves to: ``"cpu"``, ``"device"`` (the
        card), or None for a pure dtype cast."""
        cands = [kw.value for kw in node.keywords if kw.arg == "device"]
        cands += [a for a in node.args
                  if self._dtype_of_expr(a) is None]
        for c in cands:
            return "device" if self._on_card(c) else "cpu"
        return None

    def _method_call(self, node: ast.Call, base: AbsVal,
                     meth: str) -> AbsVal:
        path, line = self.mi.sf.path, node.lineno
        in_loop = self.interp.loop_depth > 0
        bd = self.interp.branch_depth
        vals = self._pre_eval_args(node)
        try:
            if meth in ("item", "tolist") and base.device:
                self.sink.host_sync(path, line, f".{meth}()", base,
                                    in_loop, bd)
            if meth in ("cpu", "numpy"):
                if base.device:
                    self.sink.host_sync(path, line, f".{meth}()", base,
                                        in_loop, bd)
                return _undevice(base)
            if meth in _SIZE_SYNC_OPS and _size_syncs(
                    meth, [base] + vals, node):
                self.sink.host_sync(path, line, f".{meth}()", base,
                                    in_loop, bd)
            if meth in ("size", "dim", "numel", "nelement"):
                if meth == "dim":
                    return AbsVal.const_(base.rank, from_shape=True,
                                         origin=f"{base.origin}.dim()")
                if meth == "size" and node.args:
                    ax = _const_int(vals[0])
                    if ax is not None and base.shape is not None \
                            and -len(base.shape) <= ax < len(base.shape):
                        return _dim_val(base.shape[ax], base)
                    return AbsVal("const", const=None, from_shape=True,
                                  origin=f"{base.origin}.size()")
                if meth == "size" and base.shape is not None:
                    return AbsVal.tuple_(
                        [_dim_val(d, base) for d in base.shape],
                        origin=f"{base.origin}.size()")
                return AbsVal("const", const=None, from_shape=True,
                              origin=f"{base.origin}.{meth}()")
            if meth in _META_METHODS:
                return AbsVal.host(origin=f"{base.origin}.{meth}()")
            if meth == "to":
                target = self._transfer_target(node)
                dt = next((self._dtype_of_expr(a) for a in node.args
                           if self._dtype_of_expr(a) is not None),
                          self._dtype_kwarg(node))
                shaped = AbsVal.array(base.shape, dt or base.dtype,
                                      weak=base.weak, origin=base.origin,
                                      device=base.device,
                                      dev_chain=base.dev_chain)
                if target == "cpu":
                    if base.device and not self._nonblocking(node):
                        self.sink.host_sync(path, line, ".to('cpu')",
                                            base, in_loop, bd)
                    return _undevice(shaped)
                if target == "device":
                    return self._to_device(node, shaped, ".to(device)")
                return shaped
            if meth == "cuda":
                return self._to_device(node, base, ".cuda()")
            if meth == "copy_" and vals:
                src = vals[0]
                recv = node.func.value if isinstance(
                    node.func, ast.Attribute) else None
                if base.device and not (src.device or _any_device(src)):
                    self.sink.h2d(
                        path, line, ".copy_()", src, in_loop,
                        isinstance(recv, (ast.Attribute, ast.Subscript))
                        or self.interp.staged_assign, bd)
                elif not base.device and (src.device or _any_device(src)) \
                        and not self._nonblocking(node):
                    self.sink.host_sync(path, line, ".copy_() into host",
                                        src, in_loop, bd)
                return base
            out = self._method_call_impl(node, base, meth)
        finally:
            self._drop_pre(node)
        if base.device and out.is_array and not out.device:
            out = AbsVal.array(out.shape, out.dtype, weak=out.weak,
                               origin=out.origin, device=True,
                               dev_chain=base.dev_chain)
        return out

    def _to_device(self, node: ast.Call, v: AbsVal, how: str) -> AbsVal:
        """``v`` moved to the card: an h2d event when it was on the
        host, and its residency chain gains this site."""
        path, line = self.mi.sf.path, node.lineno
        if not (v.device or _any_device(v)):
            self.sink.h2d(path, line, how, v,
                          self.interp.loop_depth > 0,
                          self.interp.staged_assign,
                          self.interp.branch_depth)
        chain = v.dev_chain + (f"{path}:{line} {how}",)
        if v.is_array:
            return AbsVal.array(v.shape, v.dtype, weak=v.weak,
                                origin=v.origin, device=True,
                                dev_chain=chain)
        return AbsVal.array(None, None, origin=v.origin, device=True,
                            dev_chain=chain)

    def _method_call_impl(self, node: ast.Call, base: AbsVal,
                          meth: str) -> AbsVal:
        args = node.args
        if meth in _TORCH_DTYPE_ALIASES and not args:
            # x.long(), x.int(), x.float() … casts
            return AbsVal.array(base.shape, _TORCH_DTYPE_ALIASES[meth],
                                origin=base.origin)
        if meth in ("astype", "type") and args:
            dt = self._dtype_of_expr(args[0])
            return AbsVal.array(base.shape, dt, origin=base.origin)
        if meth in ("reshape", "view") and args and not (
                len(args) == 1 and self._dtype_of_expr(args[0])):
            want = args[0] if len(args) == 1 else ast.Tuple(
                elts=list(args), ctx=ast.Load())
            return self._reshape(node, base, want)
        if meth == "view":
            return AbsVal.array(None, self._dtype_of_expr(args[0])
                                if args else None, origin=base.origin)
        if meth in _REDUCTIONS:
            return self._reduce(node, meth, base)
        if meth in ("transpose", "t", "permute"):
            return AbsVal.array(None if base.shape is None
                                else tuple(reversed(base.shape))
                                if meth != "permute" else None,
                                base.dtype, origin=base.origin)
        if meth in ("min", "max", "argmax", "argmin", "any", "all"):
            dt = base.dtype if meth in ("min", "max") else (
                "bool" if meth in ("any", "all") else "int64")
            return self._axis_reduce_shape(node, base, dt)
        if meth in ("gather", "take_along_dim"):
            idx = next((self.eval(a) for a in args
                        if not isinstance(a, ast.Constant)), None)
            if idx is not None:
                self._rank_check(node, meth, base, idx)
                return AbsVal.array(idx.shape, base.dtype,
                                    origin=base.origin)
        if meth in ("item", "tolist"):
            return AbsVal("const", const=None)
        if meth in ("contiguous", "clone", "detach", "pin_memory"):
            return AbsVal.array(base.shape, base.dtype, weak=base.weak,
                                origin=base.origin)
        return AbsVal.array(None, None, origin=base.origin)

    def _rank_check(self, node: ast.Call, what: str, a: AbsVal,
                    idx: AbsVal) -> None:
        """torch's ``gather`` / ``take_along_dim`` take an index of the
        input's rank."""
        if a.rank is not None and idx.rank is not None \
                and a.rank != idx.rank:
            self.sink.rank_mismatch(self.mi.sf.path, node.lineno, what,
                                    a, idx)

    def _numpy_call(self, node: ast.Call, leaf: str,
                    q: str = "") -> AbsVal:
        """Strict numpy: host results. ``np.asarray``/``np.array`` of
        a device value is a blocking device→host readback."""
        path, line = self.mi.sf.path, node.lineno
        if leaf in ("asarray", "array") and node.args:
            v = self.eval(node.args[0])
            dt = self._dtype_kwarg(node) or v.dtype
            if v.device or _any_device(v):
                self.sink.host_sync(path, line, f"np.{leaf}", v,
                                    self.interp.loop_depth > 0,
                                    self.interp.branch_depth)
            return _coerce_array(v, dt)
        return self._numpy_call_impl(node, leaf)

    def _device_kwarg(self, node: ast.Call) -> bool:
        """A ``device=`` that names the card (:meth:`_on_card`)."""
        for kw in node.keywords:
            if kw.arg == "device":
                return self._on_card(kw.value)
        return False

    def _torch_call(self, node: ast.Call, leaf: str) -> AbsVal:
        """``torch.<op>``: shape/dtype through the shared impl, then
        torch's residency — ``device=`` places a constructor on the
        card, ``torch.as_tensor``/``torch.tensor`` of host data with a
        ``device=`` is a host→device transfer, and any other op lies
        where its tensor inputs lie."""
        path, line = self.mi.sf.path, node.lineno
        in_loop = self.interp.loop_depth > 0
        vals = self._pre_eval_args(node)
        on_card = self._device_kwarg(node)
        try:
            if leaf in ("tensor", "as_tensor", "asarray") and node.args:
                v = vals[0]
                dt = self._dtype_kwarg(node) or v.dtype
                out = _coerce_array(v, dt)
                if on_card:
                    return self._to_device(
                        node, out if not (v.device or _any_device(v))
                        else AbsVal.array(out.shape, out.dtype,
                                          origin=out.origin, device=True,
                                          dev_chain=v.dev_chain),
                        f"torch.{leaf}(device=)")
                if v.device or _any_device(v):
                    return AbsVal.array(out.shape, out.dtype,
                                        origin=out.origin, device=True,
                                        dev_chain=v.dev_chain)
                return out
            if leaf == "from_numpy":
                return _coerce_array(vals[0], vals[0].dtype) \
                    if vals else AbsVal.array(None, None)
            if leaf in _SIZE_SYNC_OPS and _size_syncs(leaf, vals, node):
                self.sink.host_sync(
                    path, line, f"torch.{leaf}",
                    next(v for v in vals if v.device), in_loop,
                    self.interp.branch_depth)
            if leaf in ("gather", "take_along_dim") \
                    and len(node.args) >= 2:
                a = vals[0]
                idx = next((v for v, e in zip(vals[1:], node.args[1:])
                            if not isinstance(e, ast.Constant)), None)
                if idx is not None:
                    self._rank_check(node, leaf, a, idx)
                out = AbsVal.array(idx.shape if idx is not None
                                   else None, a.dtype, origin=a.origin)
            else:
                out = self._numpy_call_impl(node, leaf)
        finally:
            self._drop_pre(node)
        if not out.is_array or out.device:
            return out
        if on_card and leaf in _TORCH_CTORS:
            return AbsVal.array(out.shape, out.dtype, weak=out.weak,
                                origin=out.origin, device=True,
                                dev_chain=(f"{path}:{line} "
                                           f"torch.{leaf}(device=)",))
        explicit_cpu = not on_card and any(
            kw.arg == "device" for kw in node.keywords)
        dev = next((v for v in vals if v.device or _any_device(v)), None)
        if dev is not None and not explicit_cpu:
            return AbsVal.array(out.shape, out.dtype, weak=out.weak,
                                origin=out.origin, device=True,
                                dev_chain=_first_chain(dev))
        return out

    def _numpy_call_impl(self, node: ast.Call, leaf: str) -> AbsVal:
        args = node.args
        ev = self.eval
        if leaf in ("zeros", "ones", "empty", "full"):
            shape = _shape_from_val(ev(args[0])) if args else None
            dt = self._dtype_kwarg(node)
            if dt is None and leaf == "full" and len(args) > 1:
                dt = None
            if dt is None:
                dt = "float32"
            return AbsVal.array(shape, dt)
        if leaf == "zeros_like" or leaf == "ones_like" \
                or leaf == "full_like" or leaf == "empty_like":
            v = ev(args[0]) if args else AbsVal.top()
            dt = self._dtype_kwarg(node) or v.dtype
            return AbsVal.array(v.shape, dt, origin=v.origin)
        if leaf == "arange":
            n = _const_int(ev(args[0])) if args else None
            if len(args) >= 2:
                lo = _const_int(ev(args[0]))
                hi = _const_int(ev(args[1]))
                n = hi - lo if lo is not None and hi is not None else None
            dt = self._dtype_kwarg(node) or "int32"
            return AbsVal.array((n,), dt)
        if leaf == "asarray" or leaf == "array":
            v = ev(args[0]) if args else AbsVal.top()
            dt = self._dtype_kwarg(node) or v.dtype
            if v.is_array:
                return AbsVal.array(v.shape, dt, origin=v.origin)
            if v.kind == "tuple":
                return AbsVal.array((len(v.items),), dt)
            if v.kind == "const":
                return AbsVal.array((), dt, weak=dt is None)
            return AbsVal.array(None, dt)
        if leaf == "reshape" and args:
            base = ev(args[0])
            return self._reshape(node, base,
                                 args[1] if len(args) > 1 else None)
        if leaf == "broadcast_to" and len(args) >= 2:
            base = ev(args[0])
            shape = _shape_from_val(ev(args[1]))
            bshape, conflict = broadcast_shapes(base.shape, shape)
            if conflict is not None:
                self.sink.binop_conflict(self.mi.sf.path, node.lineno, "broadcast_to",
                                         base, AbsVal.array(shape, None),
                                         conflict)
            return AbsVal.array(shape, base.dtype, origin=base.origin)
        if leaf in ("where",) and len(args) >= 3:
            c, x, y = ev(args[0]), ev(args[1]), ev(args[2])
            shape, conflict = broadcast_shapes(c.shape, x.shape)
            if conflict is not None:
                self.sink.binop_conflict(self.mi.sf.path, node.lineno, "where", c, x,
                                         conflict)
            shape2, conflict2 = broadcast_shapes(shape, y.shape)
            if conflict2 is not None:
                self.sink.binop_conflict(self.mi.sf.path, node.lineno, "where", x, y,
                                         conflict2)
            xv = x if x.is_array else y
            return AbsVal.array(shape2, promote(x, y) or xv.dtype,
                                origin=xv.origin)
        if leaf in _REDUCTIONS and args:
            base = ev(args[0])
            if leaf in ("matmul", "dot") and len(args) >= 2:
                return self._matmul(node.lineno, base, ev(args[1]))
            return self._reduce(node, leaf, base)
        if leaf in ("any", "all", "max", "min", "argmax", "argmin") \
                and args:
            base = ev(args[0])
            dt = ("bool" if leaf in ("any", "all")
                  else "int32" if leaf.startswith("arg") else base.dtype)
            return self._axis_reduce_shape(node, base, dt)
        if leaf == "take_along_axis" and len(args) >= 2:
            a, idx = ev(args[0]), ev(args[1])
            if a.rank is not None and idx.rank is not None \
                    and a.rank != idx.rank:
                self.sink.rank_mismatch(self.mi.sf.path, node.lineno, "take_along_axis",
                                        a, idx)
            return AbsVal.array(idx.shape, a.dtype, origin=a.origin)
        if leaf == "transpose" and args:
            base = ev(args[0])
            axes = _const_tuple(ev(args[1])) if len(args) > 1 else None
            if base.shape is not None and axes is not None \
                    and len(axes) == len(base.shape):
                return AbsVal.array(
                    tuple(base.shape[i] for i in axes), base.dtype,
                    origin=base.origin)
            return AbsVal.array(None if base.shape is None else
                                tuple(reversed(base.shape)),
                                base.dtype, origin=base.origin)
        if leaf == "pad" and args:
            base = ev(args[0])
            shape = None if base.shape is None else \
                tuple(None for _ in base.shape)
            return AbsVal.array(shape, base.dtype, origin=base.origin)
        if leaf in ("clip", "abs", "negative", "logical_not",
                    "invert", "exp", "log", "sqrt"):
            base = ev(args[0]) if args else AbsVal.top()
            for extra in args[1:]:
                ev(extra)
            return AbsVal.array(base.shape, base.dtype,
                                origin=base.origin)
        if leaf in ("repeat", "tile", "concatenate", "stack",
                    "searchsorted", "unique", "nonzero", "flip",
                    "sort", "argsort", "cumsum"):
            for a in args:
                ev(a)
            base = ev(args[0]) if args else AbsVal.top()
            if leaf == "cumsum" and base.is_array:
                return self._reduce(node, leaf, base)
            if leaf == "searchsorted":
                probe = ev(args[1]) if len(args) > 1 else AbsVal.top()
                return AbsVal.array(probe.shape, "int32")
            return AbsVal.array(None, base.dtype if base.is_array
                                else None)
        if leaf == "broadcast_shapes":
            return AbsVal.host()
        for a in args:
            ev(a)
        return AbsVal.array(None, None)

    def project_resolve(self, name: str):
        fns = self.mi.all_functions.get(name)
        if fns:
            return self.mi, fns[0]
        return self.project_fn(name)

    def project_fn(self, name: str):
        resolved = self.interp.project.resolve_function(self.mi, name)
        q = self.local_imports.get(name)
        if resolved is None and q is not None:
            owner, _, attr = q.rpartition(".")
            target = self.interp.project.modules.get(owner)
            if target is not None and attr in target.functions:
                return target, target.functions[attr]
        return resolved

    def _project_call(self, node: ast.Call, q: str,
                      argvals: List[AbsVal]) -> AbsVal:
        d = dotted(node.func)
        if d is None:
            return AbsVal.top()
        resolved = None
        if "." not in d:
            resolved = self.project_resolve(d)
        else:
            root, _, attr = d.rpartition(".")
            target = self.interp.project.modules.get(
                self.mi.imports.get(root, ""))
            if target is not None and "." not in attr \
                    and attr in target.functions:
                resolved = (target, target.functions[attr])
        if resolved is None:
            return AbsVal.top()
        mi, fn = resolved
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return AbsVal.top()
        env: Dict[str, AbsVal] = {}
        params = [a.arg for a in fn.args.args]
        for p, v in zip(params, argvals):
            env[p] = _with_origin(v, f"param `{p}`") if not v.origin \
                else v
        for kw in node.keywords:
            if kw.arg is not None and kw.arg in params:
                env[kw.arg] = self.eval(kw.value)
        self._default_params(fn, env)
        return self.interp.run_function(mi, fn, env, self.depth + 1)

    def _default_params(self, fn, env: Dict[str, AbsVal]) -> None:
        """Bind unbound params: defaults fold to consts, the rest ⊤."""
        args = fn.args
        defaults = list(args.defaults)
        names = [a.arg for a in args.args]
        for name, d in zip(names[len(names) - len(defaults):], defaults):
            if name not in env:
                env[name] = AbsVal.const_(d.value) \
                    if isinstance(d, ast.Constant) \
                    else AbsVal.top()
        for a in args.args + args.kwonlyargs:
            env.setdefault(a.arg, AbsVal.top(origin=f"param `{a.arg}`"))

    # -- shared op helpers ---------------------------------------------

    def _reshape(self, node, base: AbsVal, want_expr) -> AbsVal:
        want = _shape_from_val(self.eval(want_expr)) \
            if want_expr is not None else None
        if want is not None and base.shape is not None:
            src_n = _shape_size(base.shape)
            dst_n = _shape_size(want)
            has_minus1 = any(isinstance(d, int) and d == -1
                             for d in want)
            if src_n is not None and dst_n is not None \
                    and not has_minus1 and src_n != dst_n:
                self.sink.reshape_mismatch(self.mi.sf.path, node.lineno, base, want)
            if has_minus1:
                want = tuple(None if (isinstance(d, int) and d == -1)
                             else d for d in want)
        return AbsVal.array(want, base.dtype, origin=base.origin)

    def _reduce(self, node: ast.Call, leaf: str,
                base: AbsVal) -> AbsVal:
        has_dtype = any(kw.arg == "dtype" for kw in node.keywords)
        named = self._dtype_kwarg(node)
        dt = named or base.dtype
        axis = None
        for kw in node.keywords:
            if kw.arg in ("axis", "dim"):
                axis = _const_int(self.eval(kw.value))
        # positional dim (torch's x.sum(0) / x.cumsum(1)) is left
        # unknown: the extent then counts the whole operand
        extent = _reduced_extent(base.shape, axis,
                                 keep=leaf in ("cumsum", "cumprod"))
        if base.is_array:
            self.sink.reduction(self.mi.sf.path, node.lineno, leaf, base,
                                extent, has_dtype, named)
        if leaf in ("cumsum", "cumprod"):
            return AbsVal.array(base.shape, dt, origin=base.origin)
        shape = _drop_axis(base.shape, axis)
        return AbsVal.array(shape, dt, origin=base.origin)

    def _axis_reduce_shape(self, node: ast.Call, base: AbsVal,
                           dtype: Optional[str]) -> AbsVal:
        axis = None
        for kw in node.keywords:
            if kw.arg in ("axis", "dim"):
                axis = _const_int(self.eval(kw.value))
        if len(node.args) >= 2:
            axis = _const_int(self.eval(node.args[1]))
        return AbsVal.array(_drop_axis(base.shape, axis), dtype,
                            origin=base.origin)

    def _dtype_kwarg(self, node: ast.Call) -> Optional[str]:
        for kw in node.keywords:
            if kw.arg == "dtype":
                return self._dtype_of_expr(kw.value)
        return None

    def _dtype_of_expr(self, expr: ast.expr) -> Optional[str]:
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value if expr.value in _DTYPES else None
        q = self.mi.qualify(expr)
        if q is not None:
            leaf = q.rsplit(".", 1)[-1]
            if leaf in _DTYPES:
                return leaf
        v = self.eval(expr)
        if v.kind == "const" and isinstance(v.const, tuple) \
                and len(v.const) == 2 and v.const[0] == "dtype":
            return v.const[1]
        if v.kind == "const" and isinstance(v.const, str) \
                and v.const in _DTYPES:
            return v.const
        return None


# -- small helpers ----------------------------------------------------------

def _local_imports(fn: ast.AST) -> Dict[str, str]:
    """The absolute ``from mod import name`` statements in ``fn``."""
    out: Dict[str, str] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for alias in node.names:
                out[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return out


def _is_np_root(q: str) -> bool:
    return q.startswith(("numpy.", "np.")) or q == "numpy"


def _is_torch_root(q: str) -> bool:
    """``torch.<op>`` (not ``torch.cuda.…``/``torch.nn.…``)."""
    return q.startswith("torch.") and q.count(".") == 1


def _size_syncs(op: str, vals: Sequence[AbsVal],
                node: ast.Call) -> bool:
    """Does this data-dependent-size op make the host wait? Only on
    device operands; ``repeat_interleave`` only when its repeats are a
    tensor (an int count fixes the size) and no ``output_size=`` is
    given."""
    if op != "repeat_interleave":
        return any(v.device for v in vals)
    if any(kw.arg == "output_size" for kw in node.keywords):
        return False
    # (self, repeats) — or the one-tensor form, whose operand IS the
    # repeats
    repeats = vals[1] if len(vals) > 1 else vals[0] if vals else None
    return repeats is not None and repeats.is_array and repeats.device


def _first_chain(v: AbsVal) -> Tuple[str, ...]:
    """The residency chain of a value or of its first device item."""
    if v.device:
        return v.dev_chain
    for item in v.items or ():
        if _any_device(item):
            return _first_chain(item)
    return ()


def _with_origin(v: AbsVal, origin: str) -> AbsVal:
    out = AbsVal(v.kind, const=v.const, items=v.items, shape=v.shape,
                 dtype=v.dtype, weak=v.weak, from_shape=v.from_shape,
                 origin=origin, device=v.device, dev_chain=v.dev_chain)
    return out


def _any_device(v: AbsVal) -> bool:
    """True if the value or any container element is device-resident."""
    if v.device:
        return True
    if v.kind == "tuple":
        return any(_any_device(i) for i in v.items)
    return False


def _undevice(v: AbsVal) -> AbsVal:
    """The host copy of a value: same shape face, residency cleared."""
    if v.kind == "tuple":
        return AbsVal.tuple_([_undevice(i) for i in v.items],
                             origin=v.origin)
    if v.is_array and v.device:
        return AbsVal.array(v.shape, v.dtype, weak=v.weak,
                            origin=v.origin)
    return v


def _coerce_array(v: AbsVal, dt) -> AbsVal:
    """asarray/array coercion: shape face of the result (host)."""
    if v.is_array:
        return AbsVal.array(v.shape, dt, origin=v.origin)
    if v.kind == "tuple":
        return AbsVal.array((len(v.items),), dt)
    if v.kind == "const":
        return AbsVal.array((), dt, weak=dt is None)
    return AbsVal.array(None, dt)


def _dim_val(d: Dim, base: AbsVal) -> AbsVal:
    name = base.origin or "array"
    if isinstance(d, int):
        return AbsVal.const_(d, from_shape=True,
                             origin=f"dim of {name}")
    if isinstance(d, Sym):
        return AbsVal.const_(d, from_shape=True,
                             origin=f"dim `{d}` of {name}")
    return AbsVal("const", const=None, from_shape=True,
                  origin=f"dim of {name}")


def _shape_size(shape: Optional[Tuple]):
    if shape is None:
        return None
    n = 1
    for d in shape:
        if not isinstance(d, int) or d < 0:
            return None
        n *= d
    return n


def _reduced_extent(shape: Optional[Tuple], axis: Optional[int],
                    keep: bool = False):
    """Number of elements folded into one accumulator lane; None when
    unknown. ``keep`` (cumsum) reduces along one axis regardless."""
    if shape is None:
        return None
    if axis is None and not keep:
        return _shape_size(shape)
    if axis is None:
        axis = 0
    if -len(shape) <= axis < len(shape):
        d = shape[axis]
        return d if isinstance(d, int) else None
    return None


def _drop_axis(shape: Optional[Tuple], axis: Optional[int]):
    if shape is None:
        return None
    if axis is None:
        return ()
    if -len(shape) <= axis < len(shape):
        idx = axis % len(shape)
        return tuple(d for i, d in enumerate(shape) if i != idx)
    return None


def _shape_from_val(v: AbsVal) -> Optional[Tuple]:
    """A shape argument: a const int (1-d), a tuple of dims, or ⊥."""
    if v.kind == "const" and isinstance(v.const, int):
        return (v.const,)
    if v.kind == "const" and isinstance(v.const, Sym):
        return (v.const,)
    if v.kind == "const" and v.const is None:
        return (None,)
    if v.kind == "tuple":
        out = []
        for item in v.items:
            if item.kind == "const" and isinstance(item.const,
                                                   (int, Sym)):
                out.append(item.const)
            else:
                out.append(None)
        return tuple(out)
    return None


def _const_int(v: AbsVal) -> Optional[int]:
    if v.kind == "const" and isinstance(v.const, int) \
            and not isinstance(v.const, bool):
        return v.const
    return None


def _const_tuple(v: AbsVal) -> Optional[Tuple[int, ...]]:
    if v.kind != "tuple":
        return None
    out = []
    for item in v.items:
        i = _const_int(item)
        if i is None:
            return None
        out.append(i)
    return tuple(out)


def _element_of(it: AbsVal) -> AbsVal:
    """Abstract element of an iterated value."""
    if it.kind == "tuple" and it.items:
        out = it.items[0]
        for v in it.items[1:]:
            out = join(out, v)
        return out
    if it.is_array and it.shape is not None and it.shape:
        return AbsVal.array(tuple(it.shape[1:]), it.dtype,
                            origin=it.origin, device=it.device,
                            dev_chain=it.dev_chain)
    if it.is_array and it.device:
        # unknown shape, but residency survives iteration
        return AbsVal.array(None, it.dtype, origin=it.origin,
                            device=True, dev_chain=it.dev_chain)
    return AbsVal.top()


def _fold(op: str, a, b):
    try:
        if op == "Add":
            return a + b
        if op == "Sub":
            return a - b
        if op == "Mult":
            return a * b
        if op == "FloorDiv":
            return a // b
        if op == "Mod":
            return a % b
        if op == "Pow" and abs(b) < 64:
            return a ** b
        if op == "LShift" and 0 <= b < 128:
            return a << b
        if op == "RShift" and 0 <= b < 128:
            return a >> b
        if op == "BitOr":
            return a | b
        if op == "BitAnd":
            return a & b
        if op == "BitXor":
            return a ^ b
        if op == "Div" and b != 0:
            return a / b
    except (TypeError, ZeroDivisionError, OverflowError, ValueError):
        return None
    return None


def _slice_extent(state: _State, sl: ast.Slice, dim: Dim) -> Dim:
    """Extent of a slice over a dim — exact for const bounds over
    const dims, else unknown."""
    if sl.step is not None:
        return None
    lo = _const_int(state.eval(sl.lower)) if sl.lower is not None else 0
    hi = _const_int(state.eval(sl.upper)) if sl.upper is not None \
        else (dim if isinstance(dim, int) else None)
    if lo is not None and hi is not None and isinstance(dim, int):
        lo = lo if lo >= 0 else max(0, dim + lo)
        hi = hi if hi >= 0 else max(0, dim + hi)
        return max(0, min(hi, dim) - lo)
    return None


def _join_envs(a: Dict[str, AbsVal], b: Dict[str, AbsVal]
               ) -> Dict[str, AbsVal]:
    out = {}
    for k in set(a) | set(b):
        if k in a and k in b:
            out[k] = join(a[k], b[k])
        else:
            out[k] = a.get(k) or b.get(k)
    return out


def _src_of(node: ast.expr) -> str:
    d = dotted(node)
    return f"`{d}`" if d else "<expr>"
