"""device-dataflow (ctlint v4): host↔device hazards on the serving
hot path — in the port, torch's and CUDA's.

Every CPU test of the port runs its plain versions, where a
host↔device round-trip is free — so the hazards that wreck latency on
the card are invisible to them: an implicit host sync (``float()`` of
a device scalar, ``.cpu()`` per loop iteration, a Python branch on a
device value, an op whose output size the host must read first)
serializes the launch queue; a per-iteration ``.to(dev)`` puts a PCIe
transfer on the critical path; an out-of-place update of a device
buffer allocates a fresh one every call. This family proves the hot
path free of them the same way the thread-safety family proves it
free of data races.

Mechanically it extends the dataflow core (``dataflow.AbsVal``) with
a **device-residency dimension**: values produced by the kernel
wrappers and device steps, by a ``torch.*`` constructor given
``device=``, by ``.to(dev)`` / ``.cuda()``, and the known device
tables (memo table, session row table, ServedPack lanes) carry
``device=True`` plus a ``dev_chain`` def-site provenance chain,
propagated through ops, subscripts, calls, and containers. Hot roots
are discovered over the callgraph — any in-scope function that issues
a device dispatch (a kernel wrapper or device step call, a
``KERNEL.launch``, a ``self._step``-style memoized step, a
``_gather_step()(…)`` factory step, or a serve-plane method like
``serve_ids``/``verdict_chunk``) — plus the named serving spine (ring
pack, session serve, capture chunk, serve-loop cycle, dnsproxy batch,
the fused step, the served pack's readback). Four rules consume the
resulting event stream; findings carry the residency chain in
schema-v4 CTLINT.json:

* **implicit-sync** — ``float()`` / ``int()`` / ``bool()``,
  ``.item()``, ``.tolist()``, truthiness, and the ops whose output
  size the host must read (``nonzero``, a boolean-mask index,
  ``masked_select``, ``unique``, ``repeat_interleave`` without
  ``output_size``) wherever they meet a device value; ``.cpu()``,
  ``.numpy()``, ``np.asarray``, a blocking ``copy_`` into a host
  tensor, ``torch.cuda.synchronize`` and ``Event.synchronize`` inside
  a loop, or fragmented (several straight-line readbacks that should
  be one);
* **hot-loop-h2d** — ``torch.as_tensor(..., device=)``,
  ``torch.tensor(..., device=)``, ``.to(dev)``, ``.cuda()`` and a
  device tensor's ``copy_`` from host inside a loop; staging into
  instance state (the pinned-buffer prefetch idiom) is exempt;
* **readback-ordering** — a readback of one dispatch's result before a
  later, independent dispatch;
* **missing-donation** — torch has no donation, but the hazard is the
  same: an out-of-place ``index_put`` / ``scatter`` / ``index_copy`` /
  ``index_add`` / ``masked_fill`` / ``torch.where`` of a device buffer
  that outlives the call (a parameter, as the reference's donated
  argument, or an attribute such as the memo's ``self.table``),
  assigned back to the same name or attribute, allocates a fresh
  buffer per call where the in-place form (``index_put_``,
  ``scatter_``, ``index_copy_``, ``masked_fill_``, ``torch.where(...,
  out=)``) would not. A temporary the function built itself is not
  such a buffer.

Two torch refinements: a branch on ``t.is_cuda`` of a device-resident
``t`` runs only its card arm (the other arm is the plain version's,
which takes CPU tensors), and tensor metadata (``.shape``, ``.size()``,
``.device``, ``.data_ptr()``) never syncs.

False-negative classes are deliberate (miss, don't invent):
residency is lost at unresolvable method boundaries
(``self.ring.pack(...)``), through dict containers, and through
first-class callables (the phase probes' ``_timed(fn)`` indirection);
a single terminal batched readback at the API edge is the *contract*,
not a hazard, and is exempt by construction.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from cilium_tpu_torch.analysis import dataflow
from cilium_tpu_torch.analysis.callgraph import (ModuleInfo, Project, dotted,
                                                 project_for)
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker
from cilium_tpu_torch.analysis.dataflow import AbsVal, EventSink, Interp
from cilium_tpu_torch.analysis.purity import find_entries

RULE_SYNC = "implicit-sync"
RULE_H2D = "hot-loop-h2d"
RULE_DONATE = "missing-donation"
RULE_ORDER = "readback-ordering"

#: the serving hot path lives here (relative to the run's package);
#: everything else is staging/CLI surface where a sync is fine. dst.py
#: is the simulation harness (its reference lane reads back eagerly BY
#: DESIGN, to compare) — out of scope.
_SCOPE_PREFIXES = ("engine/", "runtime/")
_SCOPE_FILES = ("fqdn/dnsproxy.py",)
_SCOPE_EXCLUDE = ("runtime/dst.py",)

#: attribute-call names that ARE a device dispatch in this codebase:
#: the serve-plane methods, the ``self._step`` memo idiom and a
#: kernel's ``launch``. A dispatch is a residency boundary — the walk
#: does not enter it (the callee is analyzed as its own root); its
#: result is device.
DISPATCH_ATTRS = frozenset({
    "serve_ids", "verdict_chunk", "verdict_idx", "verdict_rows",
    "verdict_batch_arrays", "gather", "_step", "_full", "launch",
})

#: self-attributes that are device-resident tables, scoped by file
#: suffix so a generic name ("table") marks only the module whose
#: table actually lives on device
DEVICE_ATTRS: Dict[str, Tuple[str, ...]] = {
    "rows_dev": ("engine/session.py",),
    "table": ("engine/memo.py",),
    "verdict": ("engine/attribution.py",),
    "l7_match": ("engine/attribution.py",),
    "match_spec": ("engine/attribution.py",),
}

#: the named serving spine — always roots, even if a refactor hides
#: their dispatch behind an unresolvable boundary (path suffixes)
NAMED_ROOTS: Tuple[Tuple[str, Optional[str], str], ...] = (
    ("engine/ring.py", "VerdictRing", "pack"),
    ("engine/session.py", "IncrementalSession", "serve_ids"),
    ("engine/replay.py", "CaptureReplay", "verdict_chunk"),
    ("runtime/serveloop.py", "ServeLoop", "step"),
    ("fqdn/dnsproxy.py", "DNSProxy", "check_batch"),
    ("engine/megakernel.py", None, "fused_verdict_step"),
    ("engine/attribution.py", "ServedPack", "host"),
)

#: sync vocabulary (kept in parity with purity._SYNC_ATTRS): scalar
#: coercions and size-syncing ops block the host wherever they appear;
#: bulk readbacks are the legitimate API-edge pattern and only flag
#: inside a loop (or when fragmented — several straight-line readbacks
#: that should be one)
_SCALAR_SYNCS = frozenset(
    {"int()", "float()", "bool()", ".item()", ".tolist()",
     "truthiness", "boolean-mask index"}
    | {f".{op}()" for op in dataflow._SIZE_SYNC_OPS}
    | {f"torch.{op}" for op in dataflow._SIZE_SYNC_OPS})
_BULK_SYNCS = frozenset({"np.asarray", "np.array", ".cpu()",
                         ".numpy()", ".to('cpu')", ".copy_() into host",
                         "torch.cuda.synchronize",
                         "Event.synchronize"})

#: out-of-place updates whose in-place twin writes the buffer itself
_OUT_OF_PLACE = {"index_put": "index_put_", "scatter": "scatter_",
                 "scatter_add": "scatter_add_",
                 "index_copy": "index_copy_", "index_add": "index_add_",
                 "index_fill": "index_fill_",
                 "masked_fill": "masked_fill_",
                 "masked_scatter": "masked_scatter_"}


def _in_scope(path: str, package: str) -> bool:
    if path in {f"{package}/{p}" for p in _SCOPE_EXCLUDE}:
        return False
    return path.startswith(tuple(f"{package}/{p}"
                                 for p in _SCOPE_PREFIXES)) \
        or path in {f"{package}/{p}" for p in _SCOPE_FILES}


# -- dispatch recognition ---------------------------------------------------


def _dispatch_label(node: ast.Call) -> Optional[str]:
    """Syntactic device-dispatch forms: ``obj.serve_ids(…)`` /
    ``self._step(…)`` attribute calls, and the jit-factory idiom
    ``_gather_step()(table, idx)`` / ``self._blob_step(layout)(…)``."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in DISPATCH_ATTRS:
        return f.attr
    if isinstance(f, ast.Call):
        inner = f.func
        name = inner.attr if isinstance(inner, ast.Attribute) else (
            inner.id if isinstance(inner, ast.Name) else None)
        if name is not None and name.endswith("_step"):
            return f"{name}()"
    return None


def _resolve_call(project: Project, mi: ModuleInfo, node: ast.Call,
                  local_imports: Optional[Dict[str, str]] = None
                  ) -> Optional[Tuple[ModuleInfo, ast.AST]]:
    """The project-resolution the dataflow core uses for plain calls:
    bare names through all_functions/imports (and the calling
    function's own ``from mod import fn``), ``mod.fn`` through an
    imported project module."""
    d = dotted(node.func)
    if d is None:
        return None
    if "." not in d:
        fns = mi.all_functions.get(d)
        if fns:
            return mi, fns[0]
        resolved = project.resolve_function(mi, d)
        q = (local_imports or {}).get(d)
        if resolved is None and q is not None:
            owner, _, attr = q.rpartition(".")
            target = project.modules.get(owner)
            if target is not None and attr in target.functions:
                return target, target.functions[attr]
        return resolved
    root, _, attr = d.rpartition(".")
    target = project.modules.get(mi.imports.get(root, ""))
    if target is not None and "." not in attr \
            and attr in target.functions:
        return target, target.functions[attr]
    return None


def _is_jit_dispatch(project: Project, mi: ModuleInfo, node: ast.Call,
                     jit_ids: Set[int],
                     local_imports: Optional[Dict[str, str]] = None
                     ) -> Optional[str]:
    """The name of the kernel wrapper or device step ``node`` calls."""
    resolved = _resolve_call(project, mi, node, local_imports)
    if resolved is not None and id(resolved[1]) in jit_ids:
        return getattr(resolved[1], "name", "<jit>")
    return None


# -- hot-root discovery -----------------------------------------------------


def _module_units(mi: ModuleInfo):
    """(class name or None, ClassDef or None, fn) for every top-level
    function and class-body method. Nested defs are reached
    interprocedurally from their parent, not walked as roots."""
    for node in mi.sf.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, None, node
        elif isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    yield node.name, node, stmt


def _is_named_root(path: str, cls: Optional[str], fn_name: str) -> bool:
    for p, c, n in NAMED_ROOTS:
        if path.endswith(p) and fn_name == n \
                and (c is None or c == cls):
            return True
    return False


def _has_dispatch(project: Project, mi: ModuleInfo, fn: ast.AST,
                  jit_ids: Set[int]) -> bool:
    local = dataflow._local_imports(fn)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if _dispatch_label(node) is not None:
            return True
        if _is_jit_dispatch(project, mi, node, jit_ids, local) is not None:
            return True
    return False


def find_hot_roots(project: Project, jit_ids: Optional[Set[int]] = None
                   ) -> List[Tuple[ModuleInfo, ast.AST,
                                   Optional[ast.ClassDef], str]]:
    """Every in-scope function/method that issues a device dispatch,
    plus the named serving spine. Sorted by label so shared-site
    finding attribution is deterministic."""
    if jit_ids is None:
        jit_ids = dispatch_ids(project)
    roots = []
    seen: Set[int] = set()
    for modname in sorted(project.modules):
        mi = project.modules[modname]
        path = mi.sf.path
        if not _in_scope(path, project.index.package):
            continue
        for cls_name, cls_node, fn in _module_units(mi):
            if id(fn) in seen:
                continue
            if _is_named_root(path, cls_name, fn.name) \
                    or _has_dispatch(project, mi, fn, jit_ids):
                seen.add(id(fn))
                owner = f"{cls_name}." if cls_name else ""
                roots.append((mi, fn, cls_node,
                              f"{path}::{owner}{fn.name}"))
    roots.sort(key=lambda r: r[3])
    return roots


# -- the residency-aware interpreter state ----------------------------------


class _DevSink(EventSink):
    """Ordered, deduplicated residency event stream for one root.

    The core's loop bodies run twice (widening) and exclusive branch
    arms run serialized, so raw emission both duplicates and
    scrambles; dedup on (kind, site, how) keeps the first occurrence,
    and the ordering rule additionally gates on straight-line events
    (branch_depth 0, not in a loop) where emission order IS program
    order."""

    def __init__(self) -> None:
        self.events: List[tuple] = []
        self._seen: Set[tuple] = set()

    def _emit(self, key: tuple, ev: tuple) -> None:
        if key in self._seen:
            return
        self._seen.add(key)
        self.events.append(ev)

    def host_sync(self, path, line, how, val, in_loop,
                  branch_depth=0):
        self._emit(("sync", path, line, how),
                   ("sync", path, line, how, val, in_loop,
                    branch_depth))

    def h2d(self, path, line, how, val, in_loop, staged,
            branch_depth=0):
        self._emit(("h2d", path, line, how),
                   ("h2d", path, line, how, val, in_loop, staged,
                    branch_depth))

    def device_dispatch(self, path, line, label, arg_chains, out_chain,
                        in_loop, branch_depth=0):
        self._emit(("dispatch", path, line, label),
                   ("dispatch", path, line, label, arg_chains,
                    out_chain, in_loop, branch_depth))

    def donation(self, path, line, op, inplace, target, val):
        self._emit(("donate", path, line),
                   ("donate", path, line, op, inplace, target, val))


class _DevState(dataflow._State):
    """The core's state plus the codebase's device boundaries: known
    device tables on ``self``, dispatch-attr calls as residency
    sources (not walked — the callee is its own root), jitted-entry
    calls likewise, and ``self.method(…)`` resolution through the
    root's class so residency survives the helper-method hop."""

    def exec_stmt(self, node: ast.stmt) -> None:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            upd = _update_base(node.value)
            target = dotted(node.targets[0])
            # a buffer that outlives the call: a parameter or an
            # attribute (a temporary the function built is its own)
            if upd is not None and target is not None \
                    and dotted(upd[0]) == target \
                    and ("." in target or target in self.params):
                val = self.eval(upd[0])
                if val.device:
                    self.sink.donation(self.mi.sf.path, node.lineno,
                                       upd[1], upd[2], target, val)
        super().exec_stmt(node)

    def _attribute(self, node: ast.Attribute) -> AbsVal:
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            suffixes = DEVICE_ATTRS.get(node.attr)
            if suffixes and self.mi.sf.path.endswith(suffixes):
                site = (f"{self.mi.sf.path}:{node.lineno} "
                        f"self.{node.attr} (device table)")
                return AbsVal.array(None, None,
                                    origin=f"self.{node.attr}",
                                    device=True, dev_chain=(site,))
        return super()._attribute(node)

    def _call(self, node: ast.Call) -> AbsVal:
        label = _dispatch_label(node)
        if label is not None:
            return self._dispatch(node, label)
        fn = node.func
        if isinstance(fn, ast.Attribute) \
                and isinstance(fn.value, ast.Name) \
                and fn.value.id == "self":
            meth = self.interp.self_methods.get(fn.attr)
            if meth is not None:
                return self._self_call(node, meth)
        return super()._call(node)

    def _project_call(self, node: ast.Call, q: str,
                      argvals: List[AbsVal]) -> AbsVal:
        name = _is_jit_dispatch(self.interp.project, self.mi, node,
                                self.interp.jit_ids, self.local_imports)
        if name is not None:
            return self._emit_dispatch(node, f"device `{name}`", argvals)
        return super()._project_call(node, q, argvals)

    def _dispatch(self, node: ast.Call, label: str) -> AbsVal:
        f = node.func
        if isinstance(f, ast.Attribute):
            self.eval(f.value)
        elif isinstance(f, ast.Call):
            for a in f.args:
                self.eval(a)
        argvals = [self.eval(a) for a in node.args]
        for kw in node.keywords:
            if kw.value is not None:
                argvals.append(self.eval(kw.value))
        return self._emit_dispatch(node, label, argvals)

    def _emit_dispatch(self, node: ast.Call, label: str,
                       argvals: Sequence[AbsVal]) -> AbsVal:
        path, line = self.mi.sf.path, node.lineno
        chains: List[Tuple[str, ...]] = []
        for v in argvals:
            if v.device:
                chains.append(v.dev_chain)
            elif not (v.kind == "const" or v.from_shape):
                # a host value the dispatch consumes — it MAY depend
                # on an earlier readback, so the ordering rule must
                # not call this dispatch independent
                chains.append(("<host>",))
        out_chain = (f"{path}:{line} {label} dispatch",)
        self.sink.device_dispatch(path, line, label, tuple(chains),
                                  out_chain,
                                  self.interp.loop_depth > 0,
                                  self.interp.branch_depth)
        return AbsVal.array(None, None, origin=f"{label} result",
                            device=True, dev_chain=out_chain)

    def _self_call(self, node: ast.Call, meth: ast.AST) -> AbsVal:
        params = [a.arg for a in meth.args.args]
        env: Dict[str, AbsVal] = {}
        if params and params[0] == "self":
            env["self"] = AbsVal.host(origin="self")
            params = params[1:]
        argvals = [self.eval(a) for a in node.args]
        for p, v in zip(params, argvals):
            env[p] = v if v.origin \
                else dataflow._with_origin(v, f"param `{p}`")
        for kw in node.keywords:
            if kw.value is None:
                continue
            v = self.eval(kw.value)
            if kw.arg is not None and kw.arg in params:
                env[kw.arg] = v
        self._default_params(meth, env)
        return self.interp.run_function(self.mi, meth, env,
                                        self.depth + 1)


class _DevInterp(Interp):
    state_cls = _DevState

    def __init__(self, project: Project, sink: EventSink,
                 jit_ids: Set[int],
                 self_methods: Dict[str, ast.AST]):
        super().__init__(project, sink)
        self.jit_ids = jit_ids
        #: the root's class methods, for `self.helper(…)` resolution
        self.self_methods = self_methods


def _walk_root(project: Project, jit_ids: Set[int], mi: ModuleInfo,
               fn: ast.AST,
               cls_node: Optional[ast.ClassDef]) -> _DevSink:
    sink = _DevSink()
    methods: Dict[str, ast.AST] = {}
    if cls_node is not None:
        for stmt in cls_node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[stmt.name] = stmt
    interp = _DevInterp(project, sink, jit_ids, methods)
    env = dataflow.param_shapes(mi, fn)
    # `self` is an object, never an array — param_shapes' array seed
    # would swallow every attribute/method access on it
    env["self"] = AbsVal.host(origin="self")
    interp.run_function(mi, fn, env)
    return sink


# -- rules over the event stream --------------------------------------------


def _residency(val: AbsVal) -> Tuple[str, ...]:
    return tuple(val.dev_chain)


def _findings_for_root(sink: _DevSink, label: str) -> List[Finding]:
    out: List[Finding] = []
    #: straight-line bulk readbacks, for the fragmented face
    frag: List[tuple] = []
    for ev in sink.events:
        if ev[0] == "sync":
            _, path, line, how, val, in_loop, bd = ev
            what = val.origin or "a device value"
            if how in _SCALAR_SYNCS:
                out.append(Finding(
                    path, line, RULE_SYNC,
                    f"implicit host sync: `{how}` coerces "
                    f"device-resident {what} on hot path `{label}` — "
                    f"the host blocks mid-dispatch; read back once, "
                    f"in bulk, at the path's edge",
                    residency=_residency(val)))
            elif how in _BULK_SYNCS and in_loop:
                out.append(Finding(
                    path, line, RULE_SYNC,
                    f"per-iteration host readback `{how}` of "
                    f"device-resident {what} inside a loop on hot "
                    f"path `{label}` — batch one readback outside "
                    f"the loop",
                    residency=_residency(val)))
            elif how in _BULK_SYNCS and bd == 0 and val.dev_chain:
                frag.append((path, line, how, val))
        elif ev[0] == "donate":
            _, path, line, op, inplace, target, val = ev
            out.append(Finding(
                path, line, RULE_DONATE,
                f"out-of-place `{op}` of device buffer `{target}` is "
                f"assigned back to `{target}` on hot path `{label}` — "
                f"a fresh buffer is allocated every call; update it in "
                f"place (`{inplace}`)",
                residency=_residency(val)))
        elif ev[0] == "h2d":
            _, path, line, how, val, in_loop, staged, bd = ev
            if in_loop and not staged and not val.device:
                out.append(Finding(
                    path, line, RULE_H2D,
                    f"per-iteration host→device transfer `{how}` "
                    f"inside a loop on hot path `{label}` — hoist it "
                    f"out of the loop, or stage it ahead into "
                    f"instance state (the capture-prefetch "
                    f"double-buffer idiom)",
                    residency=(f"{path}:{line} {how}",)))
    # fragmented readback: several straight-line bulk readbacks on one
    # hot path — each is a separate blocking transfer where a single
    # batched jax.device_get would do
    if len(frag) >= 2:
        path, line, how, val = frag[0]
        others = ", ".join(f"{p.rsplit('/', 1)[-1]}:{ln}"
                           for p, ln, _h, _v in frag[1:])
        out.append(Finding(
            path, line, RULE_SYNC,
            f"fragmented readback: {len(frag)} separate host "
            f"readbacks on hot path `{label}` (also {others}) — "
            f"batch them into a single readback (stack the lanes, "
            f"one .cpu())",
            residency=_residency(val)))
    out.extend(_ordering_findings(sink, label))
    return out


def _ordering_findings(sink: _DevSink, label: str) -> List[Finding]:
    """A straight-line bulk readback of one dispatch's result issued
    BEFORE a later, provably independent dispatch: the readback
    blocks the host, so the second dispatch misses its pipeline slot.
    Independence is conservative — every dispatch argument must be
    device-resident (chains disjoint from the readback's) or a known
    static; any plain host argument may depend on the readback and
    vetoes the pairing."""
    out: List[Finding] = []
    events = sink.events
    for i, ev in enumerate(events):
        if ev[0] != "sync":
            continue
        _, path, line, how, val, in_loop, bd = ev
        if how not in _BULK_SYNCS or in_loop or bd != 0 \
                or not val.dev_chain:
            continue
        chain = set(val.dev_chain)
        for later in events[i + 1:]:
            if later[0] != "dispatch":
                continue
            (_, dpath, dline, dlabel, arg_chains, _out_chain,
             d_in_loop, d_bd) = later
            if d_in_loop or d_bd != 0:
                continue
            if any(c == ("<host>",) for c in arg_chains):
                continue
            if any(chain & set(c) for c in arg_chains):
                continue
            out.append(Finding(
                path, line, RULE_ORDER,
                f"host readback `{how}` of "
                f"{val.origin or 'a device value'} blocks before the "
                f"independent device dispatch `{dlabel}` at "
                f"{dpath}:{dline} on hot path `{label}` — issue the "
                f"dispatch first (or batch readbacks after all "
                f"dispatches) to keep the device pipeline full",
                residency=_residency(val)))
            break
    return out


# -- missing-donation (residency-aware, over the hot roots' walk) -----------


def _update_base(node: ast.expr) -> Optional[Tuple[ast.expr, str, str]]:
    """(updated operand, op, in-place form) of an out-of-place update
    call: ``t.index_put(...)``, ``torch.index_copy(t, ...)``,
    ``torch.where(c, a, t)``; None for anything else."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr in _OUT_OF_PLACE:
        if dotted(f.value) == "torch" and node.args:
            return node.args[0], f"torch.{f.attr}", _OUT_OF_PLACE[f.attr]
        return f.value, f".{f.attr}", _OUT_OF_PLACE[f.attr]
    if f.attr == "where" and dotted(f.value) == "torch" \
            and len(node.args) == 3:
        return node.args[2], "torch.where", "torch.where(..., out=)"
    return None


def dispatch_ids(project: Project) -> Set[int]:
    """The device entries a call to which is a dispatch boundary: the
    kernel wrappers, the device steps and compiled entries — not the
    plain versions, which the walk enters like any helper."""
    return {id(fn) for _, fn in find_entries(project)
            if not getattr(fn, "name", "").endswith("_plain")}


def named_root_syncs(index: ProjectIndex) -> Dict[str, Dict]:
    """For each named root (:data:`NAMED_ROOTS`) found in the tree: the
    host-sync and upload sites its walk sees, each as ``path:first-last
    what`` over the lines of its statement (a finding, the API-edge
    readback the contract allows, or a transfer — torch waits on a
    pageable upload too), and its implicit-sync findings, each marked
    allowlisted or not — what a run on the card is held against
    (``chip_smoke.py`` phase 21)."""
    project = project_for(index)
    jit_ids = dispatch_ids(project)
    out: Dict[str, Dict] = {}
    for mi, fn, cls_node, label in find_hot_roots(project, jit_ids):
        if not _is_named_root(mi.sf.path, getattr(cls_node, "name", None),
                              fn.name):
            continue
        sink = _walk_root(project, jit_ids, mi, fn, cls_node)
        seen = sorted({f"{ev[1]}:{_statement_lines(index, ev[1], ev[2])}"
                       f" {'upload ' if ev[0] == 'h2d' else ''}{ev[3]}"
                       for ev in sink.events if ev[0] in ("sync", "h2d")})
        found = []
        for f in _findings_for_root(sink, label):
            if f.rule != RULE_SYNC:
                continue
            sf = index.by_path.get(f.path)
            allowed = sf is not None and sf.disabled(f.line, f.rule)
            found.append({"site": f"{f.path}:{f.line}",
                          "allowlisted": allowed})
        out[label] = {"seen": seen, "findings": found}
    return out


def _statement_lines(index: ProjectIndex, path: str, line: int) -> str:
    """``first-last``: the lines of the innermost statement holding
    ``line`` (a call that spans lines is reported at any of them)."""
    sf = index.by_path.get(path)
    best = (line, line)
    if sf is not None:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.stmt) and not isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef, ast.If, ast.For, ast.While,
                           ast.With, ast.Try)) \
                    and node.lineno <= line <= (node.end_lineno or line):
                if node.end_lineno - node.lineno <= best[1] - best[0] \
                        or best == (line, line):
                    best = (node.lineno, node.end_lineno)
    return f"{best[0]}-{best[1]}"


# -- the checker ------------------------------------------------------------


@checker
def check(index: ProjectIndex) -> List[Finding]:
    project = project_for(index)
    findings: List[Finding] = []
    jit_ids = dispatch_ids(project)
    picked: Dict[Tuple[str, int, str], Finding] = {}
    for mi, fn, cls_node, label in find_hot_roots(project, jit_ids):
        sink = _walk_root(project, jit_ids, mi, fn, cls_node)
        for f in _findings_for_root(sink, label):
            # the first (label-sorted) root to reach a shared helper
            # site owns the attribution
            picked.setdefault((f.path, f.line, f.rule), f)
    findings.extend(picked.values())
    return sorted(set(findings))
check.emits = (RULE_SYNC, RULE_H2D, RULE_DONATE, RULE_ORDER)
