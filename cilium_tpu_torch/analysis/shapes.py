"""shape-dtype: abstract shape/dtype interpretation of the device
surface — in the port, torch's rules.

Runs the dataflow interpreter over every device entry point (the same
entry discovery as ``jit-purity``: the kernel wrappers and their plain
versions, the device steps, ``torch.compile`` / ``torch.jit`` wraps)
with parameters seeded from the kernel-comment shape convention, and
flags what a CPU unit test at toy shapes cannot:

* **rank/shape mismatches** — a broadcast whose aligned extents are
  both known and provably unequal (neither 1), a matmul whose
  contraction extents disagree, a ``gather`` / ``take_along_dim``
  whose index rank differs from the operand's (torch requires equal
  ranks, and raises only when the call runs), a ``reshape`` / ``view``
  whose known element counts disagree;
* **overflow-prone integer accumulations** — torch accumulates an
  integer ``sum`` / ``cumsum`` / ``prod`` in int64 unless told
  otherwise (``torch.ones(4, dtype=torch.int32).sum()`` is int64), so
  the face the reference flags, an implicit narrow accumulator, does
  not exist here. What remains is an *explicit* narrow ``dtype=``
  (int32 or smaller) over an axis of unknown or large extent: the
  accumulator then wraps at payload scale;
* **weak-type wraps** — an int literal folded into a narrow-dtype
  tensor that cannot represent it: torch keeps the tensor's dtype for
  a Python scalar, so ``uint8_tensor + 1000`` wraps silently (to 176
  for 200).

Each premise is pinned by a test that runs torch on the CPU. Every
finding names the device entry it is reachable from. The bias is the
framework's: two *symbolic* extents that merely differ by name are
unknown-compatible, not findings.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from cilium_tpu_torch.analysis import dataflow
from cilium_tpu_torch.analysis.callgraph import ModuleInfo, Project
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker
from cilium_tpu_torch.analysis.dataflow import EventSink, Interp
from cilium_tpu_torch.analysis.purity import find_entries

RULE = "shape-dtype"

#: reductions that accumulate in the operand dtype (overflow surface)
_ACC_FNS = {"sum", "cumsum", "prod", "cumprod", "dot", "trace"}

#: narrow integer dtypes whose accumulator can wrap at batch scale
_NARROW_INTS = {"int8", "uint8", "int16", "uint16", "int32", "uint32"}

#: reduced extents below this are treated as structurally small
#: (bit-plane folds, probe grids) rather than batch/payload axes
_SMALL_EXTENT = 4096


def _fmt_dim(d) -> str:
    return "?" if d is None else str(d)


class _Sink(EventSink):
    """Collects shape/dtype events as findings for one entry walk.
    ``path`` per event: under the interprocedural walk an event lands
    in the CALLEE's file, not the entry's."""

    def __init__(self, entry: str):
        self.entry = entry
        self.findings: List[Finding] = []

    def _add(self, path: str, line: int, msg: str) -> None:
        self.findings.append(Finding(
            path, line, RULE,
            f"{msg} (reachable from device entry `{self.entry}`)"))

    def binop_conflict(self, path, line, op, a, b, conflict) -> None:
        da, db, axis = conflict
        self._add(path, line,
                  f"shape mismatch in `{op}`: {a.describe()} vs "
                  f"{b.describe()} — axis -{axis} has extents "
                  f"{_fmt_dim(da)} and {_fmt_dim(db)}, neither 1")

    def rank_mismatch(self, path, line, what, a, b) -> None:
        self._add(path, line,
                  f"`{what}` requires equal ranks: operand "
                  f"{a.describe()} (rank {a.rank}) vs indices "
                  f"{b.describe()} (rank {b.rank})")

    def matmul_conflict(self, path, line, a, b) -> None:
        self._add(path, line,
                  f"matmul contraction mismatch: {a.describe()} @ "
                  f"{b.describe()}")

    def reshape_mismatch(self, path, line, src, want) -> None:
        dims = ", ".join(_fmt_dim(d) for d in want)
        self._add(path, line,
                  f"reshape element-count mismatch: {src.describe()} "
                  f"cannot reshape to [{dims}]")

    def reduction(self, path, line, fn, operand, extent,
                  has_dtype, dtype=None) -> None:
        # torch promotes an implicit integer accumulator to int64:
        # only an explicit narrow dtype= can wrap
        if fn not in _ACC_FNS or dtype not in _NARROW_INTS:
            return
        if operand.dtype is not None and operand.dtype not in \
                _NARROW_INTS | {"bool"}:
            return
        if isinstance(extent, int) and extent < _SMALL_EXTENT:
            return
        ext = "unknown" if extent is None else str(extent)
        self._add(path, line,
                  f"int32-overflow-prone accumulation: `{fn}` over "
                  f"{operand.describe()} with an explicit "
                  f"dtype={dtype} — the accumulator is {dtype} over "
                  f"an axis of {ext} elements (torch would have "
                  f"promoted to int64 without it)")

    def weak_wrap(self, path, line, op, arr, value) -> None:
        self._add(path, line,
                  f"weak-type wrap: int literal {value} does not fit "
                  f"{arr.dtype} ({arr.describe()}) — torch keeps the "
                  f"tensor dtype for Python scalars, so this wraps "
                  f"silently")


def analyze_entry(project: Project, mi: ModuleInfo, fn: ast.AST,
                  entry_name: Optional[str] = None) -> List[Finding]:
    """Interpret one device entry; returns its shape-dtype findings."""
    name = entry_name or getattr(fn, "name", "<lambda>")
    sink = _Sink(name)
    interp = Interp(project, sink)
    env = dataflow.param_shapes(mi, fn)
    interp.run_function(mi, fn, env)
    return sink.findings


def entry_count(index: ProjectIndex) -> int:
    """How many device entries the analysis walks — the non-vacuity
    guard's hook."""
    return len(find_entries(Project(index)))


@checker
def check(index: ProjectIndex) -> List[Finding]:
    project = Project(index)
    findings: List[Finding] = []
    seen: set = set()
    for mi, fn in find_entries(project):
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        findings.extend(analyze_entry(project, mi, fn))
    # one finding per site: several entries reaching the same helper
    # line collapse to the first entry's attribution
    out = {}
    for f in sorted(set(findings)):
        out.setdefault((f.path, f.line, f.rule), f)
    return sorted(out.values())
check.emits = (RULE,)
