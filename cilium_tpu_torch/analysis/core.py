"""ctlint core: findings, the disable-comment allowlist, and the
project index every rule runs against.

The port's copy of the reference's linter (``cilium_tpu/analysis``),
pointed by default at the port's own tree. Every path or module a rule
names is written relative to ONE package: the top-level package of the
run's target (``ProjectIndex.package``). Pointed at ``cilium_tpu``, the
rules read the reference's tree the way the reference's rules do;
pointed at ``cilium_tpu_torch`` (the default), they read the port's.

The framework's correctness rests on invariants no unit test
enumerates — jitted kernels must stay pure, the threaded runtime must
acquire locks in one order, string registries (metric families, fault
points, stream frame kinds) must agree across producer and consumer
sites. ctlint machine-checks those contracts from the stdlib ``ast``
alone (zero dependencies — the lane must run in any environment that
can import the package), the same way Hyperflex's compiler enforces
the pattern↔kernel contract rather than trusting it (PAPERS.md).

Allowlisting: an INTENTIONAL violation carries an inline

    # ctlint: disable=rule-id[,rule-id]  # why it is safe

on the finding's line, or on a comment-only line directly above it.
A disable with no justification text after the rule list is itself a
finding (``bare-disable``) — the allowlist is an audit trail, not an
off switch.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import pickle
import re
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

#: repo-relative package directory ctlint analyzes by default
DEFAULT_TARGET = "cilium_tpu_torch"

#: CTLINT.json schema. 2 = adds schema_version + timings_ms (v2
#: dataflow families). 3 = findings may carry ``roots`` (the racing
#: concurrency roots a thread-safety finding names) and the report
#: carries ``wall_budget_ms``. 4 = findings may carry ``residency``
#: (the device-dataflow family's def-site chain proving the value
#: device-resident). Findings/count/suppressed/wall_budget_ms are
#: byte-stable for a clean tree; timings_ms is measured and varies
#: run to run.
SCHEMA_VERSION = 4

#: ``make lint`` wall-time budget (ms): 2× the v4 tree-wide warm
#: baseline (~20 s measured with the device-dataflow family; 18-22.5 s
#: across runs on the CI host). The CLI gate (--wall-budget-ms) fails
#: the lane if a full run exceeds it — rule families must stay cheap
#: enough for the pre-commit face.
WALL_BUDGET_MS = 40000

_DISABLE_RE = re.compile(
    r"#\s*ctlint:\s*disable=(?P<rules>[A-Za-z0-9_,\- ]+?)"
    r"(?:\s*#\s*(?P<why>.*))?$")


@dataclass(frozen=True, order=True)
class Finding:
    """One rule violation, anchored to a file:line."""

    path: str      # repo-relative
    line: int      # 1-based
    rule: str      # stable rule id (docs/ANALYSIS.md catalog)
    message: str
    #: the racing concurrency roots (thread-safety family) — empty
    #: for rules where the concept does not apply
    roots: Tuple[str, ...] = ()
    #: residency provenance (device-dataflow family): the ``path:line
    #: what`` def-site chain that made the flagged value
    #: device-resident — empty for rules where it does not apply
    residency: Tuple[str, ...] = ()

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> Dict:
        d = {"path": self.path, "line": self.line,
             "rule": self.rule, "message": self.message}
        if self.roots:
            d["roots"] = list(self.roots)
        if self.residency:
            d["residency"] = list(self.residency)
        return d


class SourceFile:
    """One parsed module: source, AST, and its disable allowlist."""

    def __init__(self, path: str, module: str, source: str,
                 tree: Optional[ast.AST] = None):
        self.path = path          # repo-relative
        self.module = module      # dotted module name
        self.source = source
        self.tree = tree if tree is not None \
            else ast.parse(source, filename=path)
        self.lines = source.splitlines()
        #: line (1-based) → set of disabled rule ids on that line
        self.disables: Dict[int, set] = {}
        #: disable comments with no justification → bare-disable finding
        self.bare_disables: List[int] = []
        self._scan_disables()

    def _scan_disables(self) -> None:
        for i, text in enumerate(self.lines, 1):
            m = _DISABLE_RE.search(text)
            if m is None:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")
                     if r.strip()}
            if not (m.group("why") or "").strip():
                self.bare_disables.append(i)
            self.disables.setdefault(i, set()).update(rules)
            # a comment-only line covers the next line of code, so a
            # long statement can carry its allowlist above itself
            if text[:m.start()].strip() == "":
                self.disables.setdefault(i + 1, set()).update(rules)

    def disabled(self, line: int, rule: str) -> bool:
        return rule in self.disables.get(line, ())


class ProjectIndex:
    """Every analyzed module, parsed once and shared by all rules."""

    def __init__(self, files: Dict[str, SourceFile],
                 root: Optional[str] = None,
                 package: Optional[str] = None):
        #: dotted module name → SourceFile
        self.files = files
        self.by_path = {f.path: f for f in files.values()}
        #: repo root when indexed from a tree (None for in-memory
        #: corpora) — rules that read non-Python surfaces (C++ ABI,
        #: docs) anchor here
        self.root = root
        #: the top-level package every rule's paths and modules are
        #: relative to (``cilium_tpu_torch`` for the port's tree)
        self.package = package or infer_package(self.by_path)

    def mod(self, suffix: str = "") -> str:
        """``runtime.metrics`` → ``<package>.runtime.metrics``."""
        return f"{self.package}.{suffix}" if suffix else self.package

    def rel(self, suffix: str) -> str:
        """``runtime/`` → ``<package>/runtime/`` (a repo-relative path
        or path prefix)."""
        return f"{self.package}/{suffix}"

    @classmethod
    def from_tree(cls, root: str,
                  targets: Sequence[str] = (DEFAULT_TARGET,),
                  jobs: Optional[int] = None
                  ) -> Tuple["ProjectIndex", List[Finding]]:
        """Index ``targets`` (repo-relative dirs/files) under ``root``.
        Unparseable files become findings, not crashes — a linter that
        dies on a syntax error hides every other finding. Files are
        read and hashed on a thread pool; a per-content-hash AST cache
        under ``<root>/.ctlint_cache/`` skips re-parsing unchanged
        files across runs (ast.parse dominates a warm lint run)."""
        paths: List[Tuple[str, str]] = []   # (rel, full)
        for target in targets:
            full = os.path.join(root, target)
            if os.path.isfile(full):
                paths.append((target, full))
                continue
            for dirpath, _dirnames, filenames in sorted(os.walk(full)):
                for name in sorted(filenames):
                    if not name.endswith(".py"):
                        continue
                    path = os.path.join(dirpath, name)
                    paths.append((os.path.relpath(path, root), path))
        cache = _AstCache(root)
        with ThreadPoolExecutor(max_workers=min(8, max(1, len(paths)))
                                ) as pool:
            sources = dict(pool.map(
                lambda rf: (rf[0], _read(rf[1])), paths))
        index, errors = cls.from_sources(
            sources, root=root, cache=cache,
            package=infer_package(targets))
        cache.flush()
        return index, errors

    @classmethod
    def from_sources(cls, sources: Dict[str, str],
                     root: Optional[str] = None,
                     cache: Optional["_AstCache"] = None,
                     package: Optional[str] = None
                     ) -> Tuple["ProjectIndex", List[Finding]]:
        """Build from ``{repo-relative path: source}`` — the test
        corpus face: rules run against in-memory snippets exactly as
        they run against the tree. ``package`` defaults to the
        sources' own top-level directory (:func:`infer_package`)."""
        files: Dict[str, SourceFile] = {}
        errors: List[Finding] = []
        for rel, source in sorted(sources.items()):
            module = _module_name(rel)
            try:
                tree = cache.tree_for(rel, source) if cache else None
                files[module] = SourceFile(rel, module, source,
                                           tree=tree)
                if cache is not None:
                    cache.store(rel, source, files[module].tree)
            except SyntaxError as e:
                errors.append(Finding(rel, e.lineno or 1, "parse-error",
                                      f"cannot parse: {e.msg}"))
        return cls(files, root=root,
                   package=package or infer_package(sources)), errors

    def get(self, module: str) -> Optional[SourceFile]:
        return self.files.get(module)


class _AstCache:
    """Content-hash → pickled-AST cache (one file per lint run, not
    per module — a single read/write beats 250 tiny files). A stale
    or unreadable cache is ignored wholesale; the format is an
    implementation detail keyed on the pickle protocol."""

    NAME = ".ctlint_cache/ast.pkl"

    def __init__(self, root: Optional[str]):
        self.path = os.path.join(root, self.NAME) if root else None
        self._old: Dict[str, bytes] = {}
        self._new: Dict[str, bytes] = {}
        self._dirty = False
        if self.path and os.path.exists(self.path):
            try:
                with open(self.path, "rb") as f:
                    self._old = pickle.load(f)
            except Exception:
                self._old = {}

    @staticmethod
    def _key(source: str) -> str:
        return hashlib.sha256(source.encode("utf-8")).hexdigest()

    def tree_for(self, rel: str, source: str) -> Optional[ast.AST]:
        blob = self._old.get(self._key(source))
        if blob is None:
            return None
        try:
            return pickle.loads(blob)
        except Exception:
            return None

    def store(self, rel: str, source: str, tree: ast.AST) -> None:
        key = self._key(source)
        blob = self._old.get(key)
        if blob is None:
            try:
                blob = pickle.dumps(tree, protocol=4)
            except Exception:
                return
            self._dirty = True
        self._new[key] = blob

    def flush(self) -> None:
        if self.path is None:
            return
        if not self._dirty and set(self._new) == set(self._old):
            return
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(self._new, f, protocol=4)
            os.replace(tmp, self.path)
        except OSError:
            pass  # cache is best-effort; the lint result is identical


def infer_package(paths) -> str:
    """The top-level package of repo-relative ``paths`` (targets or
    source paths): the first directory most of them share, else
    :data:`DEFAULT_TARGET` (a lone top-level file has no package)."""
    counts: Dict[str, int] = {}
    for p in paths:
        head, sep, _ = p.replace(os.sep, "/").strip("/").partition("/")
        if sep or not head.endswith(".py"):
            if head and head not in (".", ".."):
                counts[head] = counts.get(head, 0) + 1
    if not counts:
        return DEFAULT_TARGET
    return min(counts, key=lambda h: (-counts[h], h))


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def _module_name(rel_path: str) -> str:
    mod = rel_path[:-3] if rel_path.endswith(".py") else rel_path
    mod = mod.replace(os.sep, ".").replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[: -len(".__init__")]
    return mod


# -- rule registry ----------------------------------------------------------

#: rule id → one-line description (the docs/ANALYSIS.md catalog source)
RULES: Dict[str, str] = {
    "jit-purity": "no host effects (clock, RNG, I/O, locks, host "
                  "syncs, traced-value branching) reachable from a "
                  "jitted/pallas entry point",
    "lock-order": "the static lock-acquisition graph of the threaded "
                  "runtime has no cycles and no nested re-acquire of "
                  "a non-reentrant lock",
    "metric-registry": "every metric name is declared once in "
                       "runtime/metrics.py, Prometheus-legal, and "
                       "used with exactly one instrument kind",
    "fault-registry": "every faults.maybe_fail seam names a "
                      "register_point'd point; every point has a seam",
    "frame-kind": "every KIND_* stream frame constant is handled in "
                  "both server and client dispatch",
    "swallowed-exception": "no bare except, and no except "
                           "Exception whose body only passes",
    "unused-import": "no unused module-level imports (outside "
                     "__init__ re-export surfaces)",
    "shape-dtype": "abstract shape/dtype interpretation of every "
                   "jitted entry: provable broadcast/matmul/reshape "
                   "mismatches, overflow-prone narrow-int "
                   "accumulations, weak-type wraps",
    "recompile-hazard": "jit cache-key churn: per-call wrapper "
                        "construction, shape-dependent Python "
                        "branching, config scalars fixing shapes "
                        "under trace",
    "abi-surface": "extern \"C\" signatures diffed bidirectionally "
                   "against every ctypes argtypes/restype/call in "
                   "the package and test/bench surfaces",
    "config-surface": "Config field ⇄ TOML key ⇄ CILIUM_TPU_* env "
                      "var ⇄ docs mention, four-way parity",
    "unbounded-queue": "no queue.Queue() without maxsize and no "
                       "list-as-queue append without a bound/shed "
                       "path in threaded runtime modules",
    "unbounded-registry": "no dict/set registry in long-lived "
                          "runtime/engine/policy modules inserted "
                          "into on an event path without an "
                          "eviction, bound, or TTL",
    "pallas-block-shape": "pallas_call block shapes align to the "
                          "(8, 128) TPU tile where literally provable, "
                          "and every matmul inside a pallas kernel "
                          "pins preferred_element_type",
    "obs-doc-parity": "every metric family declared in "
                      "runtime/metrics.py and every phase label "
                      "(tracing PHASE_*, engine-probe phases, capture "
                      "staging phases) is documented in "
                      "docs/OBSERVABILITY.md, and the doc names no "
                      "family that no longer exists",
    "thread-safety": "guarded-field inference + atomicity over the "
                     "serving plane: mutations/compound reads of an "
                     "inferred-guarded attribute outside its guard, "
                     "check-then-act after lock release, lock-release "
                     "windows in read-modify-write sequences, unsafe "
                     "publication from __init__ — each finding names "
                     "the racing concurrency roots",
    "wall-clock": "behavioral time (time.time/monotonic/sleep) in "
                  "serving-plane modules routes through the injected "
                  "Clock (runtime/simclock.py); real-world reads "
                  "carry a justified disable",
    "frontend-registry": "every proxylib register_parser name has an "
                         "engine frontend or a justified proxy-only "
                         "pragma, and every frontend's family appears "
                         "in the L7Type / memo / attribution family "
                         "enums",
    "implicit-sync": "no device-resident value is coerced to host "
                     "(float()/int()/bool(), .item()/.tolist(), "
                     "truthiness branching; np.asarray/device_get/"
                     "block_until_ready inside a loop) on a serving "
                     "hot path — each finding names the hot root and "
                     "carries the residency chain",
    "hot-loop-h2d": "no per-iteration host→device transfer "
                    "(device_put / jnp.asarray of host data) inside "
                    "a loop on a hot path; staging into instance "
                    "state (the prefetch/double-buffer idiom) is "
                    "exempt",
    "missing-donation": "every jitted step that overwrites a device "
                        "buffer it also takes as input "
                        "(.at[].set / dynamic_update_slice on a "
                        "parameter) donates that argument",
    "readback-ordering": "no host readback of one dispatch's result "
                         "before an independent later dispatch is "
                         "issued — reordering restores the "
                         "dispatch pipeline",
    "bare-disable": "every ctlint disable comment carries a "
                    "justification",
    "parse-error": "every analyzed file parses",
}

#: checker callables; each may emit findings for several rule ids.
#: A checker may declare the rule ids it can emit by setting
#: ``check.emits = ("rule-a", ...)`` after definition; ``run()`` then
#: skips it entirely when a ``--rules`` filter selects none of them
#: (the pre-commit face pays for the families it asks for, not the
#: whole catalog). The declaration is an optimization, never a
#: correctness gate: findings are still post-filtered by rule id, so
#: an undeclared checker simply always runs.
CHECKERS: List[Callable[[ProjectIndex], List[Finding]]] = []


def checker(fn: Callable[[ProjectIndex], List[Finding]]):
    CHECKERS.append(fn)
    return fn


def _bare_disable_findings(index: ProjectIndex) -> List[Finding]:
    out = []
    for f in index.files.values():
        for line in f.bare_disables:
            out.append(Finding(
                f.path, line, "bare-disable",
                "ctlint disable without a justification comment "
                "(write `# ctlint: disable=RULE  # why`)"))
    return out


#: per-rule wall time of the last run() (milliseconds) — rendered
#: into CTLINT.json as ``timings_ms``; measured, so NOT byte-stable
LAST_TIMINGS: Dict[str, float] = {}


def run(root: str, targets: Sequence[str] = (DEFAULT_TARGET,),
        rules: Optional[Sequence[str]] = None,
        only_paths: Optional[Sequence[str]] = None
        ) -> Tuple[List[Finding], int]:
    """Run all checkers; returns (active findings, suppressed count).
    ``rules`` filters to a subset of rule ids. ``only_paths`` (the
    ``--changed-only`` face) restricts the REPORTED findings to those
    repo-relative paths — the whole tree is still indexed, because
    every interesting rule here is cross-file."""
    # rule modules register their checkers on import
    from cilium_tpu_torch.analysis import (  # noqa: F401
        abi,
        configsurface,
        devicedataflow,
        exceptions,
        frontendreg,
        imports,
        locks,
        obsdocs,
        pallas_shapes,
        purity,
        queues,
        recompile,
        registry,
        shapes,
        threadsafety,
        unboundedreg,
        wallclock,
    )

    LAST_TIMINGS.clear()
    t_run = time.monotonic()
    index, findings = ProjectIndex.from_tree(root, targets)
    LAST_TIMINGS["parse"] = (time.monotonic() - t_run) * 1000.0

    # checkers are independent of each other (shared state — the
    # callgraph Project and lock analyzer — is built behind memo
    # locks), so they run on a thread pool; findings are collected
    # in registration order, so the report stays deterministic.
    # Per-rule timings_ms are each checker's own wall time and
    # overlap under the GIL — their sum exceeds the ``wall`` key.
    # Two workers measured fastest on the real tree (14.4s vs 15.3s
    # serial / 17.9s at 8): checkers are mostly pure-Python and the
    # GIL turns wider pools into convoy overhead, while one extra
    # worker still overlaps the C-level ast/IO slices.
    def _timed(check):
        t0 = time.monotonic()
        found = check(index)
        return found, (time.monotonic() - t0) * 1000.0

    wanted_rules = set(rules) if rules else None

    def _selected(check) -> bool:
        if wanted_rules is None:
            return True
        emits = getattr(check, "emits", None)
        # no declaration -> always run (findings post-filter below)
        return emits is None or bool(wanted_rules & set(emits))

    selected = [c for c in CHECKERS if _selected(c)]
    with ThreadPoolExecutor(
            max_workers=min(2, max(1, len(selected) or 1))) as pool:
        futures = [(check, pool.submit(_timed, check))
                   for check in selected]
        for check, fut in futures:
            found, ms = fut.result()
            label = check.__module__.rsplit(".", 1)[-1]
            LAST_TIMINGS[label] = LAST_TIMINGS.get(label, 0.0) + ms
            findings.extend(found)
    findings.extend(_bare_disable_findings(index))
    LAST_TIMINGS["wall"] = (time.monotonic() - t_run) * 1000.0
    if rules:
        wanted = set(rules)
        findings = [f for f in findings if f.rule in wanted]
    if only_paths is not None:
        wanted_paths = set(only_paths)
        findings = [f for f in findings if f.path in wanted_paths]
    active: List[Finding] = []
    suppressed = 0
    for f in sorted(set(findings)):
        sf = index.by_path.get(f.path)
        if sf is not None and sf.disabled(f.line, f.rule):
            suppressed += 1
            continue
        active.append(f)
    return active, suppressed


def render_text(findings: Sequence[Finding], suppressed: int) -> str:
    lines = [f.format() for f in findings]
    lines.append(f"ctlint: {len(findings)} finding(s), "
                 f"{suppressed} allowlisted")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding], suppressed: int,
                timings: Optional[Dict[str, float]] = None) -> str:
    """The CTLINT.json report. Everything except ``timings_ms`` is
    deterministic for a given tree (sorted findings, fixed key
    order); ``timings_ms`` is measured wall time per rule module and
    varies run to run — stability tests must compare around it."""
    report = {
        "schema_version": SCHEMA_VERSION,
        "findings": [f.as_dict() for f in findings],
        "count": len(findings),
        "suppressed": suppressed,
        "wall_budget_ms": WALL_BUDGET_MS,
    }
    if timings is None:
        timings = LAST_TIMINGS
    if timings:
        report["timings_ms"] = {k: round(v, 3)
                                for k, v in sorted(timings.items())}
    return json.dumps(report, indent=2)
