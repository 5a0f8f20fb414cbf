"""The port's ctlint (``cilium_tpu_torch/analysis``) against the
reference's (``cilium_tpu/analysis``): the sixteen framework-agnostic
rules, on the reference tests' corpora and on the reference's own tree,
and the port's lint CLI.

Every corpus runs through both packages' checkers over each package's
``ProjectIndex.from_sources``; the finding lists must be identical
(path, line, rule, roots, message). Corpora placed under
``cilium_tpu/`` run a second time placed under ``cilium_tpu_torch/``
through the port (its rules take the package from the sources), and
must give the same findings with the package name swapped. The
corpora are the reference tests' own strings (``tests/test_ctlint.py``)
and its ``tests/analysis_corpus/race_*.py`` files, read in place. The
reference's tree is linted once for the module, by both packages.
"""

import collections
import importlib
import json
import os
import subprocess

import pytest

import test_ctlint as REF_TESTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_DIR = os.path.join(REPO, "tests", "analysis_corpus")
PKGS = ("cilium_tpu", "cilium_tpu_torch")

#: the rule ids whose contract does not depend on the framework
AGNOSTIC = ("lock-order", "metric-registry", "fault-registry",
            "frame-kind", "swallowed-exception", "unused-import",
            "abi-surface", "config-surface", "unbounded-queue",
            "unbounded-registry", "obs-doc-parity", "thread-safety",
            "wall-clock", "frontend-registry", "bare-disable",
            "parse-error")

#: the rule modules of those rules (``module.function``)
AGNOSTIC_MODULES = ("abi", "configsurface", "exceptions", "frontendreg",
                    "imports", "locks", "obsdocs", "queues", "registry",
                    "threadsafety", "unboundedreg", "wallclock")


def analysis(pkg, module=None):
    name = f"{pkg}.analysis" + (f".{module}" if module else "")
    return importlib.import_module(name)


def corpus(name):
    with open(os.path.join(CORPUS_DIR, name)) as fp:
        return fp.read()


def as_port(text):
    return text.replace("cilium_tpu_torch", "cilium_tpu") \
        .replace("cilium_tpu", "cilium_tpu_torch")


def as_ref(text):
    return text.replace("cilium_tpu_torch", "cilium_tpu")


def findings_of(pkg, sources, target, **kw):
    """``target`` (``module.function``) of ``pkg`` over ``sources``, the
    disable filter applied as ``core.run`` applies it → comparable
    tuples, the package name written as the reference's."""
    core = analysis(pkg, "core")
    module, fn = target.split(".")
    index, errors = core.ProjectIndex.from_sources(sources)
    out = [("parse-error", e.path, e.line, e.message) for e in errors]
    for f in getattr(analysis(pkg, module), fn)(index, **kw):
        sf = index.by_path.get(f.path)
        if sf is not None and sf.disabled(f.line, f.rule):
            continue
        out.append((f.rule, as_ref(f.path), f.line,
                    tuple(as_ref(r) for r in f.roots),
                    as_ref(f.message)))
    return sorted(out)


# -- the reference tests' corpora ---------------------------------------------

R = REF_TESTS
_SWALLOWED = (
    "def f():\n    try:\n        g()\n    except Exception:\n"
    "        pass\ndef h():\n    try:\n        g()\n    except:\n"
    "        return 1\ndef ok():\n    try:\n        g()\n"
    "    except ValueError:\n        pass\n")
_FAULT_DEFS = ("def register_point(n, d=''):\n    return n\n"
               "def maybe_fail(p):\n    pass\n")
_CFG_GOOD = R.CFG_SRC.replace(
    "            cfg.enabel = True", "            cfg.enable = True"
).replace("    ghost_knob: int = 0\n", "").replace(
    '        if "stale_key" in data:\n'
    '            cfg.enable = data["stale_key"]\n',
    '        if "enable" in data:\n'
    '            cfg.enable = data["enable"]\n')
_QUEUE_SINGLE = R.QUEUE_BAD.replace("import threading\n", "").replace(
    "self._t = threading.Thread(target=self._run)\n"
    "        self._t.start()", "pass")
_QUEUE_PRAGMA = R.QUEUE_BAD.replace(
    "        self._pending.append(item)",
    "        # ctlint: disable=unbounded-queue  # test-only log\n"
    "        self._pending.append(item)").replace(
    "        self.q = queue.Queue()",
    "        # ctlint: disable=unbounded-queue  # drained inline\n"
    "        self.q = queue.Queue()")
_UREG_PRAGMA = R.UREG_BAD.replace(
    "    SEEN[key] = value",
    "    # ctlint: disable=unbounded-registry  # bounded upstream\n"
    "    SEEN[key] = value").replace(
    "        self._by_key[key] = value",
    "        # ctlint: disable=unbounded-registry  # test corpus\n"
    "        self._by_key[key] = value").replace(
    "        self._members.add(key)",
    "        # ctlint: disable=unbounded-registry  # test corpus\n"
    "        self._members.add(key)")
_UREG_INIT = ("class Warm:\n    def __init__(self, pairs):\n"
              "        self._by_key = {}\n        for k, v in pairs:\n"
              "            self._by_key[k] = v\n")
_WC_PRAGMA = R.WALLCLOCK_BAD.replace(
    "        self.opened_at = time.monotonic()",
    "        # ctlint: disable=wall-clock  # capture stamp of the real "
    "world\n        self.opened_at = time.monotonic()")
_WC_ALIAS = "\nfrom time import sleep\n\n\ndef retry():\n    sleep(1.0)\n"
_TS_PRAGMA = corpus("race_publication_bad.py").replace(
    "        self._pending = {}",
    "        # ctlint: disable=thread-safety  # corpus fixture\n"
    "        self._pending = {}")
_ABI_DRIFT = ("import ctypes\nlib = ctypes.CDLL('x.so')\n"
              "lib.cshim_ping.argtypes = [ctypes.c_uint32, ctypes.c_void_p,\n"
              "                           ctypes.c_double]\n")
_ABI_CPP_ALLOW = ("extern \"C\" {\n// ctlint: disable=abi-surface  # consumed "
                  "by Envoy, not Python\nvoid cshim_proxy_only() {}\n}\n")
_OBS_STAGE = dict(R.OBS_SOURCES, **{
    "cilium_tpu/engine/verdict.py": (
        "class _StagePhase:\n    def __init__(self, phase):\n"
        "        self.phase = phase\n\n\ndef stage():\n"
        "    with _StagePhase(\"tables\"):\n        pass\n")})
_FEREG_LOOSE = R.FEREG_PARSERS + "register_parser('loose', P)\n"
_FEREG_LOOSE_OK = R.FEREG_PARSERS + (
    "register_parser('loose', P)  # ctlint: disable=frontend-registry"
    "  # proxy-only fixture\n")
_FRAME_SITES = (("pkg.proto", "Server", ("_work",)),
                ("pkg.proto", "Client", ("_recv",)))


def _race(name):
    return {f"cilium_tpu/runtime/{name}": corpus(name)}


#: (id, sources, ``module.function``, keyword arguments)
CASES = [
    ("lock-cycle", {"pkg/m.py": R.LOCKS_CYCLE}, "locks.check", {}),
    ("lock-self-deadlock", {"pkg/m.py": R.LOCKS_SELF_DEADLOCK},
     "locks.check", {}),
    ("lock-rlock", {"pkg/m.py": R.LOCKS_GOOD}, "locks.check", {}),
    ("metric-bad", {"pkg/decl.py": R.METRICS_DECL,
                    "pkg/use.py": R.METRICS_BAD},
     "registry.check_metrics", {"decl_module": "pkg.decl"}),
    ("metric-good", {"pkg/decl.py": R.METRICS_DECL,
                     "pkg/use.py": R.METRICS_GOOD},
     "registry.check_metrics", {"decl_module": "pkg.decl"}),
    ("fault-drift", {"pkg/faults.py": _FAULT_DEFS,
                     "pkg/seams.py": R.FAULTS_BAD},
     "registry.check_faults", {"faults_module": "pkg.faults"}),
    ("frame-gap", {"pkg/proto.py": R.FRAMES_BAD}, "registry.check_frames",
     {"defs_module": "pkg.proto", "sites": _FRAME_SITES}),
    ("frame-duplicate", {"pkg/proto.py": "KIND_A = 0\nKIND_B = 0\n"},
     "registry.check_frames", {"defs_module": "pkg.proto", "sites": ()}),
    ("swallowed", {"pkg/m.py": _SWALLOWED}, "exceptions.check", {}),
    ("swallowed-pragma", {"pkg/m.py": (
        "def f():\n    try:\n        g()\n"
        "    # ctlint: disable=swallowed-exception  # test fixture\n"
        "    except Exception:\n        pass\n")}, "exceptions.check", {}),
    ("unused-import", {"pkg/m.py": "import os\nimport sys\n\n"
                                   "print(sys.argv)\n"},
     "imports.check", {}),
    ("unused-import-init", {"pkg/__init__.py": "import os\n"},
     "imports.check", {}),
    ("abi-bad", {"pkg/bind.py": R.ABI_BAD_PY}, "abi.check_abi",
     {"cpp_sources": {"shim/x.cpp": R.ABI_CPP}}),
    ("abi-good", {"pkg/bind.py": R.ABI_GOOD_PY}, "abi.check_abi",
     {"cpp_sources": {"shim/x.cpp": R.ABI_CPP}}),
    ("abi-drift", {"pkg/bind.py": _ABI_DRIFT}, "abi.check_abi",
     {"cpp_sources": {"shim/x.cpp": R.ABI_CPP}}),
    ("abi-cpp-allow", {}, "abi.check_abi",
     {"cpp_sources": {"shim/x.cpp": _ABI_CPP_ALLOW}, "extra_py": {}}),
    ("config-bad", {"pkg/core/config.py": R.CFG_SRC,
                    "pkg/use.py": R.CFG_USER}, "configsurface.check_config",
     {"config_module": "pkg.core.config",
      "docs": {"docs/CONFIG.md": "`enable` `engine` `bank_size` "
                                 "CILIUM_TPU_ENABLE CILIUM_TPU_TYPO "
                                 "CILIUM_TPU_STALE_DOC_VAR"}}),
    ("config-good", {"pkg/core/config.py": _CFG_GOOD,
                     "pkg/use.py": R.CFG_USER}, "configsurface.check_config",
     {"config_module": "pkg.core.config", "docs": R.CFG_DOCS_FULL}),
    ("queue-bad", {"pkg/pipe.py": R.QUEUE_BAD}, "queues.check", {}),
    ("queue-good", {"pkg/pipe.py": R.QUEUE_GOOD}, "queues.check", {}),
    ("queue-single-threaded", {"pkg/single.py": _QUEUE_SINGLE},
     "queues.check", {}),
    ("queue-from-import", {"pkg/q.py": "from queue import Queue\n"
                                       "import threading\n\n\n"
                                       "def build():\n    return Queue()\n"},
     "queues.check", {}),
    ("queue-priority", {"pkg/q2.py": "import queue\nimport threading\n\n\n"
                                     "def build():\n"
                                     "    return queue.PriorityQueue()\n"},
     "queues.check", {}),
    ("queue-pragma", {"pkg/pipe.py": _QUEUE_PRAGMA}, "queues.check", {}),
    ("ureg-bad", {"cilium_tpu/runtime/reg.py": R.UREG_BAD},
     "unboundedreg.check", {}),
    ("ureg-good", {"cilium_tpu/runtime/reg.py": R.UREG_GOOD},
     "unboundedreg.check", {}),
    ("ureg-out-of-scope", {"cilium_tpu/ingest/reg.py": R.UREG_BAD},
     "unboundedreg.check", {}),
    ("ureg-engine", {"cilium_tpu/engine/reg.py": R.UREG_BAD},
     "unboundedreg.check", {}),
    ("ureg-policy", {"cilium_tpu/policy/compiler/reg.py": R.UREG_BAD},
     "unboundedreg.check", {}),
    ("ureg-init", {"cilium_tpu/runtime/w.py": _UREG_INIT},
     "unboundedreg.check", {}),
    ("ureg-pragma", {"cilium_tpu/runtime/reg.py": _UREG_PRAGMA},
     "unboundedreg.check", {}),
    ("obs-complete", R.OBS_SOURCES, "obsdocs.check_obs_docs",
     {"doc_text": R.OBS_DOC_COMPLETE}),
    ("obs-undocumented", R.OBS_SOURCES, "obsdocs.check_obs_docs",
     {"doc_text": "only `cilium_tpu_foo_total` and queue-wait, mapstate, "
                  "dfa-scan, gather documented"}),
    ("obs-stale", R.OBS_SOURCES, "obsdocs.check_obs_docs",
     {"doc_text": R.OBS_DOC_COMPLETE
      + "\nand the long-gone `cilium_tpu_ghost_total` series\n"}),
    ("obs-derived", R.OBS_SOURCES, "obsdocs.check_obs_docs",
     {"doc_text": R.OBS_DOC_COMPLETE + "\nhistogram faces: "
      "cilium_tpu_bar_seconds_bucket and cilium_tpu_bar_seconds_count\n"}),
    ("obs-stage-phase", _OBS_STAGE, "obsdocs.check_obs_docs",
     {"doc_text": R.OBS_DOC_COMPLETE.replace(", tables", "")}),
    ("reason-complete", R.REASON_SOURCES, "obsdocs.check_obs_docs",
     {"doc_text": R.REASON_DOC}),
    ("reason-undocumented", R.REASON_SOURCES, "obsdocs.check_obs_docs",
     {"doc_text": R.REASON_DOC.replace(
         "| `miss` | fetches | not present |\n", "")}),
    ("reason-stale", R.REASON_SOURCES, "obsdocs.check_obs_docs",
     {"doc_text": R.REASON_DOC.replace(
         "| `miss` | fetches | not present |",
         "| `miss` | fetches | not present |\n"
         "| `long-gone` | shed | retired reason |")}),
    ("reason-prose", R.REASON_SOURCES, "obsdocs.check_obs_docs",
     {"doc_text": R.REASON_DOC + "\nprose about a `zap` label value\n"}),
    ("wall-clock-bad", {"cilium_tpu/runtime/breaker.py": R.WALLCLOCK_BAD},
     "wallclock.check", {}),
    ("wall-clock-good", {"cilium_tpu/runtime/breaker.py":
                         R.WALLCLOCK_GOOD}, "wallclock.check", {}),
    ("wall-clock-analysis", {"cilium_tpu/analysis/timing.py":
                             R.WALLCLOCK_BAD}, "wallclock.check", {}),
    ("wall-clock-cli", {"cilium_tpu/cli.py": R.WALLCLOCK_BAD},
     "wallclock.check", {}),
    ("wall-clock-seam", {"cilium_tpu/runtime/simclock.py":
                         R.WALLCLOCK_BAD}, "wallclock.check", {}),
    ("wall-clock-pragma", {"cilium_tpu/runtime/breaker.py": _WC_PRAGMA},
     "wallclock.check", {}),
    ("wall-clock-alias", {"cilium_tpu/runtime/retry.py": _WC_ALIAS},
     "wallclock.check", {}),
    ("fereg-good", R._fereg_corpus(),
     "frontendreg.check_frontend_registry", {}),
    ("fereg-loose", R._fereg_corpus(**{
        "cilium_tpu/proxylib/cass.py": _FEREG_LOOSE}),
     "frontendreg.check_frontend_registry", {}),
    ("fereg-loose-pragma", R._fereg_corpus(**{
        "cilium_tpu/proxylib/cass.py": _FEREG_LOOSE_OK}),
     "frontendreg.check_frontend_registry", {}),
    ("fereg-memo", R._fereg_corpus(**{
        "cilium_tpu/engine/memo.py": R.FEREG_MEMO.replace(
            ', 5: "cass"', "")}),
     "frontendreg.check_frontend_registry", {}),
    ("fereg-attribution", R._fereg_corpus(**{
        "cilium_tpu/engine/attribution.py":
            'from cilium_tpu.core.flow import L7Type\n'
            'FAMILY_NAMES = {int(L7Type.HTTP): "http"}\n'}),
     "frontendreg.check_frontend_registry", {}),
    ("fereg-l7type", R._fereg_corpus(**{
        "cilium_tpu/core/flow.py": R.FEREG_FLOW.replace(
            "    CASS = 5\n", "")}),
     "frontendreg.check_frontend_registry", {}),
    ("fereg-no-parser", R._fereg_corpus(**{
        "cilium_tpu/proxylib/cass.py": "x = 1\n"}),
     "frontendreg.check_frontend_registry", {}),
    ("ts-out-of-scope", {"cilium_tpu/hubble/race_counter_bad.py":
                         corpus("race_counter_bad.py")},
     "threadsafety.check", {}),
    ("ts-scope-override", {"cilium_tpu/hubble/race_counter_bad.py":
                           corpus("race_counter_bad.py")},
     "threadsafety.check", {"scope": ("cilium_tpu/hubble/",)}),
    ("ts-pragma", {"cilium_tpu/runtime/race_publication_bad.py":
                   _TS_PRAGMA}, "threadsafety.check", {}),
    ("parse-error", {"pkg/m.py": "def f(:\n    pass\n"},
     "imports.check", {}),
] + [(f"ts-{name[:-3]}", _race(name), "threadsafety.check", {})
     for name in sorted(os.listdir(CORPUS_DIR))
     if name.startswith("race_") and name.endswith(".py")]

#: the cases that must find something (the bad corpora): a vacuous
#: pair of empty lists would prove nothing
NONEMPTY = {"lock-cycle", "lock-self-deadlock", "metric-bad",
            "fault-drift", "frame-gap", "frame-duplicate", "swallowed",
            "unused-import", "abi-bad", "abi-drift", "config-bad",
            "queue-bad", "queue-from-import", "queue-priority", "ureg-bad",
            "ureg-engine", "ureg-policy", "obs-undocumented", "obs-stale",
            "obs-stage-phase", "reason-undocumented", "reason-stale",
            "wall-clock-bad", "wall-clock-pragma", "wall-clock-alias",
            "fereg-loose", "fereg-memo", "fereg-attribution",
            "fereg-l7type", "fereg-no-parser", "ts-scope-override",
            "parse-error", "ts-race_counter_bad", "ts-race_dispatch_bad",
            "ts-race_lease_act_bad", "ts-race_publication_bad",
            "ts-race_reinsert_bad"}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_agnostic_rules_equal_the_reference_on_its_corpora(case):
    name, sources, target, kw = case
    ref, port = (findings_of(p, sources, target, **kw) for p in PKGS)
    assert port == ref
    assert bool(port) == (name in NONEMPTY), port


PORT_CASES = [c for c in CASES
              if any(p.startswith("cilium_tpu/") for p in c[1])]


def _ported(value):
    if isinstance(value, str):
        return as_port(value)
    if isinstance(value, dict):
        return {_ported(k): _ported(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(_ported(v) for v in value)
    return value


@pytest.mark.parametrize("case", PORT_CASES, ids=[c[0] for c in PORT_CASES])
def test_agnostic_rules_read_the_port_package_as_the_reference_its_own(case):
    """The same corpus placed under ``cilium_tpu_torch/`` (its imports
    too): the port's rules, given the port's package by the sources,
    find what the reference's find under ``cilium_tpu/``."""
    _name, sources, target, kw = case
    ref = findings_of("cilium_tpu", sources, target, **kw)
    port = findings_of("cilium_tpu_torch", _ported(sources), target,
                       **_ported(kw))
    assert port == ref


def test_bare_disable_equals_the_reference():
    src = "import os  # ctlint: disable=unused-import\n"
    got = []
    for pkg in PKGS:
        core = analysis(pkg, "core")
        index, _ = core.ProjectIndex.from_sources({"pkg/m.py": src})
        got.append([(f.path, f.line, f.rule, f.message)
                    for f in core._bare_disable_findings(index)])
    assert got[0] == got[1] and len(got[1]) == 1
    assert got[1][0][2] == "bare-disable"


def test_rule_catalog_and_schema_are_the_reference_s():
    """All 24 rule ids, with the reference's catalog text, and schema
    4 — so ``--rule``, the precommit set and ``--list-rules`` behave
    as the reference's."""
    ref, port = (analysis(p, "core") for p in PKGS)
    assert sorted(port.RULES) == sorted(ref.RULES) and len(port.RULES) == 24
    assert set(AGNOSTIC) <= set(port.RULES)
    assert port.SCHEMA_VERSION == ref.SCHEMA_VERSION == 4
    assert port.WALL_BUDGET_MS == ref.WALL_BUDGET_MS
    assert port.DEFAULT_TARGET == "cilium_tpu_torch"


def test_module_names_are_the_reference_s_and_stdlib_only():
    """The reference's 22 file names; nothing but the standard library
    and the package itself at import time (no torch, no JAX, nothing
    of ``cilium_tpu``)."""
    names = sorted(n for n in os.listdir(os.path.join(REPO, "cilium_tpu",
                                                      "analysis"))
                   if n.endswith(".py"))
    port_dir = os.path.join(REPO, "cilium_tpu_torch", "analysis")
    assert sorted(n for n in os.listdir(port_dir)
                  if n.endswith(".py")) == names and len(names) == 22
    code = ("import sys; import cilium_tpu_torch.analysis as a; "
            "from cilium_tpu_torch.analysis import core; core.run; "
            "import cilium_tpu_torch.analysis.devicedataflow, "
            "cilium_tpu_torch.analysis.pallas_shapes; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'numpy', 'yaml', 'cilium_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run(["python", "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


# -- the reference's tree -----------------------------------------------------

def _tally(pkg):
    """``pkg``'s agnostic checkers over the reference's tree → (active,
    allowlisted by rule)."""
    core = analysis(pkg, "core")
    for m in AGNOSTIC_MODULES:
        analysis(pkg, m)
    index, errors = core.ProjectIndex.from_tree(REPO, ("cilium_tpu",))
    found = list(errors)
    for check in core.CHECKERS:
        emits = getattr(check, "emits", None)
        if emits is None or set(emits) & set(AGNOSTIC):
            found.extend(check(index))
    found.extend(core._bare_disable_findings(index))
    active, allowed = [], collections.Counter()
    for f in sorted(set(found)):
        if f.rule not in AGNOSTIC:
            continue
        sf = index.by_path.get(f.path)
        if sf is not None and sf.disabled(f.line, f.rule):
            allowed[f.rule] += 1
        else:
            active.append(f.format())
    return active, allowed


@pytest.fixture(scope="module")
def reference_tree():
    return {pkg: _tally(pkg) for pkg in PKGS}


@pytest.mark.parametrize("rule", AGNOSTIC)
def test_reference_tree_agnostic_rule_equals_the_reference(reference_tree,
                                                           rule):
    """The port's rules, given the package ``cilium_tpu``, over the
    reference's tree: the reference's active findings (none) and its
    allowlisted count, rule by rule."""
    (ref_active, ref_allowed), (active, allowed) = (
        reference_tree[p] for p in PKGS)
    assert [f for f in active if f"[{rule}]" in f] == \
        [f for f in ref_active if f"[{rule}]" in f] == []
    assert allowed[rule] == ref_allowed[rule]


def test_reference_tree_allowlist_is_nonvacuous(reference_tree):
    _active, allowed = reference_tree["cilium_tpu_torch"]
    assert sum(allowed.values()) >= 30, allowed


# -- the CLI ----------------------------------------------------------------

BAD = "def f():\n    try:\n        g()\n    except:\n        pass\n"


def _main(argv):
    from cilium_tpu_torch.cli import main

    return main(argv)


def test_cli_lint_json_face(tmp_path, capsys):
    """``cilium-tpu lint --format json`` through the port's
    ``cli.main``: a well-formed schema-4 report, exit 0 when every
    finding is allowlisted."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        "import os  # ctlint: disable=unused-import  # re-export\n")
    rc = _main(["lint", "pkg", "--root", str(tmp_path), "--format",
                "json", "--rule", "wall-clock", "--rule", "unused-import"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report["schema_version"] == 4
    assert report["count"] == 0 and report["findings"] == []
    assert report["suppressed"] == 1


def test_cli_lint_exits_nonzero_on_findings(tmp_path, capsys):
    (tmp_path / "bad.py").write_text(BAD)
    rc = _main(["lint", "--root", str(tmp_path), "bad.py"])
    out = capsys.readouterr().out
    assert rc == 1 and "swallowed-exception" in out


def test_cli_lint_rule_filter(tmp_path, capsys):
    (tmp_path / "bad.py").write_text(BAD)
    assert _main(["lint", "--root", str(tmp_path), "bad.py", "--rule",
                  "unused-import"]) == 0
    capsys.readouterr()
    assert _main(["lint", "--root", str(tmp_path), "bad.py", "--rule",
                  "swallowed-exception"]) == 1
    capsys.readouterr()
    assert _main(["lint", "--rule", "no-such-rule"]) == 2
    assert "unknown rule" in capsys.readouterr().err


def test_cli_lint_list_rules(capsys):
    assert _main(["lint", "--list-rules"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 24
    assert lines[0].startswith("abi-surface: ")


def test_cli_lint_precommit_face_over_the_port_tree(capsys):
    """The port's precommit face (the reference's ``make precommit``
    rules, without ``--changed-only``): clean over the port's tree."""
    rc = _main(["lint", "--rule", "thread-safety", "--rule",
                "implicit-sync", "--rule", "hot-loop-h2d", "--rule",
                "readback-ordering", "--rule", "missing-donation"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.strip().startswith("ctlint: 0 finding(s)")
