"""wall-clock: behavioral time in the serving plane routes through
the injected Clock.

The DST layer (runtime/simclock.py + runtime/dst.py) can only search
fault schedules deterministically if every time-driven state machine —
breaker probes, quarantine TTLs, admission deadlines, backoff,
leases, cache expiry — reads the INSTALLED clock. One stray
``time.monotonic()`` in a deadline comparison and virtual time
silently diverges from the state machine it is supposed to drive:
the schedule that would have exposed a race becomes unreachable, and
the soak lanes go back to sleeping through wall-clock TTLs.

This rule flags direct calls to ``time.time`` / ``time.monotonic`` /
``time.sleep`` (and their ``_ns`` variants, and ``Event.wait``-style
timeouts are left to the reader) in the serving-plane module scope:

* ``<package>/runtime/`` (except ``simclock.py`` — it IS the seam)
* ``<package>/engine/``, ``<package>/policy/``, ``<package>/fqdn/``
* the root serving modules: ``kvstore``, ``kvstore_service``,
  ``identity_kvstore``, ``clustermesh``, ``auth``

``time.perf_counter`` is exempt everywhere: it measures how long real
work took (bench, phase attribution, EWMA denominators are routed
explicitly via ``Clock.perf``), and a virtual clock has nothing
truthful to say about real CPU seconds.

Genuine wall-of-the-real-world reads — provenance capture stamps,
the profiler's sampling sleeps — carry the standard justified
pragma::

    # ctlint: disable=wall-clock  # why real time is the right clock
"""

from __future__ import annotations

import ast
from typing import List

from cilium_tpu_torch.analysis.callgraph import dotted
from cilium_tpu_torch.analysis.core import Finding, ProjectIndex, checker

RULE = "wall-clock"

#: the behavioral time surface; perf_counter/process_time measure the
#: real world and stay direct
_BANNED = {
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.sleep",
}

#: path prefixes in scope, relative to the run's package
#: (``ProjectIndex.rel``)
_SCOPE_PREFIXES = (
    "runtime/",
    "engine/",
    "policy/",
    "fqdn/",
)

#: root serving-plane modules in scope
_SCOPE_FILES = (
    "kvstore.py",
    "kvstore_service.py",
    "identity_kvstore.py",
    "clustermesh.py",
    "auth.py",
)

#: the clock seam itself — the one module allowed to touch time.*
_EXEMPT = ("runtime/simclock.py",)

_REPLACEMENT = {
    "time.time": "simclock.wall()",
    "time.time_ns": "simclock.wall()",
    "time.monotonic": "simclock.now()",
    "time.monotonic_ns": "simclock.now()",
    "time.sleep": "simclock.sleep()",
}


def in_scope(path: str, package: str) -> bool:
    p = path.replace("\\", "/")
    if p in {f"{package}/{e}" for e in _EXEMPT}:
        return False
    return p.startswith(tuple(f"{package}/{s}" for s in _SCOPE_PREFIXES)) \
        or p in {f"{package}/{f}" for f in _SCOPE_FILES}


@checker
def check(index: ProjectIndex) -> List[Finding]:
    from cilium_tpu_torch.analysis.callgraph import Project

    project = Project(index)
    findings: List[Finding] = []
    for mi in project.modules.values():
        if not in_scope(mi.sf.path, index.package):
            continue
        for node in ast.walk(mi.sf.tree):
            if not isinstance(node, ast.Call):
                continue
            q = mi.qualify(node.func) or (dotted(node.func) or "")
            if q not in _BANNED:
                continue
            findings.append(Finding(
                mi.sf.path, node.lineno, RULE,
                f"direct `{q}()` in a serving-plane module — "
                f"behavioral time must route through the injected "
                f"Clock ({_REPLACEMENT.get(q, 'runtime/simclock.py')}) "
                f"or the DST schedule search cannot reach the states "
                f"this call gates; justify real-world reads "
                f"(provenance stamps, profiler sampling) with a "
                f"disable pragma"))
    return findings
check.emits = (RULE,)
