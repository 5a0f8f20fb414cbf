"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``benchmark/configs/<name>.json``, a traffic mix
``benchmark/traffic/<name>.json`` (drawn by the generator module it
names, ``benchmark/traffic/<generator>.py``), a per-layer metric a module
``benchmark/metrics/<name>.py`` with a ``read(ctx)`` function (a name's
``.`` and ``-`` become ``_`` in the module's name). Adding a cell, a
mix or a metric is adding files and entries: nothing here changes.
"""

from __future__ import annotations

import importlib
import json
import os
import re
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class BenchmarkError(ValueError):
    pass


def check_name(name: object, what: str = "name") -> str:
    if not isinstance(name, str) or NAME.fullmatch(name) is None:
        raise BenchmarkError(f"invalid {what} {name!r}")
    return name


def check_unit(unit: object) -> str:
    if not isinstance(unit, str) or UNIT.fullmatch(unit) is None:
        raise BenchmarkError(f"invalid unit {unit!r}")
    return unit


def load_benchmark(root: str = ROOT) -> Dict[str, object]:
    """``BENCHMARK.json`` with its names and units checked."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise BenchmarkError(f"no BENCHMARK.json under {root}")
    with open(path) as fh:
        bench = json.load(fh)
    for c in bench["configs"]:
        check_name(c["name"], "configuration")
        for k in c.get("reduced", ()):
            check_name(k, "reduced key")
    for w in bench["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["config"], "configuration")
        check_name(w["traffic"], "traffic")
    for m in bench["end_to_end"] + bench["per_layer"]:
        check_name(m["name"], "metric")
        check_unit(m["unit"])
        if m["better"] not in ("lower", "higher"):
            raise BenchmarkError(f"{m['name']}: better is lower or higher")
    return bench


def workload(bench: Dict[str, object], name: str) -> Dict[str, object]:
    check_name(name, "workload")
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchmarkError(f"no workload {name!r} in BENCHMARK.json")


def config_path(bench: Dict[str, object], name: str,
                root: str = ROOT) -> str:
    check_name(name, "configuration")
    for c in bench["configs"]:
        if c["name"] == name:
            return os.path.join(root, c["file"])
    raise BenchmarkError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_path(name: str, here: str = HERE) -> str:
    check_name(name, "traffic")
    path = os.path.join(here, "traffic", f"{name}.json")
    if not os.path.exists(path):
        raise BenchmarkError(f"no traffic file {path}")
    return path


def module_name(name: str, what: str = "metric") -> str:
    return re.sub(r"[.\-]", "_", check_name(name, what))


def metric_reader(name: str, package: str = "benchmark.metrics"):
    """The ``read`` function of ``<package>/<name>.py``."""
    mod = importlib.import_module(f"{package}.{module_name(name)}")
    return mod.read


def metrics_for(bench: Dict[str, object], cell: str, kind: str
                ) -> List[Dict[str, object]]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    without a ``workloads`` key, and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def cache_dir(name: str, here: str = HERE) -> str:
    """A fixed, git-ignored directory inside the benchmark's folder."""
    d = os.path.join(here, ".cache", check_name(name))
    os.makedirs(d, exist_ok=True)
    return d
