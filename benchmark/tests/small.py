"""Small versions of the cell's configuration and traffic, for the CPU
tests: the shapes of the real files at sizes a test run holds."""

from __future__ import annotations

import json
import os

from benchmark import registry, traffic as traffic_mod

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name: str = "http-1k") -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as fh:
        cfg = json.load(fh)
    cfg["policies"][0]["http"]["count"] = 60
    return cfg


def traffic(records: int = 8192, chunk: int = 2048,
            name: str = "replay-unique") -> dict:
    t = traffic_mod.load_traffic(registry.traffic_path(name))
    return dict(t, records=records, chunk=chunk, base=500)
