"""The cell's control, at a size a test run holds: the reference with
its configuration's named guarantee broken, in the program's place,
comes out not correct; the reference itself comes out correct."""

from __future__ import annotations

import json

import pytest

from benchmark import control, registry
from benchmark.tests import small


@pytest.mark.parametrize("cell", ["http-1k.replay-unique"])
@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 11])
def test_the_control_is_not_correct(cell, seed):
    bench = registry.load_benchmark()
    cfg = small.config(registry.workload(bench, cell)["config"])
    readings, ok = control.control_readings(cfg, small.traffic(), seed)
    assert not ok and readings["mismatched_records"] > 0
    assert readings["records_compared"] == small.traffic()["records"]


@pytest.mark.parametrize("config", ["http-1k"])
def test_the_configurations_name_their_control(config):
    with open(f"{small.HERE}/configs/{config}.json") as fh:
        cfg = json.load(fh)
    from benchmark.reference import CONTROLS

    assert cfg["control"] in CONTROLS


@pytest.mark.parametrize("config", ["http-1k"])
def test_the_reference_in_the_program_s_place_is_correct(config,
                                                        monkeypatch):
    """The comparison passes what it should: the reference against
    itself."""
    from benchmark import reference

    decide = reference.decide
    monkeypatch.setattr(reference, "decide",
                        lambda dep, rec, control=None: decide(dep, rec))
    readings, ok = control.control_readings(small.config(config),
                                            small.traffic(), 3)
    assert ok and readings["mismatched_records"] == 0
