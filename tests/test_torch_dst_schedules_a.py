"""Hand-written DST schedules on the CPU, part a: the port's
``run_schedule`` trace equals the JAX package's, dict for dict, with the
same digest and the same fault fires — here the serving and dispatch
faults, the loader and compile faults, and the committed regression
case (``tests/dst/regressions/``), which replays to its recorded
violation (index and invariant) in both packages, with the same
detail, and is clean in both without its mutation.

The schedules and the runner live in ``test_torch_dst.py``; the cases
are split over three files so that ``--dist loadfile`` spreads them.
"""

import json

import pytest

from test_torch_dst import (
    REGRESSION_CASE,
    SCHEDULES,
    assert_same_trace,
    run_both,
)


@pytest.mark.parametrize("name", ["serve_and_dispatch_faults",
                                  "loader_and_compile_faults"])
def test_schedule_trace_equals_the_reference(name, monkeypatch):
    events, fires = SCHEDULES[name]
    ref, port = run_both(events, monkeypatch=monkeypatch)
    assert ref["violation"] is None
    assert_same_trace(ref, port)
    assert ref["fires"] == port["fires"] == fires
    assert port["trace"][-1]["event"] == ["liveness"]


def test_regression_case_reproduces_in_both_and_is_clean_without(
        monkeypatch):
    with open(REGRESSION_CASE) as fp:
        data = json.load(fp)
    ref, port = run_both(data["events"], seed=data["seed"],
                         mutation=data["mutation"], monkeypatch=monkeypatch)
    # the recorded index and invariant; the recorded detail lists the
    # 23 probe flows of the world the case was shrunk in, and both
    # packages' worlds now probe the frontend kinds too (41 flows)
    assert {k: port["violation"][k] for k in ("index", "invariant")} == \
        {k: data["violation"][k] for k in ("index", "invariant")}
    assert_same_trace(ref, port)
    ref, port = run_both(data["events"], seed=data["seed"],
                         monkeypatch=monkeypatch)
    assert port["violation"] is None
    assert_same_trace(ref, port)
