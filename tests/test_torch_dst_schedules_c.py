"""Hand-written DST schedules on the CPU, part c: a fleet partition
whose death handoff is interrupted, then the multichip arm (two gloo
ranks, the DP and CP lanes held bit-equal to the single-device step),
and the tenant arm's three modes — the port's trace equal to the JAX
package's, dict for dict, with the same digest and fault fires."""

import pytest

from test_torch_dst import SCHEDULES, assert_same_trace, run_both


@pytest.mark.parametrize("name", ["fleet_partition_beat_and_multichip",
                                  "tenant_arms"])
def test_schedule_trace_equals_the_reference(name, monkeypatch):
    events, fires = SCHEDULES[name]
    ref, port = run_both(events, monkeypatch=monkeypatch)
    assert ref["violation"] is None
    assert_same_trace(ref, port)
    assert ref["fires"] == port["fires"] == fires
    assert port["trace"][-1]["event"] == ["liveness"]
    if name.endswith("multichip"):
        mc = [e["out"] for e in port["trace"] if e["event"] == ["multichip"]]
        assert mc == [{"devices": 2, "flows": mc[0]["flows"],
                       "verdicts": mc[0]["verdicts"], "degraded": False}]
