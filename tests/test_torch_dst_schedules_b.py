"""Hand-written DST schedules on the CPU, part b: a warm restore with
lost bank artifacts and an identity churn storm, then the clustermesh
round and a fleet kill and rejoin — the port's trace equal to the JAX
package's, dict for dict, with the same digest and fault fires."""

import pytest

from test_torch_dst import SCHEDULES, assert_same_trace, run_both


@pytest.mark.parametrize("name", ["restore_fetch_and_identity_storm",
                                  "clustermesh_and_fleet_kill_rejoin"])
def test_schedule_trace_equals_the_reference(name, monkeypatch):
    events, fires = SCHEDULES[name]
    ref, port = run_both(events, monkeypatch=monkeypatch)
    assert ref["violation"] is None
    assert_same_trace(ref, port)
    assert ref["fires"] == port["fires"] == fires
    assert port["trace"][-1]["event"] == ["liveness"]
