"""The port's tenant quotas (``runtime/tenant.py``: ``TenantQuotas``,
``FairShareWindow``) against the JAX package's, on the CPU, mirroring
the quota, window and gate cases of ``tests/test_tenant.py`` and the two
exact-tick cases of ``tests/dst/test_boundaries.py``
(``test_fairness_quantum_rotates_at_the_exact_virtual_tick``,
``test_tenant_quota_lapse_races_a_regeneration``).

Every case runs one scenario in both packages — the port's
``AdmissionGate`` fed by the port's window and quotas, the reference's
by its own — and holds the decision sequence equal: every ``admit``
outcome and reason, every share read, the window's counts and start,
and the counter deltas. The scenario also makes the reference test's
own assertions.
"""

import importlib
import types

import pytest

PKG_MODULES = (("tenant", "runtime.tenant"), ("adm", "runtime.admission"),
               ("simclock", "runtime.simclock"), ("faults", "runtime.faults"),
               ("metrics", "runtime.metrics"), ("config", "core.config"))


def _pkg(root):
    ns = types.SimpleNamespace(root=root)
    for attr, mod in PKG_MODULES:
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")


def _reads(p, result):
    return p.metrics.METRICS.get(p.metrics.TENANT_QUOTA_READS,
                                 {"result": result})


def _quota_ttl_lapses_at_the_tick(p):
    now = [0.0]
    q = p.tenant.TenantQuotas(default_share=0.3, ttl_s=10.0,
                              clock=lambda: now[0])
    q.set_share("a", 0.8)
    out = [q.share_of("a")]
    now[0] = 10.0 - 1e-9
    out.append(q.share_of("a"))
    now[0] = 10.0
    out.append(q.share_of("a"))
    q.set_share("a", 0.9)
    now[0] = 19.0
    out += [q.share_of("a"), q.status()]
    assert out[:4] == [0.8, 0.8, 0.3, 0.9]
    return out


def _quota_read_fault_is_the_conservative_default(p):
    q = p.tenant.TenantQuotas(default_share=0.25, ttl_s=10.0,
                              clock=lambda: 0.0)
    q.set_share("a", 0.9)
    counts0 = [_reads(p, r) for r in ("live", "lapsed", "fault-default")]
    plan = p.faults.FaultPlan([p.faults.FaultRule("tenant.quota", times=1)])
    with p.faults.inject(plan):
        out = [q.share_of("a"), q.share_of("a"), q.share_of("b")]
    assert out == [0.25, 0.9, 0.25]
    return {"reads": out, "counted": [
        _reads(p, r) - c for r, c in zip(("live", "lapsed", "fault-default"),
                                         counts0)]}


def _window_rotates_at_the_quantum_tick(p):
    now = [0.0]
    w = p.tenant.FairShareWindow(quantum_s=1.0, max_share=0.5,
                                 clock=lambda: now[0])
    for _ in range(4):
        w.note("a")
    out = [w.counts()]
    now[0] = 1.0 - 1e-9
    w.note("a")
    out.append(w.counts())
    now[0] = 1.0
    w.note("a")
    out.append(w.counts())
    now[0] = 5.7
    w.note("b")
    out.append(w.window_start())
    assert out == [{"a": 4}, {"a": 5}, {"a": 1}, 5.0]
    return out


def _over_share_cases(p):
    FSW = p.tenant.FairShareWindow
    out = []
    w = FSW(quantum_s=100.0, max_share=0.4, clock=lambda: 0.0)
    for _ in range(3):
        w.note("a")
        w.note("b")
    out += [w.over_share("a"), w.over_share("b")]
    w.note("a")
    out += [w.over_share("a"), w.over_share("b")]
    lone = FSW(quantum_s=100.0, max_share=0.2, clock=lambda: 0.0)
    for _ in range(50):
        lone.note("a")
    out.append(lone.over_share("a"))
    wt = FSW(quantum_s=100.0, max_share=0.1,
             weight_of=lambda t: 3.0 if t == "big" else 1.0,
             clock=lambda: 0.0)
    for _ in range(3):
        wt.note("big")
    wt.note("small")
    out += [wt.over_share("big"), wt.over_share("small")]
    wt.note("big")
    out += [wt.over_share("big"), wt.over_share("big", share_cap=0.9)]
    out.append(FSW(clock=lambda: 0.0).over_share("anyone"))
    assert out == [False, False, True, False, False, False, False, True,
                   False, False]
    return out


def _fair_gate(p, depth, max_share=0.5, quotas=None):
    fair = p.tenant.FairShareWindow(quantum_s=1000.0, max_share=max_share,
                                    clock=lambda: 0.0)
    gate = p.adm.AdmissionGate(max_pending=8, control_reserve=2,
                               depth_fn=lambda: depth, fairness=fair,
                               quotas=quotas)
    return gate, fair


def _storming_tenant_sheds_tenant_quota(p):
    gate, fair = _fair_gate(p, depth=6)
    labels = {"surface": "service", "class": p.adm.CLASS_DATA,
              "reason": p.adm.SHED_TENANT_QUOTA, "tenant": "a"}
    shed0 = p.metrics.METRICS.get(p.metrics.ADMISSION_SHED, labels)
    out = [gate.admit(p.adm.CLASS_DATA, tenant="b") for _ in range(2)]
    out += [gate.admit(p.adm.CLASS_DATA, tenant="a") for _ in range(10)]
    out.append(gate.admit(p.adm.CLASS_DATA, tenant="b"))
    a_shed = sum(1 for ok, _ in out[2:12] if not ok)
    assert 0 < a_shed < 10 and out[-1] == (True, "")
    assert p.metrics.METRICS.get(p.metrics.ADMISSION_SHED,
                                 labels) == shed0 + a_shed
    return {"decisions": out, "counts": fair.counts()}


def _fairness_only_when_congested_and_never_for_control(p):
    gate, _ = _fair_gate(p, depth=4)
    out = [gate.admit(p.adm.CLASS_DATA, tenant="a") for _ in range(20)]
    gate, fair = _fair_gate(p, depth=6)
    for _ in range(10):
        fair.note("a")
    out.append(gate.admit(p.adm.CLASS_CONTROL, tenant="a"))
    assert all(d == (True, "") for d in out)
    return out


def _quota_store_feeds_the_fairness_ceiling(p):
    now = [0.0]
    quotas = p.tenant.TenantQuotas(default_share=0.2, ttl_s=10.0,
                                   clock=lambda: now[0])
    quotas.set_share("a", 0.95)
    gate, fair = _fair_gate(p, depth=6, max_share=0.2, quotas=quotas)
    fair.note("b")
    out = [gate.admit(p.adm.CLASS_DATA, tenant="a") for _ in range(6)]
    now[0] = 10.0
    out.append(gate.admit(p.adm.CLASS_DATA, tenant="a"))
    out.append(gate.admit(p.adm.CLASS_DATA, tenant="b"))
    assert out[:6] == [(True, "")] * 6
    assert out[6] == (False, p.adm.SHED_TENANT_QUOTA)
    assert out[7] == (True, "")
    return out


def _quantum_rotates_at_the_exact_virtual_tick(p):
    """tests/dst/test_boundaries.py:794 — a storming tenant is
    forgiven at EXACTLY start+quantum, and the rotation lands on the
    quantum grid."""
    clk = p.simclock.VirtualClock(start=100.0)
    with p.simclock.use(clk):
        fair = p.tenant.FairShareWindow(quantum_s=5.0, max_share=0.3)
        gate = p.adm.AdmissionGate(max_pending=8, control_reserve=2,
                                   depth_fn=lambda: 6, fairness=fair)
        out = [gate.admit(p.adm.CLASS_DATA, tenant="b")]
        for _ in range(12):
            d = gate.admit(p.adm.CLASS_DATA, tenant="a")
            out.append(d)
            if not d[0]:
                break
        assert out[-1] == (False, p.adm.SHED_TENANT_QUOTA)
        clk.advance_to(100.0 + 5.0 - 1e-6)
        out.append(gate.admit(p.adm.CLASS_DATA, tenant="a"))
        clk.advance_to(105.0)
        out += [gate.admit(p.adm.CLASS_DATA, tenant="a"),
                fair.window_start()]
        clk.advance_to(105.0 + 12.5)
        fair.note("b")
        out.append(fair.window_start())
        assert out[-4:] == [(False, p.adm.SHED_TENANT_QUOTA), (True, ""),
                            105.0, 115.0]
        return out


def _quota_lapse_races_a_regeneration(p):
    """tests/dst/test_boundaries.py:873 — the quota lapses at EXACTLY
    the tick of a regeneration's admission decisions: data sheds on
    the conservative default, control sails through, a refresh
    restores service; one tick earlier the live quota still holds."""
    clk = p.simclock.VirtualClock(start=0.0)
    with p.simclock.use(clk):
        quotas = p.tenant.TenantQuotas(default_share=0.2, ttl_s=10.0)
        quotas.set_share("a", 0.95)
        fair = p.tenant.FairShareWindow(quantum_s=1000.0, max_share=0.2)
        gate = p.adm.AdmissionGate(max_pending=8, control_reserve=2,
                                   depth_fn=lambda: 6, fairness=fair,
                                   quotas=quotas)
        fair.note("b")
        lapsed0 = _reads(p, "lapsed")
        clk.advance_to(10.0 - 1e-6)
        out = [gate.admit(p.adm.CLASS_DATA, tenant="a") for _ in range(6)]
        clk.advance_to(10.0)
        out += [gate.admit(p.adm.CLASS_DATA, tenant="a"),
                gate.admit(p.adm.CLASS_CONTROL, tenant="a"),
                _reads(p, "lapsed") - lapsed0]
        quotas.set_share("a", 0.95)
        out.append(gate.admit(p.adm.CLASS_DATA, tenant="a"))
        assert out[:6] == [(True, "")] * 6
        assert out[6:] == [(False, p.adm.SHED_TENANT_QUOTA), (True, ""),
                           1.0, (True, "")]
        return out


def _dst_quota_arm(p):
    """The DST world's ``tenant quota`` arm without the world: tenant
    A's 0.9 share lapses at its own tick (ttl 0), B establishes
    presence, A floods a congested window, B's fair allotment admits."""
    cfg = p.config.Config()
    cfg.tenant.enabled = True
    cfg.tenant.ranges = ("a:300-300", "b:301-301")
    with p.simclock.use(p.simclock.VirtualClock()):
        tmap = p.tenant.TenantMap.from_config(cfg)
        quotas = p.tenant.TenantQuotas.from_config(cfg)
        quotas.set_share("a", 0.9, ttl_s=0.0)
        fair = p.tenant.FairShareWindow(quantum_s=cfg.tenant.quantum_s,
                                        max_share=cfg.tenant.max_share,
                                        weight_of=tmap.weight_of)
        gate = p.adm.AdmissionGate(max_pending=8, control_reserve=2,
                                   depth_fn=lambda: 6, fairness=fair,
                                   quotas=quotas)
        out = [gate.admit(p.adm.CLASS_DATA, tenant="b") for _ in range(3)]
        out += [gate.admit(p.adm.CLASS_DATA, tenant="a") for _ in range(12)]
        out += [gate.admit(p.adm.CLASS_DATA, tenant="b") for _ in range(2)]
        return {"decisions": out, "status": quotas.status()}


SCENARIOS = {
    "quota_ttl_lapses_at_exactly_the_tick": _quota_ttl_lapses_at_the_tick,
    "quota_read_fault_is_the_conservative_default":
        _quota_read_fault_is_the_conservative_default,
    "window_rotates_at_exactly_the_quantum_tick":
        _window_rotates_at_the_quantum_tick,
    "over_share_current_share_lone_weights_empty": _over_share_cases,
    "storming_tenant_sheds_tenant_quota_with_tenant_label":
        _storming_tenant_sheds_tenant_quota,
    "fairness_only_when_congested_and_never_for_control":
        _fairness_only_when_congested_and_never_for_control,
    "quota_store_feeds_the_fairness_ceiling":
        _quota_store_feeds_the_fairness_ceiling,
    "fairness_quantum_rotates_at_the_exact_virtual_tick":
        _quantum_rotates_at_the_exact_virtual_tick,
    "tenant_quota_lapse_races_a_regeneration":
        _quota_lapse_races_a_regeneration,
    "dst_quota_arm": _dst_quota_arm,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tenant_scenario_equals_the_reference(name):
    ref, port = SCENARIOS[name](JAX), SCENARIOS[name](PORT)
    assert port == ref


def test_config_reads_the_tenant_and_dst_settings():
    """``Config.dst`` and the four environment settings, as the
    reference's ``Config.from_env`` reads them."""
    env = {"CILIUM_TPU_DST_SEED": "17", "CILIUM_TPU_DST_MUTATION":
           "positional-banks", "CILIUM_TPU_TENANT_QUANTUM_S": "2.5",
           "CILIUM_TPU_TENANT_QUOTA_TTL_S": "7"}
    ref, port = (p.config.Config.from_env(env) for p in (JAX, PORT))
    for cfg in (ref, port):
        assert (cfg.dst.seed, cfg.dst.mutation) == (17, "positional-banks")
        assert (cfg.tenant.quantum_s, cfg.tenant.quota_ttl_s) == (2.5, 7.0)
    import dataclasses

    assert dataclasses.asdict(port.dst) == dataclasses.asdict(ref.dst)
    assert dataclasses.asdict(PORT.config.Config().dst) == \
        dataclasses.asdict(JAX.config.Config().dst)
