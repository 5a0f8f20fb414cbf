"""The port's verdict service against the JAX package's, on the CPU.

Both packages serve the same snapshots through their own ``Loader``
(the reference with the gate set on, ``JAX_PLATFORMS=cpu``; the port
with ``device="cpu"``) and their own ``VerdictService``, and must give
the same responses, field by field (a ``trace_id`` aside):

* ``ping``, ``check``, ``verdict``, ``on_new_connection``/``on_data``
  (Kafka and HTTP), ``status``, ``explain``, ``drain``, unknown ops and
  the ``mapstate_pull`` blob (byte-equal), on the http, kafka and fqdn
  scenarios;
* the circuit breaker's transitions, and the ``ResilientVerdictor``
  tripping on the engine's ``engine.dispatch`` fault, serving the
  oracle's verdicts and recovering under a ``VirtualClock``;
* the ``MicroBatcher``'s bound, reap, drain and close (the reference's
  ``tests/test_admission.py`` cases, run on each package), four drain
  workers exact, and the pow2 padding's count;
* the reference's C++ shim (``shim/libcilium_shim.so``) driving the
  port's service end to end.

And what only the port has: the engine check is ``isinstance``; a
request that meets what the port does not serve yet
(``NotImplementedError``: here a stand-in for the agent plane, queue 1's
Q13, forced by :func:`unported_on`) and a kernel whose launch fails (KD's C entry point stubbed to return a CUDA error)
are error responses, never a breaker trip or an oracle verdict; and
``_build.Kernel``'s counts stay exact under concurrent launches.

Every service is stopped and every loader closed in teardown; sockets
live under ``tmp_path``.
"""

import base64
import contextlib
import ctypes
import dataclasses
import importlib
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in (("config", "core.config"),
                      ("loader", "runtime.loader"),
                      ("flow", "core.flow"),
                      ("api", "policy.api"),
                      ("identity", "core.identity"),
                      ("labels", "core.labels"),
                      ("mapstate", "policy.mapstate"),
                      ("repository", "policy.repository"),
                      ("selectorcache", "policy.selectorcache"),
                      ("synth", "ingest.synth"),
                      ("binary", "ingest.binary"),
                      ("hubble", "ingest.hubble"),
                      ("service", "runtime.service"),
                      ("stream", "runtime.stream"),
                      ("proxylib", "proxylib"),
                      ("kafka", "proxylib.kafka"),
                      ("http", "proxylib.http"),
                      ("faults", "runtime.faults"),
                      ("metrics", "runtime.metrics"),
                      ("memo", "engine.memo"),
                      ("simclock", "runtime.simclock")):
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")
PKGS = (JAX, PORT)
IDS = ("jax", "port")


def make_loader(pkg, cache_dir, **cfg_kw):
    """A gate-on loader on its own cache directory; ``section__field``
    keywords set config fields."""
    cfg = pkg.config.Config()
    cfg.enable_tpu_offload = True
    cfg.loader.cache_dir = str(cache_dir)
    cfg.compile.deadline_s = 600.0
    for k, v in cfg_kw.items():
        section, _, name = k.partition("__")
        setattr(getattr(cfg, section) if name else cfg, name or section, v)
    return (pkg.loader.Loader(cfg) if pkg.jax
            else pkg.loader.Loader(cfg, device="cpu"))


def scenario(pkg, name, n_rules=40, n_flows=256):
    return pkg.synth.realize_scenario(
        pkg.synth.scenario_by_name(name, n_rules, n_flows))


@contextlib.contextmanager
def served(pkg, loader, path, **kw):
    svc = pkg.service.VerdictService(loader, str(path), **kw)
    svc.start()
    try:
        yield svc
    finally:
        svc.stop()


@contextlib.contextmanager
def client(pkg, svc):
    c = pkg.service.VerdictClient(svc.socket_path)
    try:
        yield c
    finally:
        c.close()


def strip(resp):
    """A response without its (random) trace id."""
    return {k: v for k, v in resp.items() if k != "trace_id"}


def l4_world(pkg, port=80):
    """One L4 rule: ``svc`` admits TCP ``port`` from anyone."""
    api = pkg.api
    rules = [api.Rule(
        endpoint_selector=api.EndpointSelector.from_labels(app="svc"),
        ingress=(api.IngressRule(to_ports=(api.PortRule(
            ports=(api.PortProtocol(port, pkg.flow.Protocol.TCP),)),)),),
    )]
    alloc = pkg.identity.IdentityAllocator()
    svc = alloc.allocate(pkg.labels.LabelSet.from_dict({"app": "svc"}))
    repo = pkg.repository.Repository()
    repo.add(rules, sanitize=False)
    res = pkg.mapstate.PolicyResolver(
        repo, pkg.selectorcache.SelectorCache(alloc))
    return {svc: res.resolve(alloc.lookup(svc))}, svc


def proxy_world(pkg, log_action=False):
    """The reference's proxylib test policy: ``kafka`` admits produce of
    ``allowed-topic`` on 9092; ``web`` admits ``GET /ok/.*`` on 80 —
    with the three header-rewrite actions, or one LOG action."""
    api, flow = pkg.api, pkg.flow
    sel = api.EndpointSelector.from_labels
    if log_action:
        hms = (api.HeaderMatch(name="X-Trace", value="on",
                               mismatch_action="LOG"),)
    else:
        hms = (api.HeaderMatch(name="X-Add", value="v1",
                               mismatch_action="ADD"),
               api.HeaderMatch(name="X-Rep", value="v2",
                               mismatch_action="REPLACE"),
               api.HeaderMatch(name="X-Del", value="good",
                               mismatch_action="DELETE"))
    rules = [
        api.Rule(endpoint_selector=sel(app="kafka"),
                 ingress=(api.IngressRule(to_ports=(api.PortRule(
                     ports=(api.PortProtocol(9092, flow.Protocol.TCP),),
                     rules=api.L7Rules(kafka=(api.PortRuleKafka(
                         role="produce", topic="allowed-topic"),)),
                 ),)),)),
        api.Rule(endpoint_selector=sel(app="web"),
                 ingress=(api.IngressRule(to_ports=(api.PortRule(
                     ports=(api.PortProtocol(80, flow.Protocol.TCP),),
                     rules=api.L7Rules(http=(api.PortRuleHTTP(
                         method="GET", path="/ok/.*",
                         header_matches=hms),)),
                 ),)),)),
    ]
    alloc = pkg.identity.IdentityAllocator()
    ids = {n: alloc.allocate(pkg.labels.LabelSet.from_dict({"app": n}))
           for n in ("kafka", "web", "cli")}
    repo = pkg.repository.Repository()
    repo.add(rules, sanitize=False)
    res = pkg.mapstate.PolicyResolver(
        repo, pkg.selectorcache.SelectorCache(alloc))
    return {i: res.resolve(alloc.lookup(i)) for i in ids.values()}, ids


@pytest.fixture(scope="module")
def proxy_loaders(tmp_path_factory):
    """pkg root → (loader, ids) over :func:`proxy_world`."""
    out = {}
    for pkg in PKGS:
        per, ids = proxy_world(pkg)
        ld = make_loader(pkg, tmp_path_factory.mktemp(pkg.root))
        ld.regenerate(per, revision=1)
        out[pkg.root] = (ld, ids)
    yield out
    for ld, _ in out.values():
        ld.close()


@pytest.fixture(scope="module")
def scenario_loaders(tmp_path_factory):
    """scenario name → pkg root → (loader, scenario), built once."""
    out = {}
    for name in ("http", "kafka", "fqdn"):
        out[name] = {}
        for pkg in PKGS:
            per, sc = scenario(pkg, name)
            ld = make_loader(pkg, tmp_path_factory.mktemp(pkg.root))
            ld.regenerate(per, revision=1)
            out[name][pkg.root] = (ld, sc)
    yield out
    for by_pkg in out.values():
        for ld, _ in by_pkg.values():
            ld.close()


# ====================================================== circuit breaker
def _breaker_script(pkg):
    now = [0.0]
    cb = pkg.service.CircuitBreaker
    br = cb(failure_threshold=3, probe_interval=5.0, clock=lambda: now[0])
    m = pkg.metrics.METRICS
    trips0 = m.get("cilium_tpu_breaker_trips_total")
    rec0 = m.get("cilium_tpu_breaker_recoveries_total")
    seen = []
    br.record_failure()
    br.record_failure()
    br.record_success()
    seen.append(br.state)
    for _ in range(3):
        seen.append(br.allow_primary())
        br.record_failure()
    seen += [br.state, br.allow_primary()]
    now[0] = 5.1
    seen += [br.allow_primary(), br.state, br.allow_primary()]
    br.record_failure()
    seen += [br.state, br.allow_primary()]
    now[0] = 10.3
    seen.append(br.allow_primary())
    br.record_success()
    seen.append(br.state)
    return (seen, list(br.events),
            m.get("cilium_tpu_breaker_trips_total") - trips0,
            m.get("cilium_tpu_breaker_recoveries_total") - rec0)


def test_circuit_breaker_transitions_equal_the_reference():
    want, got = _breaker_script(JAX), _breaker_script(PORT)
    assert got == want
    assert [e for e, _ in got[1]] == ["trip", "probe", "probe-failed",
                                      "probe", "recover"]
    assert got[2:] == (1, 1)
    # the port's addition: a released probe re-opens with the timer
    # still expired, so the next caller probes at once
    now = [0.0]
    br = PORT.service.CircuitBreaker(failure_threshold=1,
                                     probe_interval=1.0,
                                     clock=lambda: now[0])
    br.record_failure()
    now[0] = 2.0
    assert br.allow_primary() and br.state == br.HALF_OPEN
    br.release_probe()
    assert br.state == br.OPEN
    assert br.allow_primary() and br.state == br.HALF_OPEN
    br.record_success()
    assert [e for e, _ in br.events] == ["trip", "probe", "probe-released",
                                         "probe", "recover"]


def _verdictor_run(pkg, loader, flows):
    """Three injected dispatch failures trip the breaker; a call while
    open, then one after the probe interval (virtual time)."""
    clock = pkg.simclock.VirtualClock()
    br = pkg.service.CircuitBreaker(failure_threshold=3,
                                    probe_interval=5.0, clock=clock.now)
    vd = pkg.service.ResilientVerdictor(loader, breaker=br)
    m = pkg.metrics.METRICS
    names = ("cilium_tpu_breaker_trips_total",
             "cilium_tpu_breaker_recoveries_total",
             "cilium_tpu_breaker_fallback_verdicts_total")
    before = [m.get(n) for n in names]
    plan = pkg.faults.FaultPlan([pkg.faults.FaultRule(
        "engine.dispatch", times=3)], seed=1)
    calls = []
    with pkg.faults.inject(plan):
        for _ in range(4):
            calls.append(vd.verdicts(flows))
        opened = br.state
        clock.advance(5.0)
        calls.append(vd.verdicts(flows))
    moved = [m.get(n) - b for n, b in zip(names, before)]
    return (calls, opened, br.state, [e for e, _ in br.events], moved,
            plan.counts("engine.dispatch"))


def test_resilient_verdictor_trips_serves_oracle_and_recovers(
        scenario_loaders):
    runs = {}
    for pkg in PKGS:
        ld, sc = scenario_loaders["http"][pkg.root]
        runs[pkg.root] = _verdictor_run(pkg, ld, sc.flows[:12])
    want, got = runs["cilium_tpu"], runs["cilium_tpu_torch"]
    assert got == want
    calls, opened, closed, events, moved, counts = got
    assert opened == PORT.service.CircuitBreaker.OPEN
    assert closed == PORT.service.CircuitBreaker.CLOSED
    assert events == ["trip", "probe", "recover"]
    # trips, recoveries, fallback verdicts: 3 failed + 1 open call
    assert moved == [1, 1, 4 * 12]
    # the open call never reached the device; the probe did
    assert counts == (4, 3)
    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]
    want = [int(v) for v in ld.engine.verdict_flows(
        sc.flows[:12])["verdict"]]
    assert all(c == want for c in calls)


def test_device_backed_is_an_isinstance_check(scenario_loaders):
    ld, _ = scenario_loaders["http"]["cilium_tpu_torch"]
    rv = PORT.service.ResilientVerdictor
    assert rv._device_backed(ld.engine)
    assert not rv._device_backed(ld.fallback_engine)
    assert not hasattr(ld.engine, "_blob_step")


#: flows to this port make the port's engine re-plan under
#: an input the port does not serve (:func:`unported_on`)
UNPORTED_PORT = 4999


def _unported(engine):
    """What the port answers for an input it does not serve yet: a
    ``NotImplementedError`` naming the queue item that carries it (a
    stand-in for the agent plane, queue 1's Q13)."""
    raise NotImplementedError(
        f"flows to port {UNPORTED_PORT} on {type(engine).__name__} arrive "
        f"with the agent plane (queue 1, Q13)")


def unported_on(monkeypatch):
    """Make the port's engine — its flow entry points and its serving
    session — raise :func:`_unported`'s error for any batch or chunk
    that carries a flow to :data:`UNPORTED_PORT`: an input the port does
    not serve yet, whatever else is ported."""
    from cilium_tpu_torch.engine import session as session_mod
    from cilium_tpu_torch.engine.verdict import TorchVerdictEngine

    for name in ("verdict_flows", "verdict_flows_blob"):
        orig = getattr(TorchVerdictEngine, name)

        def wrapped(self, flows, *a, _orig=orig, **kw):
            if any(f.dport == UNPORTED_PORT for f in flows):
                _unported(self)
            return _orig(self, flows, *a, **kw)
        monkeypatch.setattr(TorchVerdictEngine, name, wrapped)
    cls = session_mod.IncrementalSession
    orig_encode = cls.encode_ids

    def encode_ids(self, rec, *a, **kw):
        if (np.asarray(rec["dport"]) == UNPORTED_PORT).any():
            _unported(self.engine)
        return orig_encode(self, rec, *a, **kw)
    monkeypatch.setattr(cls, "encode_ids", encode_ids)


def test_not_implemented_is_not_a_device_failure(scenario_loaders,
                                                 tmp_path, monkeypatch):
    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]
    unported_on(monkeypatch)
    generic = dataclasses.replace(sc.flows[0], dport=UNPORTED_PORT)
    m = PORT.metrics.METRICS
    names = ("cilium_tpu_breaker_trips_total",
             "cilium_tpu_breaker_fallback_verdicts_total")
    before = [m.get(n) for n in names]
    now = [0.0]
    br = PORT.service.CircuitBreaker(failure_threshold=1,
                                     probe_interval=1.0,
                                     clock=lambda: now[0])
    vd = PORT.service.ResilientVerdictor(ld, breaker=br)
    for _ in range(3):
        with pytest.raises(NotImplementedError, match="Q13"):
            vd.verdicts([generic] + sc.flows[:3])
    assert br.state == br.CLOSED and br.events == []
    assert [m.get(n) for n in names] == before
    # the probe an unported input held is released, not failed
    plan = PORT.faults.FaultPlan([PORT.faults.FaultRule(
        "engine.dispatch", times=1)])
    with PORT.faults.inject(plan):
        vd.verdicts(sc.flows[:3])
    assert br.state == br.OPEN
    now[0] = 2.0
    with pytest.raises(NotImplementedError):
        vd.verdicts([generic])
    assert br.state == br.OPEN
    vd.verdicts(sc.flows[:3])
    assert br.state == br.CLOSED
    assert [e for e, _ in br.events] == ["trip", "probe", "probe-released",
                                         "probe", "recover"]
    # over the socket: an error response naming Q13, for one request
    hub = PORT.hubble
    before = [m.get(n) for n in names]
    with served(PORT, ld, tmp_path / "q6.sock", deadline_ms=1.0) as svc, \
            client(PORT, svc) as c:
        for op in ({"op": "check", "flow": hub.flow_to_dict(generic)},
                   {"op": "verdict", "flows": [
                       hub.flow_to_dict(f) for f in (generic,
                                                     sc.flows[0])]}):
            r = c.call(op)
            assert "NotImplementedError" in r["error"] and "Q13" in r["error"]
        ok = c.call({"op": "check", "flow": hub.flow_to_dict(sc.flows[0])})
        assert ok["verdict"] == int(ld.engine.verdict_flows(
            sc.flows[:1])["verdict"][0])
        assert svc.verdictor.breaker.state == br.CLOSED
    assert [m.get(n) for n in names] == before


def failing_kd(monkeypatch):
    """Send every dense DFA scan through KD's ``Kernel.launch`` with its
    C entry point stubbed to return a CUDA error, as a KD that fails on
    the card would (on the CPU the engine reaches the plain version
    only). Returns the list of failed launches."""
    from cilium_tpu_torch.engine import _build, dfa_kernel

    kd = _build.KERNELS["KD"]
    failed = []
    err = {700: b"an illegal memory access was encountered"}
    monkeypatch.setattr(kd, "_fn", lambda *a: 700)
    monkeypatch.setattr(kd, "_lib", types.SimpleNamespace(
        ct_error_string=err.get))

    def dense_scan(*a, **k):
        failed.append(1)
        kd.launch(0, variant="smem")
        raise AssertionError("the stub launch returned")

    monkeypatch.setattr(dfa_kernel, "dense_scan", dense_scan)
    return failed


def test_kernel_failure_is_an_error_not_an_oracle_verdict(
        scenario_loaders, tmp_path, monkeypatch):
    """A KD launch that fails passes the breaker: the verdictor raises
    ``KernelError`` every time (no trip, no oracle verdict, a held
    probe released), and over the socket ``check`` and ``verdict``
    answer an error naming it."""
    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]
    want = [int(v) for v in ld.engine.verdict_flows(
        sc.flows[:3])["verdict"]]
    kd = PORT.service._build.KERNELS["KD"]
    launches0 = kd.launches
    failed = failing_kd(monkeypatch)
    m = PORT.metrics.METRICS
    names = ("cilium_tpu_breaker_trips_total",
             "cilium_tpu_breaker_fallback_verdicts_total")
    before = [m.get(n) for n in names]
    now = [0.0]
    br = PORT.service.CircuitBreaker(failure_threshold=1,
                                     probe_interval=1.0,
                                     clock=lambda: now[0])
    vd = PORT.service.ResilientVerdictor(ld, breaker=br)
    KernelError = PORT.service._build.KernelError
    for _ in range(3):
        with pytest.raises(KernelError, match="illegal memory access"):
            vd.verdicts(sc.flows[:3])
    assert len(failed) >= 3 and kd.launches == launches0
    assert br.state == br.CLOSED and br.events == []
    assert [m.get(n) for n in names] == before
    # a probe that meets a failed kernel is released, not answered by
    # the oracle
    monkeypatch.undo()
    plan = PORT.faults.FaultPlan([PORT.faults.FaultRule(
        "engine.dispatch", times=1)])
    with PORT.faults.inject(plan):
        vd.verdicts(sc.flows[:3])
    assert br.state == br.OPEN
    failing_kd(monkeypatch)
    now[0] = 2.0
    with pytest.raises(KernelError):
        vd.verdicts(sc.flows[:3])
    assert [e for e, _ in br.events] == ["trip", "probe", "probe-released"]
    monkeypatch.undo()
    assert vd.verdicts(sc.flows[:3]) == want
    assert br.state == br.CLOSED
    # over the socket: an error response for each request, breaker shut
    failing_kd(monkeypatch)
    hub = PORT.hubble
    before = [m.get(n) for n in names]
    with served(PORT, ld, tmp_path / "kd.sock", deadline_ms=1.0) as svc, \
            client(PORT, svc) as c:
        for op in ({"op": "check", "flow": hub.flow_to_dict(sc.flows[0])},
                   {"op": "verdict", "flows": [
                       hub.flow_to_dict(f) for f in sc.flows[:2]]}):
            r = c.call(op)
            assert r["error"].startswith("KernelError: dfa_dense kernel "
                                         "launch failed"), r
        assert svc.verdictor.breaker.state == br.CLOSED
    assert [m.get(n) for n in names] == before


def test_kernel_argument_errors_are_kernel_failures():
    """A wrapper's refused argument is a ``KernelError`` and still the
    ``ValueError``/``TypeError`` it was; a CUDA fault reported to torch
    counts as a kernel failure; running out of memory does not."""
    b = PORT.service._build
    assert issubclass(b.KernelArgumentError, (ValueError, TypeError))
    is_kf = b.is_kernel_failure
    assert is_kf(b.KernelArgumentError("x"))
    assert is_kf(RuntimeError("CUDA error: an illegal memory access was "
                              "encountered"))
    assert not is_kf(RuntimeError("CUDA out of memory. Tried to allocate"))
    assert not is_kf(PORT.faults.FaultInjected("engine.dispatch"))
    ps = PORT.service.passes_breaker
    assert ps(NotImplementedError("Q5")) and ps(b.KernelError("x"))
    assert not ps(ValueError("bad flow"))


# ========================================================= MicroBatcher
def _metric(pkg, name, labels=None):
    return pkg.metrics.METRICS.get(name, labels)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_batcher_hard_bound_sheds_explicitly(pkg):
    Verdict = pkg.flow.Verdict
    release = threading.Event()

    def slow_verdicts(flows):
        release.wait(5.0)
        return [int(Verdict.FORWARDED)] * len(flows)

    mb = pkg.service.MicroBatcher(slow_verdicts, batch_max=1,
                                  deadline_ms=0.0, max_pending=2)
    labels = {"surface": "batcher", "class": "data",
              "reason": "queue-full"}
    shed0 = _metric(pkg, "cilium_tpu_admission_shed_total", labels)
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        mb.check_ex(pkg.flow.Flow(), timeout=5.0))) for _ in range(6)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and len(results) < 3:
        time.sleep(0.005)
    release.set()
    for t in threads:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in threads)
    statuses = [s for _, s in results]
    assert statuses.count("shed") >= 1
    assert mb.peak_pending <= 2
    for v, s in results:
        assert (v, s) == ((int(Verdict.ERROR), "shed") if s == "shed"
                          else (int(Verdict.FORWARDED), "ok"))
    assert _metric(pkg, "cilium_tpu_admission_shed_total", labels) > shed0
    mb.close()


@pytest.mark.parametrize("how", ["abandoned", "expired"])
@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_batcher_reaps_before_dispatch(pkg, how):
    """An entry whose caller gave up (or whose deadline lapsed in the
    queue) is dropped before dispatch: the engine never sees it."""
    Verdict, Flow = pkg.flow.Verdict, pkg.flow.Flow
    gate_open = threading.Event()
    seen = []

    def verdicts(flows):
        seen.append([f.dport for f in flows])
        gate_open.wait(5.0)
        return [int(Verdict.FORWARDED)] * len(flows)

    mb = pkg.service.MicroBatcher(verdicts, batch_max=1, deadline_ms=0.0)
    reaped0 = _metric(pkg, "cilium_tpu_admission_reaped_total")
    t1 = threading.Thread(target=lambda: mb.check(Flow(dport=1),
                                                  timeout=5.0))
    t1.start()
    while not seen:
        time.sleep(0.005)
    t0 = time.monotonic()
    if how == "abandoned":
        got = mb.check_ex(Flow(dport=2), timeout=0.01)
    else:
        got = mb.check_ex(Flow(dport=2), timeout=5.0,
                          deadline=time.monotonic() + 0.02)
    waited = time.monotonic() - t0
    gate_open.set()
    t1.join(timeout=5.0)
    assert not t1.is_alive()
    assert got == (int(Verdict.ERROR), "timeout")
    assert waited < 2.0
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and \
            _metric(pkg, "cilium_tpu_admission_reaped_total") <= reaped0:
        time.sleep(0.005)
    assert _metric(pkg, "cilium_tpu_admission_reaped_total") > reaped0
    assert all(2 not in batch for batch in seen), seen
    mb.close()


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_batcher_drain_flushes_pending_close_aborts(pkg):
    Verdict, Flow = pkg.flow.Verdict, pkg.flow.Flow
    stall = threading.Event()

    def verdicts(flows):
        stall.wait(0.05)
        return [int(Verdict.FORWARDED)] * len(flows)

    mb = pkg.service.MicroBatcher(verdicts, batch_max=64,
                                  deadline_ms=50.0)
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        mb.check(Flow(), timeout=5.0))) for _ in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.02)
    stall.set()
    flushed = mb.drain(timeout=5.0)
    for t in threads:
        t.join(timeout=5.0)
    assert results and all(v == int(Verdict.FORWARDED) for v in results)
    assert flushed >= 1
    assert mb.drain() == 0
    assert mb.check_ex(Flow())[1] == "closed"

    stall2 = threading.Event()
    mb2 = pkg.service.MicroBatcher(
        lambda flows: (stall2.wait(5.0),
                       [int(Verdict.FORWARDED)] * len(flows))[1],
        batch_max=1, deadline_ms=0.0)
    r2 = []
    t1 = threading.Thread(target=lambda: r2.append(mb2.check(
        Flow(dport=1), timeout=5.0)))
    t1.start()
    time.sleep(0.02)
    t2 = threading.Thread(target=lambda: r2.append(mb2.check(
        Flow(dport=2), timeout=5.0)))
    t2.start()
    time.sleep(0.02)
    mb2.close(abort=True)
    stall2.set()
    t1.join(timeout=5.0)
    t2.join(timeout=5.0)
    assert not t1.is_alive() and not t2.is_alive()
    assert int(Verdict.ERROR) in r2


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_drain_workers_four_verdict_exactly(pkg, tmp_path):
    """Four drain workers: every request gets exactly ITS verdict —
    interleaved allow/deny traffic from eight threads."""
    per, svc_id = l4_world(pkg)
    ld = make_loader(pkg, tmp_path / "cache")
    ld.regenerate(per, revision=1)
    Verdict, Flow = pkg.flow.Verdict, pkg.flow.Flow
    results, lock = {}, threading.Lock()
    hist0 = pkg.metrics.METRICS.histo_sum("cilium_tpu_microbatch_size")
    try:
        with served(pkg, ld, tmp_path / "p.sock", deadline_ms=1.0,
                    batch_max=8, drain_workers=4) as svc:
            def worker(tid):
                with client(pkg, svc) as c:
                    out = []
                    for i in range(30):
                        dport = 80 if (tid + i) % 2 == 0 else 81
                        r = c.call({"op": "check",
                                    "flow": pkg.hubble.flow_to_dict(Flow(
                                        src_identity=9, dst_identity=svc_id,
                                        dport=dport))})
                        out.append((dport, r["verdict"]))
                with lock:
                    results[tid] = out

            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        ld.close()
    assert len(results) == 8
    for tid, out in results.items():
        assert len(out) == 30
        for dport, v in out:
            assert v == int(Verdict.FORWARDED if dport == 80
                            else Verdict.DROPPED), (tid, dport, v)
    assert pkg.metrics.METRICS.histo_sum(
        "cilium_tpu_microbatch_size") - hist0 == 240


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_verdict_flows_padded_count(pkg):
    """The batch reaches the engine padded to the next power of two;
    callers get exactly their own verdicts back."""
    seen = []

    class Stub:
        def verdict_flows(self, flows, authed_pairs=None, outputs=None):
            seen.append(len(flows))
            return {"verdict": np.arange(len(flows)) % 3}

    for n in (1, 3, 4, 5, 17):
        got = pkg.service.verdict_flows_padded(Stub(), [pkg.flow.Flow()] * n)
        assert got == [i % 3 for i in range(n)]
    assert seen == [1, 4, 4, 8, 32]


# ============================================== services side by side
def _kafka_frames(pkg, flows):
    """One request frame per kafka flow, at the classic layout the
    synthetic encoder writes (versions 0-2)."""
    return [pkg.kafka.encode_request(
        f.kafka.api_key, min(f.kafka.api_version, 2), i,
        f.kafka.client_id, f.kafka.topic) for i, f in enumerate(flows)]


def _http_frames(flows):
    out = []
    for f in flows:
        h = f.http
        lines = [f"{h.method} {h.path} HTTP/1.1", f"host: {h.host}"]
        lines += [f"{k}: {v}" for k, v in h.headers]
        out.append(("\r\n".join(lines) + "\r\n\r\n").encode())
    return out


def _session(pkg, svc, name, sc, dicts):
    """The same request script against one service → its responses."""
    flows = sc.flows
    out = []
    with client(pkg, svc) as c:
        call = lambda req: out.append(strip(c.call(req)))  # noqa: E731
        call({"op": "ping"})
        for d in dicts[:16]:
            call({"op": "check", "flow": d})
        call({"op": "verdict", "flows": dicts[:64]})
        call({"op": "verdict", "flows": []})
        call({"op": "status"})
        call({"op": "explain", "trace_id": "0123456789abcdef"})
        call({"op": "explain"})
        call({"op": "policy_get"})
        call({"op": "no-such-op"})
        call({"op": "on_data", "conn": 999, "data_b64": ""})
        call({"op": "on_new_connection", "proto": "nope", "conn": 5})
        l7 = {"kafka": "kafka", "http": "http"}.get(name)
        if l7 is not None:
            f0 = flows[0]
            call({"op": "on_new_connection", "proto": l7, "conn": 7,
                  "ingress": True, "src": f0.src_identity,
                  "dst": f0.dst_identity, "dport": f0.dport})
            frames = (_kafka_frames(pkg, flows[:24]) if l7 == "kafka"
                      else _http_frames(flows[:24]))
            # one frame a call, then the rest in one split stream
            for fr in frames[:12]:
                call({"op": "on_data", "conn": 7,
                      "data_b64": base64.b64encode(fr).decode()})
            blob = b"".join(frames[12:])
            for a, b in ((0, 7), (7, len(blob) // 2), (len(blob) // 2,
                                                      len(blob))):
                call({"op": "on_data", "conn": 7,
                      "data_b64": base64.b64encode(blob[a:b]).decode()})
            call({"op": "on_data", "conn": 7, "reply": True,
                  "data_b64": base64.b64encode(b"resp").decode()})
            call({"op": "close_connection", "conn": 7})
        pull = c.call({"op": "mapstate_pull"})
        call({"op": "drain"})
        call({"op": "check", "flow": dicts[0]})
        call({"op": "ping"})
    return out, pull


@pytest.mark.parametrize("name", ["http", "kafka", "fqdn"])
def test_services_answer_like_the_reference(scenario_loaders, tmp_path,
                                            name):
    # one set of wire requests for both services
    dicts = [JAX.hubble.flow_to_dict(f)
             for f in scenario_loaders[name]["cilium_tpu"][1].flows[:64]]
    resps = {}
    for pkg in PKGS:
        ld, sc = scenario_loaders[name][pkg.root]
        with served(pkg, ld, tmp_path / f"{pkg.root}.sock",
                    deadline_ms=1.0) as svc:
            resps[pkg.root] = _session(pkg, svc, name, sc, dicts)
    (want, want_pull), (got, got_pull) = (resps["cilium_tpu"],
                                          resps["cilium_tpu_torch"])
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, w, g)
    # mapstate_pull: the NPDS blob byte-equal
    assert got_pull["revision"] == want_pull["revision"] == 1
    assert base64.b64decode(got_pull["npds_b64"]) == \
        base64.b64decode(want_pull["npds_b64"])
    # the verdicts are the engine's, and some of each kind
    ld, sc = scenario_loaders[name]["cilium_tpu_torch"]
    plain = [int(v) for v in ld.engine.verdict_flows(
        sc.flows[:64])["verdict"]]
    assert [r["verdict"] for r in got[1:17]] == plain[:16]
    assert got[17]["verdicts"] == plain
    assert len(set(plain)) > 1
    assert got[-3]["warm_snapshot"] is True
    assert got[-2].get("shed") is True  # a drained service sheds data
    if name != "fqdn":
        ops = [r["ops"] for r in got if "ops" in r]
        assert any(o[0] == 1 for r in ops for o in r)      # a PASS
        assert any(o[0] == 2 for r in ops for o in r)      # a DROP


def test_metrics_op_exposes_the_service_families(scenario_loaders,
                                                 tmp_path):
    ld, sc = scenario_loaders["http"]["cilium_tpu_torch"]
    with served(PORT, ld, tmp_path / "m.sock", deadline_ms=1.0) as svc, \
            client(PORT, svc) as c:
        c.call({"op": "check",
                "flow": PORT.hubble.flow_to_dict(sc.flows[0])})
        c.call({"op": "mapstate_pull"})
        text = c.call({"op": "metrics"})["text"]
    for family in ("cilium_tpu_microbatch_size_bucket",
                   "cilium_tpu_microbatch_seconds_count",
                   "cilium_tpu_npds_pulls_total",
                   "cilium_tpu_breaker_state"):
        assert family in text, family
    assert 'le="+Inf"' in text


# ============================================================ C++ shim
@pytest.fixture(scope="module")
def shim_lib():
    path = os.path.join(REPO, "shim", "libcilium_shim.so")
    if not os.path.exists(path):
        subprocess.run(["make", "-C", os.path.join(REPO, "shim")],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(path)
    lib.cshim_connect.argtypes = [ctypes.c_char_p]
    lib.cshim_on_new_connection.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_char_p]
    lib.cshim_on_data.argtypes = [
        ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.cshim_take_inject.argtypes = [
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]
    lib.cshim_take_inject.restype = ctypes.c_long
    lib.cshim_close_connection.argtypes = [ctypes.c_uint64]
    lib.cshim_disconnect.restype = None
    return lib


def test_cpp_shim_drives_the_port_service(shim_lib, proxy_loaders,
                                          tmp_path):
    """The reference's C++ shim over the port's socket: Kafka records
    PASS, DROP with the broker-shaped error INJECTed, as the
    reference's own shim test expects of the reference's service."""
    import struct

    ld, ids = proxy_loaders["cilium_tpu_torch"]
    enc = PORT.kafka.encode_request
    OpType = PORT.proxylib.OpType
    with served(PORT, ld, tmp_path / "shim.sock", deadline_ms=1.0) as svc:
        assert shim_lib.cshim_connect(svc.socket_path.encode()) == 0
        try:
            assert shim_lib.cshim_on_new_connection(
                b"kafka", 77, 1, ids["cli"], ids["kafka"], 9092, b"") == 0
            for corr in range(4):
                good = enc(0, 1, 2 * corr + 1, "c", "allowed-topic")
                bad = enc(0, 1, 2 * corr + 2, "c", f"evil-topic-{corr}")
                payload = good + bad
                buf = (ctypes.c_uint8 * len(payload)).from_buffer_copy(
                    payload)
                ops = (ctypes.c_int32 * 16)()
                n = shim_lib.cshim_on_data(77, 0, 0, buf, len(payload),
                                           ops, 8)
                assert n == 3
                assert (ops[0], ops[1]) == (int(OpType.PASS), len(good))
                assert ops[2] == int(OpType.INJECT)
                assert (ops[4], ops[5]) == (int(OpType.DROP), len(bad))
                ibuf = (ctypes.c_uint8 * 512)()
                ilen = shim_lib.cshim_take_inject(77, ibuf, 512)
                err = bytes(ibuf[:ilen])
                size, correlation = struct.unpack_from(">ii", err, 0)
                assert size == len(err) - 4 and correlation == 2 * corr + 2
                (tlen,) = struct.unpack_from(">h", err, 12)
                assert err[14:14 + tlen].decode() == f"evil-topic-{corr}"
                (_, _, code) = struct.unpack_from(">iih", err, 14 + tlen)
                assert code == PORT.kafka.ERR_TOPIC_AUTHORIZATION_FAILED
            assert shim_lib.cshim_close_connection(77) == 0
        finally:
            shim_lib.cshim_disconnect()


# ======================================== launch counts under threads
def test_kernel_launch_counts_exact_under_threads():
    """Eight threads launch one kernel through a stub C entry point:
    the counts (total and by variant) come out exact, and the library
    loads once."""
    from cilium_tpu_torch.engine import _build

    k = _build.Kernel("stub", "stub.cu", "ct_stub", [], replaces="x:1")
    loads = []

    def load():
        loads.append(1)
        time.sleep(0.01)  # widen the window a second load would use
        k._lib, k._fn = types.SimpleNamespace(), lambda *a: 0

    k._load = load
    n, per = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            k.launch(variant=("a", "b")[(i + j) % 2]) for j in range(per)])
            for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert loads == [1]
    assert k.launches == n * per
    assert k.launches_by_variant == {"a": n * per // 2, "b": n * per // 2}
    k.reset()
    assert (k.launches, k.launches_by_variant) == (0, {})
