"""The port's observability plane — the monitor, the Hubble ring,
observer, filters, metrics, exporter and their sockets — against the
JAX package's, on the CPU.

* ``FlowRing`` reads, writes and losses; ``annotate_flows`` on each
  package's engine outputs for the same flows, with and without an
  ``AttributionMap`` and a served pack's provenance, inside and outside
  a trace; ``FlowFilter.matches`` over a grid of fields and flows, a
  bad regex included; ``Observer.get_flows`` with ``since_seq``,
  ``limit``, ``with_seq`` and overflow (seqs, flows, ``lost_reported``);
* ``events_from_outputs`` at each ``AggregationLevel``, the
  ``MonitorAgent``'s fan-out and its detach of a raising listener, and
  ``cilium_tpu_monitor_events_total``; ``MonitorServer`` and
  ``monitor_follow`` over a socket by level and types, a bad
  subscription's error, and a slow subscriber's ``lost`` count;
* ``filter_to_dict`` / ``filter_from_dict``; ``HubbleServer`` /
  ``HubbleClient`` answers to ``get_flows`` (filters, limits, resume,
  follow), ``server_status``, ``peers`` without a relay and an unknown
  op; an ``AccessLogServer`` record in the observer with its metrics;
  ``FlowMetrics``' series; ``FlowExporter``'s lines and rotation;
* the slice as a whole: the http policy through each package's
  ``Loader``, a flowpb capture through ``replay_chunks`` →
  ``verdict_flows`` → the fan-out sequence (``notify_batch``,
  ``annotate_flows``, ``observe``), and a ``PolicyBridge`` whose
  ``accesslog_fn`` does the service's LOG sink's work; the ring, the
  monitor's events, the exporter's file and the metric deltas equal.

Stamps that are not data are pinned alike in both packages: the wall
clock (``simclock.wall``), the trace id (a trace opened with a fixed id)
and the policy generation an unserved flow cites; ``Observer.instance``
is left out. Sockets live in short ``tempfile.mkdtemp()`` directories
(a unix socket path must stay under 108 bytes); every read has a
timeout and every server stops in a ``finally``.

Mirrors ``tests/test_observability.py``, ``tests/test_monitor_socket.py``,
``tests/test_hubble_server.py`` and ``tests/test_accesslog_server.py``
with the agent's wiring done by hand (the agent is not ported yet).
"""

import contextlib
import importlib
import json
import os
import shutil
import socket
import tempfile
import threading
import time
import types

import numpy as np
import pytest

from test_torch_service import make_loader, proxy_world

WALL = 1753866000.25
LANES = ("verdict", "match_spec", "ruleset", "allowed", "l3l4_allowed",
         "redirect", "l7_ok", "l7_log", "auth_required", "l7_match")


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in (("flow", "core.flow"),
                      ("monitor", "monitor"),
                      ("ring", "hubble.ring"),
                      ("observer", "hubble.observer"),
                      ("hmetrics", "hubble.metrics"),
                      ("exporter", "hubble.exporter"),
                      ("server", "hubble.server"),
                      ("alserver", "hubble.accesslog_server"),
                      ("hubble", "ingest.hubble"),
                      ("flowpb", "ingest.flowpb"),
                      ("cursor", "ingest.cursor"),
                      ("synth", "ingest.synth"),
                      ("config", "core.config"),
                      ("loader", "runtime.loader"),
                      ("metrics", "runtime.metrics"),
                      ("memo", "engine.memo"),
                      ("simclock", "runtime.simclock"),
                      ("tracing", "runtime.tracing"),
                      ("service", "runtime.service"),
                      ("proxylib", "proxylib"),
                      ("api", "policy.api"),
                      ("identity", "core.identity"),
                      ("labels", "core.labels"),
                      ("mapstate", "policy.mapstate"),
                      ("repository", "policy.repository"),
                      ("selectorcache", "policy.selectorcache")):
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    ns.unenforced = (importlib.import_module("cilium_tpu.auth")
                     if ns.jax else importlib.import_module(
                         "cilium_tpu_torch.engine.verdict")
                     ).AUTH_UNENFORCED
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")
PKGS = (JAX, PORT)


@pytest.fixture
def frozen(monkeypatch):
    """The wall clock and the generation an unserved flow cites, pinned
    alike in both packages."""
    for pkg in PKGS:
        monkeypatch.setattr(pkg.simclock, "wall", lambda: WALL)
        monkeypatch.setattr(pkg.memo, "policy_generation", lambda: 5)


@contextlib.contextmanager
def sockdir():
    d = tempfile.mkdtemp(prefix="ctobs")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _dicts(pkg, flows):
    return [pkg.hubble.flow_to_dict(f) for f in flows]


def _events(pkg, events):
    return [pkg.monitor.event_to_dict(e) for e in events]


def _counters(pkg, metrics=None, prefix=""):
    m = metrics if metrics is not None else pkg.metrics.METRICS
    with m._lock:
        return {k: v for k, v in m._counters.items()
                if k[0].startswith(prefix)}


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def sample_flows(pkg, n=12):
    """HTTP, DNS, Kafka and L4 flows with labels and node names."""
    F = pkg.flow
    out = []
    for i in range(n):
        kind = i % 4
        f = F.Flow(src_identity=100 + i, dst_identity=200 + i % 3,
                   dport=(80, 53, 9092, 443)[kind], sport=1000 + i,
                   protocol=F.Protocol.UDP if kind == 1 else F.Protocol.TCP,
                   direction=(F.TrafficDirection.EGRESS if i % 5 == 0
                              else F.TrafficDirection.INGRESS),
                   verdict=(F.Verdict.DROPPED if i % 3 == 0
                            else F.Verdict.FORWARDED),
                   node_name=f"node-{'ab'[i % 2]}",
                   src_labels=(f"k8s:app=frontend{i % 2}",),
                   dst_labels=("reserved:world",) if i % 4 == 3 else ())
        if kind == 0:
            f.l7 = F.L7Type.HTTP
            f.http = F.HTTPInfo(method=("GET", "POST")[i % 2],
                                path=f"/api/v{i % 3}/items/{i}",
                                headers=(("X-I", str(i)),))
        elif kind == 1:
            f.l7 = F.L7Type.DNS
            f.dns = F.DNSInfo(query=f"svc{i}.example.com",
                              qtypes=("A", "AAAA")[:1 + i % 2])
        elif kind == 2:
            f.l7 = F.L7Type.KAFKA
            f.kafka = F.KafkaInfo(api_key=i % 2, topic=f"t{i}")
        out.append(f)
    return out


# ------------------------------------------------------------- the ring
def test_flow_ring_reads_writes_and_losses():
    got = {}
    for pkg in PKGS:
        with pytest.raises(ValueError):
            pkg.ring.FlowRing(0)
        r = pkg.ring.FlowRing(4)
        flows = sample_flows(pkg, 9)
        log = [r.write(flows[0]), r.next_seq, r.oldest_seq]
        r.write_many(flows[1:7])
        log += [r.next_seq, r.oldest_seq, r.wait_for(6, timeout=0.01),
                r.wait_for(7, timeout=0.01)]
        for seq in (0, 2, 3, 6, 7, 100):
            flow, lost = r.read(seq)
            log.append((None if flow is None
                        else pkg.hubble.flow_to_dict(flow), lost))
        got[pkg.root] = log
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    assert got["cilium_tpu_torch"][:7] == [0, 1, 0, 7, 3, True, False]


# ------------------------------------------------------------ annotate
@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """pkg root → (loader, scenario flows) at http 12 × 240."""
    out = {}
    for pkg in PKGS:
        per_identity, sc = pkg.synth.realize_scenario(
            pkg.synth.scenario_by_name("http", 12, 240))
        ld = make_loader(pkg, tmp_path_factory.mktemp(pkg.root))
        ld.regenerate(per_identity, revision=1)
        out[pkg.root] = (ld, sc.flows)
    yield out
    for ld, _ in out.values():
        ld.close()


def _outputs(pkg, engines):
    ld, flows = engines[pkg.root]
    out = ld.engine.verdict_flows(flows, authed_pairs=pkg.unenforced)
    return ld, flows, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("mode", ["plain", "amap", "amap-prov",
                                  "verdict-only", "traced"])
def test_annotate_flows_equals_the_reference(frozen, engines, mode):
    got = {}
    for pkg in PKGS:
        ld, flows, out = _outputs(pkg, engines)
        flows = [pkg.hubble.flow_from_dict(pkg.hubble.flow_to_dict(f))
                 for f in flows]
        kw = {}
        if mode.startswith("amap"):
            kw["amap"] = ld.engine.attribution
        if mode == "amap-prov":
            n = len(flows)
            kw["prov"] = types.SimpleNamespace(
                gens=np.arange(n) % 4, memo_hit=np.arange(n) % 3 == 0,
                kernel="fused", pack_cycle=9)
        if mode == "verdict-only":
            out = {"verdict": out["verdict"]}
        trace = (pkg.tracing.TRACER.trace("replay.chunk", trace_id="t-17")
                 if mode == "traced" else contextlib.nullcontext())
        with trace:
            res = pkg.observer.annotate_flows(flows, out, **kw)
        assert res is flows
        got[pkg.root] = _dicts(pkg, flows)
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    d = got["cilium_tpu_torch"]
    assert all(x["time"] == WALL for x in d)
    assert all((x.get("trace_id") == "t-17") == (mode == "traced")
               for x in d)
    if mode.startswith("amap"):
        assert any(x.get("provenance", {}).get("rule") for x in d)
    assert {x.get("policy_match_type", 0) for x in d} > {0}


def test_annotate_keeps_a_flows_own_time_and_trace(frozen):
    got = {}
    for pkg in PKGS:
        flows = sample_flows(pkg, 4)
        flows[0].time, flows[1].trace_id = 7.5, "own"
        out = {"verdict": np.array([1, 2, 5, 1]),
               "match_spec": np.array([7, 9, 3]),
               "l7_match": np.array([-1, -1, 2, 0])}
        with pkg.tracing.TRACER.trace("t", trace_id="outer"):
            pkg.observer.annotate_flows(flows, out, stamp_time=False)
        got[pkg.root] = _dicts(pkg, flows)
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]


# ------------------------------------------------------------- filters
def _filters(pkg):
    F, FF = pkg.flow, pkg.observer.FlowFilter
    return [FF(), FF(verdict=F.Verdict.DROPPED), FF(l7_type=F.L7Type.DNS),
            FF(src_identity=104), FF(dst_identity=201), FF(dport=9092),
            FF(protocol=17), FF(http_method="GET|HEAD"),
            FF(http_method="^POST$"), FF(http_path="/api/v[0-9]+/"),
            FF(http_path="/admin"), FF(http_path="/"), FF(http_path="["),
            FF(dns_query=r"example\.com$"), FF(dns_query="^evil"),
            FF(node_name="node-[ab]"), FF(node_name="node-b"),
            FF(source_label="app=frontend1"),
            FF(destination_label="reserved:world"),
            FF(verdict=F.Verdict.FORWARDED, l7_type=F.L7Type.HTTP,
               http_path="items")]


def test_flow_filter_grid_equals_the_reference():
    grids = {p.root: [[flt.matches(f) for f in sample_flows(p)]
                      for flt in _filters(p)] for p in PKGS}
    assert grids["cilium_tpu_torch"] == grids["cilium_tpu"]
    assert not any(grids["cilium_tpu_torch"][12])      # bad regex
    assert all(grids["cilium_tpu_torch"][0])


def test_filter_serde_round_trips():
    for jf, pf in zip(_filters(JAX), _filters(PORT)):
        d = PORT.server.filter_to_dict(pf)
        assert d == JAX.server.filter_to_dict(jf)
        assert PORT.server.filter_from_dict(d) == pf
        assert json.loads(json.dumps(d)) == d
    assert PORT.server.filter_to_dict(None) is None
    assert PORT.server.filter_from_dict({}) is None


# ------------------------------------------------------------ observer
def test_observer_get_flows_equals_the_reference():
    got = {}
    for pkg in PKGS:
        obs = pkg.observer.Observer(capacity=8)
        flows = sample_flows(pkg, 20)
        obs.observe(flows[:5])
        obs.observe(flows[5:20])
        log = [obs.seen, obs.ring.oldest_seq, obs.ring.next_seq]
        for kw in ({}, {"since_seq": 0}, {"since_seq": 14, "limit": 3},
                   {"since_seq": 25}, {"with_seq": True, "limit": 2},
                   {"with_seq": True, "since_seq": 3},
                   {"flt": _filters(pkg)[1], "with_seq": True},
                   {"follow": True, "timeout": 0.05, "since_seq": 19}):
            res = list(obs.get_flows(**kw))
            log.append(([(s, pkg.hubble.flow_to_dict(f)) for s, f in res]
                        if kw.get("with_seq") else _dicts(pkg, res),
                        obs.lost_reported))
        got[pkg.root] = log
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    assert got["cilium_tpu_torch"][:3] == [20, 12, 20]


def test_observer_serializes_concurrent_writers():
    for pkg in PKGS:
        m = pkg.metrics.Metrics()
        obs = pkg.observer.Observer(
            capacity=1 << 12, handlers=[pkg.hmetrics.FlowMetrics(m)])
        flows = sample_flows(pkg, 16)
        ts = [threading.Thread(target=lambda: [obs.observe(flows)
                                               for _ in range(25)])
              for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert obs.seen == obs.ring.next_seq == 4 * 25 * 16
        assert sum(v for k, v in m._counters.items()
                   if k[0] == "hubble_flows_processed_total") == obs.seen


# ------------------------------------------------- metrics, exporter
def test_flow_metrics_series_equal_the_reference():
    got = {}
    for pkg in PKGS:
        m = pkg.metrics.Metrics()
        flows = sample_flows(pkg, 24)
        flows[3].drop_reason = "auth"
        pkg.hmetrics.FlowMetrics(m).process(flows)
        got[pkg.root] = _counters(pkg, m)
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    names = {k[0] for k in got["cilium_tpu_torch"]}
    assert names == {"hubble_flows_processed_total",
                     "cilium_tpu_drop_count_total",
                     "cilium_tpu_policy_l7_total",
                     "hubble_dns_queries_total",
                     "hubble_http_requests_total"}


def test_exporter_lines_and_rotation_equal_the_reference(tmp_path):
    got = {}
    for pkg in PKGS:
        path = str(tmp_path / pkg.root / "flows.jsonl")
        ex = pkg.exporter.FlowExporter(path, max_bytes=1500)
        for i in range(4):
            ex.process(sample_flows(pkg, 3 + i))
        ex.close()
        files = []
        for p in (path, path + ".1"):
            with open(p) as fp:
                files.append(fp.read())
        got[pkg.root] = files
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    rotated, live = got["cilium_tpu_torch"][1], got["cilium_tpu_torch"][0]
    assert rotated and len(rotated.encode()) > 1500
    assert all(json.loads(x) for x in live.splitlines())


# ------------------------------------------------------------- monitor
def _outs(pkg):
    return {"verdict": np.array([1, 2, 1, 5, 2, 4]),
            "match_spec": np.array([7, 9, 3, -1, 8])}


@pytest.mark.parametrize("level", ["NONE", "LOW", "MEDIUM", "MAXIMUM"])
@pytest.mark.parametrize("specs", [True, False], ids=["specs", "no-specs"])
def test_events_from_outputs_equal_the_reference(frozen, level, specs):
    got = {}
    for pkg in PKGS:
        out = _outs(pkg)
        if not specs:
            del out["match_spec"]
        evs = pkg.monitor.events_from_outputs(
            sample_flows(pkg, 6), out, pkg.monitor.AggregationLevel[level])
        got[pkg.root] = _events(pkg, evs)
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    types_ = [e["type"] for e in got["cilium_tpu_torch"]]
    assert types_.count("DROP") == 2
    assert ("TRACE" in types_) == (level in ("NONE", "LOW"))


def test_monitor_agent_fan_out_and_detach(frozen):
    got = {}
    for pkg in PKGS:
        M = pkg.monitor
        ma = M.MonitorAgent(level=M.AggregationLevel.MEDIUM)
        seen, batches = [], []
        ma.subscribe(seen.append)

        def broken(ev):
            raise RuntimeError("consumer crashed")

        def broken_batch(flows, outputs):
            raise RuntimeError("tap crashed")

        ma.subscribe(broken)
        ma.subscribe_batch(lambda f, o: batches.append(len(f)))
        ma.subscribe_batch(broken_batch)
        before = _counters(pkg, prefix="cilium_tpu_monitor_events_total")
        r1 = ma.notify_batch(sample_flows(pkg, 2),
                             {"verdict": np.array([1, 2])})
        n1, lost1 = ma.num_listeners(), ma.lost
        r2 = ma.notify_batch(sample_flows(pkg, 1), {"verdict": np.array([1])})
        ma.unsubscribe(seen.append)
        ma.unsubscribe(seen.append)               # twice is fine
        got[pkg.root] = (_events(pkg, r1), _events(pkg, r2),
                         _events(pkg, seen), batches, n1, lost1,
                         ma.num_listeners(), ma.lost,
                         _delta(before, _counters(
                             pkg, prefix="cilium_tpu_monitor_events_total")))
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    g = got["cilium_tpu_torch"]
    assert (len(g[2]), g[3], g[4], g[5], g[6]) == (4, [2, 1], 1, 2, 0)


def _follow(pkg, path, **kw):
    stream = pkg.monitor.monitor_follow(path, **kw)
    stream._sock.settimeout(10.0)
    return stream


def _wait(cond, what, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def test_monitor_socket_streams_by_level_and_type(frozen):
    got = {}
    for pkg in PKGS:
        M = pkg.monitor
        with sockdir() as d:
            agent = M.MonitorAgent()
            srv = M.MonitorServer(agent, os.path.join(d, "monitor.sock"))
            srv.start()
            streams = []
            try:
                errors = []
                for kw in ({"level": "bogus"}, {"types": ["nope"]}):
                    with pytest.raises(ValueError) as e:
                        _follow(pkg, srv.socket_path, **kw)
                    errors.append(str(e.value))
                streams = [_follow(pkg, srv.socket_path, level="none"),
                           _follow(pkg, srv.socket_path, types=["drop"]),
                           _follow(pkg, srv.socket_path, level="maximum",
                                   types=["policy_verdict", "trace"])]
                _wait(lambda: srv.num_clients() == 3, "3 subscribers")
                flows = sample_flows(pkg, 6)
                agent.notify_batch(flows, _outs(pkg))
                want = [len(M.events_from_outputs(
                    flows, _outs(pkg), M.AggregationLevel.NONE)), 2, 6]
                events = [[next(s) for _ in range(n)]
                          for s, n in zip(streams, want)]
            finally:
                for s in streams:
                    s.close()
                srv.stop()
            got[pkg.root] = (errors, events)
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    errors, events = got["cilium_tpu_torch"]
    assert errors == ["bad level 'bogus'", "bad type in ['nope']"]
    assert {e["type"] for e in events[1]} == {"DROP"}
    assert {e["type"] for e in events[2]} == {"POLICY_VERDICT"}


def test_monitor_slow_subscriber_counts_its_losses(frozen):
    """A subscriber whose queue overflows loses events into its own
    ``lost`` count and never stalls the batch: what it reads plus what
    it lost is every event at its level."""
    for pkg in PKGS:
        M = pkg.monitor
        with sockdir() as d:
            agent = M.MonitorAgent()
            srv = M.MonitorServer(agent, os.path.join(d, "m.sock"),
                                  queue_max=4)
            srv.start()
            stream = _follow(pkg, srv.socket_path, level="none")
            try:
                _wait(lambda: srv.num_clients() == 1, "a subscriber")
                client = srv._clients[0]
                flows = sample_flows(pkg, 6)
                total = 0
                for _ in range(20):
                    total += len(M.events_from_outputs(
                        flows, _outs(pkg), M.AggregationLevel.NONE))
                    agent.notify_batch(flows, _outs(pkg))
                read = 0
                stream._sock.settimeout(1.0)
                with contextlib.suppress(OSError):
                    while read + client.lost < total:
                        next(stream)
                        read += 1
                assert read + client.lost == total and client.lost > 0
            finally:
                stream.close()
                srv.stop()


def test_monitor_server_refuses_a_live_socket_and_a_file():
    for pkg in PKGS:
        M = pkg.monitor
        with sockdir() as d:
            path = os.path.join(d, "m.sock")
            live = M.MonitorServer(M.MonitorAgent(), path).start()
            try:
                with pytest.raises(FileExistsError, match="live"):
                    M.MonitorServer(M.MonitorAgent(), path).start()
            finally:
                live.stop()
            with open(path, "w") as fp:
                fp.write("x")
            with pytest.raises(FileExistsError, match="not a socket"):
                M.MonitorServer(M.MonitorAgent(), path).start()
            os.unlink(path)
            stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            stale.bind(path)
            stale.close()                 # a dead leftover socket
            M.MonitorServer(M.MonitorAgent(), path).start().stop()


# -------------------------------------------------------- hubble socket
def _hubble_answers(pkg, d):
    obs = pkg.observer.Observer(capacity=16)
    obs.observe(sample_flows(pkg, 12))
    srv = pkg.server.HubbleServer(obs, os.path.join(d, "hubble.sock"))
    srv.start()
    try:
        c = pkg.server.HubbleClient(srv.socket_path)
        out = [list(c.get_flows()),
               list(c.get_flows(flt={"verdict": "DROPPED"})),
               list(c.get_flows(flt={"http_path": "/api/v1/",
                                     "l7_type": "HTTP"})),
               list(c.get_flows(flt={"dport": 9092}, limit=1)),
               list(c.get_flows(limit=3)), c.last_seq,
               list(c.get_flows(since_seq=c.last_seq + 1, limit=2)),
               {k: v for k, v in c.server_status().items()
                if k != "instance"},
               c.peers(), next(iter(c._request({"op": "wat"}))),
               next(iter(c._request({"filter": None})))]
        with pytest.raises(RuntimeError) as e:
            list(c.get_flows(flt={"verdict": "NOPE"}))
        out.append(str(e.value))
        # follow: a client thread receives the flows observed after it
        # attached, then the window lapses
        got = []
        t = threading.Thread(target=lambda: got.extend(c.get_flows(
            follow=True, timeout=1.0, since_seq=12, limit=3)))
        t.start()
        time.sleep(0.1)
        obs.observe(sample_flows(pkg, 3))
        t.join(timeout=10)
        assert not t.is_alive()
        out.append(got)
        # a raw bad line is an error line
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(10.0)
            s.connect(srv.socket_path)
            s.sendall(b"{nope\n")
            out.append(json.loads(s.makefile().readline()))
        assert len(srv.observer.instance) == 32
        return out
    finally:
        srv.stop()


def test_hubble_server_answers_equal_the_reference():
    got = {}
    for pkg in PKGS:
        with sockdir() as d:
            got[pkg.root] = _hubble_answers(pkg, d)
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    g = got["cilium_tpu_torch"]
    assert len(g[0]) == 12 and len(g[1]) == 4 and g[5] == 2
    assert g[7]["seen"] == 12 and g[7]["ring_capacity"] == 16
    assert g[8] == {"error": "not a relay"}
    assert g[9] == {"error": "unknown op 'wat'"}
    assert len(g[-2]) == 3


def test_hubble_client_close_cancels_and_sticks():
    for pkg in PKGS:
        with sockdir() as d:
            obs = pkg.observer.Observer()
            srv = pkg.server.HubbleServer(obs, os.path.join(d, "h.sock"))
            srv.start()
            try:
                c = pkg.server.HubbleClient(srv.socket_path)
                res = []

                def follow():
                    try:
                        list(c.get_flows(follow=True, timeout=30.0))
                    except (ConnectionError, OSError) as e:
                        res.append(type(e).__name__)

                t = threading.Thread(target=follow)
                t.start()
                time.sleep(0.2)
                c.close()
                t.join(timeout=10)
                assert not t.is_alive() and res
                with pytest.raises(ConnectionError, match="client closed"):
                    c.server_status()
            finally:
                srv.stop()
            assert not os.path.exists(os.path.join(d, "h.sock"))


# ------------------------------------------------------ access-log socket
def test_accesslog_server_records_reach_the_observer(frozen):
    lines = [json.dumps({"entry_type": "Request", "is_ingress": True,
                         "source_security_id": 101,
                         "destination_security_id": 202,
                         "destination_address": "10.0.0.2:80",
                         "http": {"method": "GET", "path": "/a",
                                  "host": "svc.local"}}),
             "{not json",
             json.dumps({"traffic_direction": "INGRESS",
                         "verdict": "FORWARDED",
                         "source": {"identity": 101},
                         "destination": {"identity": 202},
                         "l4": {"TCP": {"destination_port": 9092}},
                         "l7": {"kafka": {"api_key": 1, "api_version": 2,
                                          "topic": "t"}}}),
             ""]
    got = {}
    for pkg in PKGS:
        with sockdir() as d:
            obs = pkg.observer.Observer()
            before = _counters(pkg, prefix="cilium_tpu_accesslog")
            srv = pkg.alserver.AccessLogServer(
                obs, os.path.join(d, "accesslog.sock")).start()
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.connect(srv.socket_path)
                    # one record split across two sends, the last one
                    # without its newline
                    blob = "\n".join(lines).encode()
                    s.sendall(blob[:37])
                    time.sleep(0.05)
                    s.sendall(blob[37:])
                _wait(lambda: obs.seen >= 2, "two records")
            finally:
                srv.stop()
            got[pkg.root] = (obs.seen, _dicts(pkg, obs.get_flows()),
                             _delta(before, _counters(
                                 pkg, prefix="cilium_tpu_accesslog")))
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    seen, flows, delta = got["cilium_tpu_torch"]
    assert seen == 2 and flows[0]["l7"]["http"]["url"] == "/a"
    assert delta == {("cilium_tpu_accesslog_records_total", ()): 2.0,
                     ("cilium_tpu_accesslog_decode_errors_total", ()): 1.0}


def test_accesslog_server_skips_a_line_that_is_not_an_object():
    """The port's one deviation here: valid JSON that is not an object
    is counted and skipped, and the connection goes on (the
    reference's ``AttributeError`` ends the connection's thread)."""
    with sockdir() as d:
        obs = PORT.observer.Observer()
        before = _counters(PORT, prefix="cilium_tpu_accesslog")
        srv = PORT.alserver.AccessLogServer(
            obs, os.path.join(d, "a.sock")).start()
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.connect(srv.socket_path)
                s.sendall(b'[1, 2]\n7\n{"source": {"identity": 3}}\n')
                _wait(lambda: obs.seen >= 1, "the record after the list")
                s.sendall(b'{"source": {"identity": 4}}\n')
                _wait(lambda: obs.seen >= 2, "a record on the same link")
        finally:
            srv.stop()
    assert [f.src_identity for f in obs.get_flows()] == [3, 4]
    assert _delta(before, _counters(PORT, prefix="cilium_tpu_accesslog")) \
        == {("cilium_tpu_accesslog_records_total", ()): 2.0,
            ("cilium_tpu_accesslog_decode_errors_total", ()): 2.0}


# ------------------------------------------------------- the whole slice
def _log_bridge(pkg, tmp, observer):
    """A ``PolicyBridge`` over the LOG-action policy whose
    ``accesslog_fn`` does what the service's LOG sink does."""
    per, ids = proxy_world(pkg, log_action=True)
    ld = make_loader(pkg, tmp / f"{pkg.root}-log")
    ld.regenerate(per, revision=1)

    def accesslog(flow):
        if not flow.time:
            flow.time = pkg.simclock.wall()
        flow.policy_match_type = pkg.flow.PolicyMatchType.L7
        observer.observe([flow])

    bridge = pkg.service.PolicyBridge(ld, deadline_ms=1.0,
                                      accesslog_fn=accesslog)
    conn = pkg.proxylib.Connection(
        proto="http", connection_id=1, ingress=True,
        src_identity=ids["cli"], dst_identity=ids["web"], dport=80)
    return ld, bridge, bridge.policy_check(conn)


def _slice(pkg, tmp, engines):
    ld, flows = engines[pkg.root]
    capture = str(tmp / f"{pkg.root}.pb")
    pkg.flowpb.write_pb_capture(capture, flows)
    m = pkg.metrics.Metrics()
    observer = pkg.observer.Observer(handlers=[
        pkg.hmetrics.FlowMetrics(m),
        pkg.exporter.FlowExporter(str(tmp / pkg.root / "flows.jsonl"))])
    monitor = pkg.monitor.MonitorAgent()
    events = []
    monitor.subscribe(events.append)
    before = _counters(pkg, prefix="cilium_tpu_monitor_events_total")
    log_ld, bridge, check = _log_bridge(pkg, tmp, observer)
    try:
        returned = []
        for i, (_, chunk) in enumerate(pkg.cursor.replay_chunks(
                capture, chunk_size=96)):
            with pkg.tracing.TRACER.trace("replay.chunk", trace_id="t-1"):
                out = {k: np.asarray(v) for k, v in ld.engine.verdict_flows(
                    chunk, authed_pairs=pkg.unenforced).items()}
                returned += monitor.notify_batch(chunk, out)
                pkg.observer.annotate_flows(
                    chunk, out, amap=ld.engine.attribution)
                observer.observe(chunk)
            # LOG-action records between the chunks: a mismatch is
            # logged, a satisfied match and a denial are not
            H = pkg.flow.HTTPInfo
            logged = [check(H(method="GET", path=f"/ok/{i}")),
                      check(H(method="GET", path="/ok/y",
                              headers=(("X-Trace", "on"),))),
                      check(H(method="GET", path="/no"))]
            assert logged == [True, True, False]
    finally:
        bridge.batcher.close()
        log_ld.close()
        for h in observer.handlers:
            if hasattr(h, "close"):
                h.close()
    with open(tmp / pkg.root / "flows.jsonl") as fp:
        exported = fp.read().splitlines()
    return {"ring": _dicts(pkg, observer.get_flows()),
            "seen": observer.seen, "events": _events(pkg, events),
            "returned": _events(pkg, returned), "exported": exported,
            "flow_metrics": _counters(pkg, m),
            "monitor_metrics": _delta(before, _counters(
                pkg, prefix="cilium_tpu_monitor_events_total"))}


def test_the_slice_equals_the_reference(frozen, engines, tmp_path):
    got = {pkg.root: _slice(pkg, tmp_path, engines) for pkg in PKGS}
    want, port = got["cilium_tpu"], got["cilium_tpu_torch"]
    for k in want:
        assert port[k] == want[k], k
    n = len(engines["cilium_tpu_torch"][1])
    assert port["seen"] == n + 3                 # 3 chunks, 1 log each
    assert port["events"] == port["returned"]
    assert len(port["ring"]) == n + 3
    l7 = int(PORT.flow.PolicyMatchType.L7)
    logs = [d["l7"]["http"]["url"] for d in port["ring"]
            if "trace_id" not in d]
    assert logs == ["/ok/0", "/ok/1", "/ok/2"]
    assert all(d["policy_match_type"] == l7 and d["time"] == WALL
               and d["verdict"] == "REDIRECTED"
               for d in port["ring"] if "trace_id" not in d)
    assert port["exported"] == [json.dumps(d) for d in port["ring"]]
    assert sum(port["monitor_metrics"].values()) == len(port["events"])
