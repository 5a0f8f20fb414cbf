"""The port's serving fleet (``runtime/fleetserve.py``) against the JAX
package's, on the CPU, mirroring ``tests/test_fleetserve.py``.

Every case builds the same world in both packages (``_fleet_world``: the
http scenario at 24 rules, one loader shared by the replicas, the
port's with ``device="cpu"``), each on its own ``VirtualClock``, and
drives the same calls through each ``FleetRouter``; the outcomes must be
equal: HRW placements of the same stream ids, the lease books, the three
typed shed reasons and their counters, kill and rejoin, explain across a
failover, trace stitching, the journal folded to the router's books,
the merged flow export, host-labelled serve metrics, and a
``FleetModel`` smoke run whose result dict equals the reference's
except ``obs_seconds`` (host wall time).

Also: the ``fleet`` config section and its environment, ``host_id``,
the fleet's replicas staging on ``cuda`` by default, and ``main``'s
stamped line.
"""

import importlib
import json
import types

import pytest
import torch

PKG_MODULES = (("config", "core.config"), ("synth", "ingest.synth"),
               ("binary", "ingest.binary"), ("admission", "runtime.admission"),
               ("simclock", "runtime.simclock"), ("explain", "runtime.explain"),
               ("fleetserve", "runtime.fleetserve"),
               ("loader", "runtime.loader"), ("metrics", "runtime.metrics"),
               ("serveloop", "runtime.serveloop"),
               ("tracing", "runtime.tracing"),
               ("multihost", "parallel.multihost"))


def _pkg(root):
    ns = types.SimpleNamespace(root=root, port=root == "cilium_tpu_torch")
    for attr, mod in PKG_MODULES:
        setattr(ns, attr, importlib.import_module(f"{root}.{mod}"))
    ns.TRACER = ns.tracing.TRACER
    ns.EXPLAIN = ns.explain.EXPLAIN
    return ns


JAX, PORT = _pkg("cilium_tpu"), _pkg("cilium_tpu_torch")
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean_explain_and_tracer():
    saved = [(p.TRACER.enabled, p.TRACER.sample_rate) for p in PKGS]
    for p in PKGS:
        p.EXPLAIN.clear()
    yield
    for p, (enabled, rate) in zip(PKGS, saved):
        p.EXPLAIN.clear()
        p.TRACER.configure(enabled=enabled, sample_rate=rate)


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    """One loader per package on the http scenario at 24 rules (the
    reference tests' world), and 16 of its flows as a chunk."""
    out = {}
    for p in PKGS:
        scenario = p.synth.scenario_by_name("http", 24, 64)
        per_identity, scenario = p.synth.realize_scenario(scenario)
        cfg = p.config.Config()
        cfg.enable_tpu_offload = True
        cfg.loader.cache_dir = str(tmp_path_factory.mktemp(p.root))
        loader = (p.loader.Loader(cfg, device="cpu") if p.port
                  else p.loader.Loader(cfg))
        loader.regenerate(per_identity, revision=1)
        out[p.root] = (loader, p.binary.capture_from_bytes(
            p.binary.capture_to_bytes(scenario.flows[:16])))
    yield out
    for loader, _ in out.values():
        loader.close()


class _World:
    """One package's router over ``hosts`` replicas on its own clock."""

    def __init__(self, p, loaders, hosts=3, capacity=8):
        self.p = p
        self.clk = p.simclock.VirtualClock()
        self.loader, self.sections = loaders[p.root]
        fs = p.fleetserve
        with p.simclock.use(self.clk):
            replicas = [fs.HostReplica(i, self.loader, capacity=capacity,
                                       lease_ttl_s=60.0,
                                       pack_interval_s=0.01)
                        for i in range(hosts)]
            self.router = fs.FleetRouter(
                replicas, heartbeat_interval_s=1.0, suspicion_ttl_s=3.0,
                spill_headroom=0.0)

    def __enter__(self):
        self._cm = self.p.simclock.use(self.clk)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)

    def shed_count(self, reason):
        return self.p.metrics.METRICS.get(
            self.p.metrics.ADMISSION_SHED,
            labels={"surface": "fleet",
                    "class": self.p.admission.CLASS_DATA,
                    "reason": reason})

    def pack(self):
        self.clk.advance(0.02)
        return self.router.step_all()


def _both(loaders, fn, **kw):
    """``fn(world)`` in each package; returns (reference's, port's)."""
    out = []
    for p in PKGS:
        with _World(p, loaders, **kw) as w:
            out.append(fn(w))
    return tuple(out)


# ------------------------------------------------- routing & affinity
def test_rendezvous_placement_equals_reference(loaders):
    def run(w):
        first = {f"aff-{k}": w.router.connect(f"aff-{k}")[0]
                 for k in range(30)}
        again = {f"aff-{k}": w.router.connect(f"aff-{k}", resume=True)[0]
                 for k in range(30)}
        return (first, again, w.router.books(),
                w.router.conservation_violation(),
                sorted(w.router.placements.items()))

    want, got = _both(loaders, run, capacity=64)
    assert got == want
    first, again, books, bad, _ = got
    assert len(set(first.values())) > 1 and again == first
    assert books == (30, 30) and bad is None


def test_hrw_score_is_the_reference_crc(loaders):
    for sid in ("vs0", "vs1049999", "baseline", "aff-7"):
        for i in range(4):
            name = PORT.multihost.host_id(i)
            assert PORT.fleetserve.FleetRouter._score(name, sid) == \
                JAX.fleetserve.FleetRouter._score(name, sid)


# ------------------------------------------------- typed shed reasons
def test_shed_reason_host_draining_unpins(loaders):
    def run(w):
        host, _ = w.router.connect("d0")
        before = w.shed_count("host-draining")
        w.router.begin_drain(host)
        with pytest.raises(w.p.serveloop.ShedError) as ei:
            w.router.connect("d0", resume=True)
        host2, _ = w.router.connect("d0")
        return (host, ei.value.reason,
                w.shed_count("host-draining") - before, host2)

    want, got = _both(loaders, run)
    assert got == want
    assert got[1] == PORT.admission.SHED_HOST_DRAINING and got[2] == 1
    assert got[3] != got[0]


def test_shed_reason_host_overloaded_is_fleet_coherent(loaders):
    def run(w):
        before = w.shed_count("host-overloaded")
        admitted, reason = 0, None
        for k in range(2 * 4 + 1):
            try:
                w.router.connect(f"ov-{k}")
                admitted += 1
            except w.p.serveloop.ShedError as e:
                reason = e.reason
                break
        return (admitted, reason, w.shed_count("host-overloaded") - before,
                w.router.spilled)

    want, got = _both(loaders, run, hosts=2, capacity=4)
    assert got == want
    assert got[:3] == (8, PORT.admission.SHED_HOST_OVERLOADED, 1)


def test_shed_reason_partitioned_fails_closed(loaders):
    def run(w):
        ShedError = w.p.serveloop.ShedError
        host, lease = w.router.connect("p0")
        before = w.shed_count("partitioned")
        w.router.partition(host)
        reasons = []
        with pytest.raises(ShedError) as ei:
            w.router.submit("p0", lease, w.sections)
        reasons.append(ei.value.reason)
        with pytest.raises(ShedError) as ei:
            w.router.connect("p0", resume=True)
        reasons.append(ei.value.reason)
        bad = w.router.conservation_violation()
        died = []
        for _ in range(4):
            w.clk.advance(1.1)
            died += w.router.beat()
        host2, lease2 = w.router.connect("p0", resume=True)
        ticket = w.router.submit("p0", lease2, w.sections)
        w.pack()
        return (host, reasons, w.shed_count("partitioned") - before, bad,
                died, host2, ticket.done, ticket.error,
                list(ticket.verdicts), w.router.conservation_violation())

    want, got = _both(loaders, run)
    assert got == want
    assert got[1] == [PORT.admission.SHED_PARTITIONED] * 2 and got[2] == 2
    assert got[4] == [got[0]] and got[5] != got[0]
    assert got[6] and got[7] is None


# ------------------------------------------------- kill, rejoin, explain
def test_kill_and_rejoin_serve_with_zero_losses(loaders):
    def run(w):
        for i in range(12):
            w.router.connect(f"k{i}")
        host = w.router.placements["k0"]
        migrated = w.router.kill(host)
        leases = {}
        for i in range(12):
            leases[f"k{i}"] = w.router.connect(f"k{i}", resume=True)
        tickets = [w.router.submit(s, lease, w.sections)
                   for s, (_, lease) in sorted(leases.items())]
        w.pack()
        w.router.rejoin(host)
        st = w.router.status()
        return (host, migrated,
                [(t.done, t.error, list(t.verdicts)) for t in tickets],
                w.router.books(), w.router.conservation_violation(),
                {k: st[k] for k in ("handoffs", "host_deaths", "rejoins",
                                    "placements")})

    want, got = _both(loaders, run, capacity=64)
    assert got == want
    assert got[1] > 0 and all(t[0] and t[1] is None for t in got[2])
    assert got[4] is None and got[5]["rejoins"] == 1


def test_submit_after_silent_death_is_typed_resume(loaders):
    def run(w):
        host, lease = w.router.connect("z0")
        w.router.kill(host)
        replica = w.router.replica_of("z0")
        assert replica is not None and replica.name != host
        host2, lease2 = w.router.connect("z0", resume=True)
        ticket = w.router.submit("z0", lease2, w.sections)
        w.pack()
        w.router.kill(host2)
        w.router.placements.pop("z0", None)
        with pytest.raises(w.p.fleetserve.HostDead):
            w.router.submit("z0", lease2, w.sections)
        return (host, host2, ticket.done, ticket.error, w.router.books())

    want, got = _both(loaders, run)
    assert got == want
    assert got[1] != got[0] and got[2] and got[3] is None
    assert got[4][0] == got[4][1]


def test_explain_follows_the_stream_across_failover(loaders):
    def run(w):
        host, lease = w.router.connect("traced")
        w.p.TRACER.configure(enabled=True, sample_rate=1.0)
        with w.p.TRACER.trace("stream.chunk") as ctx:
            ticket = w.router.submit("traced", lease, w.sections)
            tid = ctx.trace_id
        w.pack()
        out = w.router.explain(tid)
        w.router.kill(host)
        w.router.rejoin(host)
        after = w.router.explain(tid)
        miss = w.router.explain("deadbeefdeadbeef")

        def brief(o):
            return {k: o.get(k) for k in ("found", "host",
                                          "served_equals_fresh")}
        return (ticket.error, host, brief(out), brief(after), brief(miss),
                [(r["verdict"], r.get("fresh_verdict"))
                 for r in after["records"]])

    want, got = _both(loaders, run)
    assert got == want
    assert got[2] == got[3] == {"found": True, "host": got[1],
                                "served_equals_fresh": True}
    assert got[4]["found"] is False


def test_trace_stitches_across_host_death(loaders):
    def run(w):
        w.p.TRACER.configure(enabled=True, sample_rate=1.0)
        w.p.TRACER.clear()
        host_a, lease = w.router.connect("st0")
        with w.p.TRACER.trace("stream.chunk") as ctx:
            ticket = w.router.submit("st0", lease, w.sections)
            tid = ctx.trace_id
        w.router.kill(host_a)
        host_b, lease2 = w.router.connect("st0", resume=True)
        t2 = w.router.submit("st0", lease2, w.sections)
        w.pack()
        st = w.router.trace(tid)
        out = w.router.explain(tid)
        names = [r["name"] for r in st["records"]]
        return (ticket.error, ticket.epoch, t2.trace_id == tid, t2.epoch,
                t2.error, host_a, host_b, st["stitched"],
                sorted(st["hosts"]), st["epochs"],
                "fleet.handoff" in names, "serve.abandon" in names,
                [r.get("epoch", 0) for r in st["records"]]
                == sorted(r.get("epoch", 0) for r in st["records"]),
                out["trace"]["stitched"])

    want, got = _both(loaders, run)
    assert got == want
    assert got[0] == "lease-closed" and got[1] == 0 and got[2]
    assert got[3] > 0 and got[4] is None and got[5] != got[6]
    assert got[7] and got[9] == [0, 1] and all(got[10:])


def test_journal_folds_to_router_books(loaders):
    def run(w):
        for k in range(12):
            w.router.connect(f"j{k}")
        a, b, c = (w.router.replicas[i].name for i in range(3))
        msgs = [w.router.journal_consistent()]
        w.router.kill(a)
        msgs.append(w.router.journal_consistent())
        w.router.partition(b)
        for _ in range(4):
            w.clk.advance(1.1)
            w.router.beat()
        msgs.append(w.router.journal_consistent())
        w.router.begin_drain(c)
        w.router.restart_host(c)
        for h in (a, b, c):
            w.router.rejoin(h)
        msgs.append(w.router.journal_consistent())
        st = w.router.status()
        events = [(e["seq"], e["t"], e["kind"], e["host"], e.get("detail"))
                  for e in w.router.journal.events()]
        return msgs, st["journal"], events

    want, got = _both(loaders, run, capacity=64)
    assert got == want
    msgs, journal, _ = got
    assert msgs == [None] * 4 and journal["consistent"] is True
    counts = journal["counts"]
    assert counts["host-death"] >= 2 and counts["host-rejoin"] == 3
    assert counts["drain-begin"] == counts["host-restart"] == 1


def test_flow_export_merges_hosts(loaders):
    def run(w):
        w.p.TRACER.configure(enabled=True, sample_rate=1.0)
        host, lease = w.router.connect("fx0")
        with w.p.TRACER.trace("stream.chunk"):
            t = w.router.submit("fx0", lease, w.sections)
        w.pack()
        merged = w.router.flows()
        # a row's policy generation is absolute: each package counts the
        # commits its process has made
        keys = [k for k in merged["flows"][0]
                if k not in ("flow", "generation")]
        return (host, t.error, merged["records"], merged["aggregated"],
                merged["hosts"], [{k: row[k] for k in keys}
                                  for row in merged["flows"]])

    want, got = _both(loaders, run)
    assert got == want
    assert got[2] > 0 and got[3] > 0 and got[5][0]["hosts"]


def test_serve_metrics_are_host_labelled_per_replica(loaders):
    def run(w):
        grants = w.p.metrics.SERVE_LEASE_GRANTS
        m = w.p.metrics.METRICS
        r0, r1 = w.router.replicas[0], w.router.replicas[1]
        g0 = m.get(grants, labels={"host": r0.name})
        g1 = m.get(grants, labels={"host": r1.name})
        r0.loop.connect("hl0")
        r1.loop.connect("hl1")
        r1.loop.connect("hl2")
        return (m.get(grants, labels={"host": r0.name}) - g0,
                m.get(grants, labels={"host": r1.name}) - g1)

    assert _both(loaders, run, capacity=64) == ((1, 2), (1, 2))


def test_failover_ledger_survives_racing_verdict_pop(loaders):
    def run(w):
        r, now = w.router, w.p.simclock.now
        with r._lock:
            r._failover["s0"] = {"death": now()}
        w.clk.advance(2.0)
        r._note_regrant("s0")
        stamped = r._failover["s0"]["regrant"]
        w.clk.advance(1.5)
        r._note_regrant("s0")              # idempotent: keeps the first
        kept = r._failover["s0"]["regrant"] == stamped
        w.clk.advance(1.5)
        r.note_failover_verdict("s0")
        with r._lock:
            r._failover["s1"] = {"death": now()}
        r.note_failover_verdict("s1")
        r._note_regrant("s1")              # the pop won: a no-op
        return kept, list(r.failover_samples), sorted(r._failover)

    want, got = _both(loaders, run)
    assert got == want
    assert got[0] and got[1] == pytest.approx([5.0, 0.0]) and got[2] == []


def test_lease_books_equal_status(loaders):
    with _World(PORT, loaders, capacity=64) as w:
        for k in range(5):
            w.router.connect(f"b{k}")
        w.router.kill(w.router.placements["b0"])
        for r in w.router.replicas:
            st = r.loop.status()
            assert r.loop.lease_books() == (
                st["grants"] - st["expiries"] - st["releases"],
                st["occupancy"])


# ------------------------------------------------- the end-to-end model
MODEL = dict(seed=0, streams=400, hosts=4, virtual_s=40.0, ramp_s=10.0,
             storms=1, storm_size=50, active_fraction=0.2, n_rules=12,
             chunk_flows=4, pool_chunks=8)


@pytest.fixture(scope="module")
def models():
    out = []
    for p in PKGS:
        kw = {"device": "cpu"} if p.port else {}
        out.append(p.fleetserve.FleetModel(**MODEL, **kw).run())
    return tuple(out)


def test_fleet_model_result_equals_reference(models):
    want, got = models
    assert set(got) == set(want)
    for key in want:
        if key != "obs_seconds":            # host wall time
            assert got[key] == want[key], key


def test_fleet_model_kill_and_rejoin_zero_losses(models):
    res = models[1]
    assert res["violations"] == [] and res["unrecovered"] == 0
    assert res["host_deaths"] >= 1 and res["rejoins"] >= 1
    assert res["resolved"] > 0 and res["handoffs"] > 0
    assert res["rejoin_compiles"] == 0 == res["survivor_recompiles"]
    assert res["rejoin_warm_restores"] >= 1
    assert res["explain_coverage"] == 1.0
    assert res["journal_consistent"] is True


def test_fleet_model_restores_the_tracer():
    t = PORT.TRACER
    t.configure(enabled=False, sample_rate=0.25)
    model = PORT.fleetserve.FleetModel(
        **{**MODEL, "streams": 40, "virtual_s": 12.0, "ramp_s": 2.0},
        device="cpu")
    model.run()
    assert (t.enabled, t.sample_rate) == (False, 0.25)


def test_fleet_replicas_stage_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.fleetserve.FleetModel(**{**MODEL, "streams": 8}).run()


def test_main_prints_one_stamped_line(capsys, monkeypatch):
    for var in ("CILIUM_TPU_DST_SEED", "CILIUM_TPU_DST_DIGEST"):
        monkeypatch.delenv(var, raising=False)      # main sets them
    rc = PORT.fleetserve.main([
        "--streams", "200", "--hosts", "4", "--virtual-s", "30",
        "--storm-size", "40", "--faults", "0", "--min-handoffs", "1",
        "--active-fraction", "0.2", "--single-host-p99-ms", "50",
        "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert len(lines) == 1
    line = lines[0]
    assert line["lane"] == "serve-fleet" and line["hosts"] == 4
    assert line["unit"].endswith("(virtual)")
    assert line["single_host_p99_ms"] == 50.0
    assert line["violations"] == 0 and line["unrecovered"] == 0
    assert rc == (0 if all(line["gates"].values()) else 1)


# ------------------------------------------------- config and host identity
def test_fleet_config_equals_reference():
    import dataclasses

    assert dataclasses.asdict(PORT.config.Config().fleet) == \
        dataclasses.asdict(JAX.config.Config().fleet)
    env = {"CILIUM_TPU_FLEET_REPLICAS": "6",
           "CILIUM_TPU_FLEET_HEARTBEAT_INTERVAL_S": "0.5",
           "CILIUM_TPU_FLEET_SUSPICION_TTL_S": "2.5",
           "CILIUM_TPU_FLEET_SPILL_HEADROOM": "0.25"}
    got = dataclasses.asdict(PORT.config.Config.from_env(env).fleet)
    assert got == dataclasses.asdict(JAX.config.Config.from_env(env).fleet)
    assert got == {"replicas": 6, "heartbeat_interval_s": 0.5,
                   "suspicion_ttl_s": 2.5, "spill_headroom": 0.25}


def test_host_id(monkeypatch):
    import torch.distributed as dist

    host_id = PORT.multihost.host_id
    monkeypatch.delenv("CILIUM_TPU_HOST_ID", raising=False)
    assert host_id(3) == "host-3" == JAX.multihost.host_id(3)
    assert host_id() == "host-0"
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    assert host_id() == "host-2"
    monkeypatch.setenv("CILIUM_TPU_HOST_ID", "edge-a")
    assert host_id() == "edge-a" and host_id(1) == "host-1"
