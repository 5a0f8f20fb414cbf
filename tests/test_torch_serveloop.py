"""The port's serve loop and verdict ring against the JAX package's, on
the CPU and on each package's own ``VirtualClock``, mirroring
``tests/test_serveloop.py``.

Each case drives the same streams, chunks and faults through both
packages' ``ServeLoop`` (a stub loader holding each package's engine)
and compares the verdicts and provenance lanes of every ticket, the
ring's ``bytes_saved``/``bytes_shipped``, memo hits/misses, shed
reasons, error strings and the loop's lifetime counters. Covered:
interleaved streams in one pack, the memo bypass arithmetic,
``queue-full`` and fault sheds, the transient ``engine.dispatch`` fault
retried on the next cycle, chunks orphaned by a session reset, drain,
lease expiry, ticket time-outs, the family- and port-granular refill
under a hot swap, traced chunks' explain entries, the ring's residency
manifest, an admission gate and the SLO windows, the pack thread, and
the engine/canary checks.
"""

import threading

import numpy as np
import pytest

from test_torch_session import (
    JAX,
    PKGS,
    PORT,
    SIZES,
    _direct,
    _scenario,
    _StubLoader,
)


class _Run:
    """One package's loop on its own virtual clock."""

    def __init__(self, pkg, engine, **kw):
        self.pkg = pkg
        self.clock = pkg.simclock.VirtualClock()
        self.loader = _StubLoader(engine)
        with pkg.simclock.use(self.clock):
            self.loop = pkg.serveloop.ServeLoop(
                self.loader, lease_ttl_s=kw.pop("ttl", 60.0),
                pack_interval_s=0.01, **{"capacity": 64, **kw})

    def __enter__(self):
        self._cm = self.pkg.simclock.use(self.clock)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)

    def submit(self, lease, flows):
        return self.loop.submit(lease, *self.pkg.sections(flows))

    def books(self):
        st = self.loop.status()
        return {k: st[k] for k in (
            "grants", "expiries", "releases", "sheds", "packs",
            "records_packed", "served_records", "chunk_errors",
            "bytes_saved", "bytes_shipped", "memo", "occupancy")}


def _ticket(t):
    """A resolved ticket's verdicts, error and provenance lanes."""
    out = {"done": t.done, "error": t.error,
           "verdicts": None if t.verdicts is None else t.verdicts.tolist()}
    if t.prov is not None:
        p = t.prov
        out.update(l7_match=np.asarray(p.l7_match).tolist(),
                   match_spec=np.asarray(p.match_spec).tolist(),
                   memo_hit=np.asarray(p.memo_hit).tolist(),
                   kernel=p.kernel, pack_cycle=p.pack_cycle)
    return out


@pytest.fixture(scope="module")
def engines():
    out = {}
    for name in SIZES:
        for pkg in PKGS:
            pi, sc = _scenario(pkg, name)
            out[name, pkg.root] = (pkg.engine(pi), sc.flows)
    return out


# ------------------------------------------------- packed dispatch
@pytest.mark.parametrize("name", list(SIZES))
def test_ring_pack_is_bit_equal_across_interleaved_streams(engines, name):
    runs = []
    for pkg in PKGS:
        engine, flows = engines[name, pkg.root]
        with _Run(pkg, engine) as r:
            leases = [r.loop.connect(f"s{i}") for i in range(4)]
            tickets = [r.submit(leases[k % 4], flows[i:i + 30])
                       for k, i in enumerate(range(0, len(flows), 30))]
            assert r.loop.step() == len(flows)
            got = sum((t.verdicts.tolist() for t in tickets), [])
            assert got == _direct(engine, flows)
            # the same traffic again: every row a memo hit
            again = [r.submit(leases[k % 4], flows[i:i + 30])
                     for k, i in enumerate(range(0, len(flows), 30))]
            r.loop.step()
            assert all(all(t.prov.memo_hit) for t in again)
            runs.append(([_ticket(t) for t in tickets + again],
                         r.books()))
    assert runs[0] == runs[1]
    assert runs[1][1]["packs"] == 2


def test_memo_hit_rows_provably_skip_h2d(engines):
    runs = []
    for pkg in PKGS:
        engine, flows = engines["http", pkg.root]
        with _Run(pkg, engine) as r:
            lease = r.loop.connect("s0")
            r.submit(lease, flows)
            r.loop.step()
            ring = r.loop.ring
            assert ring.bytes_saved > 0     # dedup within the chunk
            saved0, shipped0 = ring.bytes_saved, ring.bytes_shipped
            hits0 = ring.session.memo.hits
            t = r.submit(lease, flows)
            r.loop.step()
            row_bytes = ring.session.row_width * 4
            assert ring.bytes_saved - saved0 == len(flows) * (row_bytes - 4)
            assert ring.bytes_shipped - shipped0 == len(flows) * 4
            assert ring.session.memo.hits > hits0
            runs.append((_ticket(t), r.books(), row_bytes))
    assert runs[0] == runs[1]


def test_per_slot_pending_bound_sheds_queue_full(engines):
    runs = []
    for pkg in PKGS:
        engine, flows = engines["http", pkg.root]
        with _Run(pkg, engine, max_slot_pending=2) as r:
            lease = r.loop.connect("s0")
            r.submit(lease, flows[:8])
            r.submit(lease, flows[:8])
            with pytest.raises(pkg.serveloop.ShedError) as exc:
                r.submit(lease, flows[:8])
            assert exc.value.reason == pkg.admission.SHED_QUEUE_FULL
            r.loop.step()
            t = r.submit(lease, flows[:8])      # the slot accepts again
            r.loop.step()
            runs.append((exc.value.reason, _ticket(t), r.books()))
    assert runs[0] == runs[1]


def test_serve_fault_points_shed_explicitly(engines):
    runs = []
    for pkg in PKGS:
        engine, flows = engines["http", pkg.root]
        f = pkg.faults
        with _Run(pkg, engine) as r:
            reasons = []
            with f.inject(f.FaultPlan([f.FaultRule("serve.lease",
                                                   times=1)])):
                with pytest.raises(pkg.serveloop.ShedError) as exc:
                    r.loop.connect("s0")
                reasons.append(exc.value.reason)
                lease = r.loop.connect("s0")    # fault exhausted
            with f.inject(f.FaultPlan([f.FaultRule("serve.ring_slot",
                                                   times=1)])):
                with pytest.raises(pkg.serveloop.ShedError) as exc:
                    r.submit(lease, flows[:8])
                reasons.append(exc.value.reason)
                t = r.submit(lease, flows[:8])
            r.loop.step()
            assert t.done and t.error is None
            assert reasons == [pkg.admission.SHED_FAULT] * 2
            runs.append((reasons, _ticket(t), r.books()))
    assert runs[0] == runs[1]


def test_transient_dispatch_fault_retries_next_cycle(engines):
    """An ``engine.dispatch`` fault (fired in ``serve_ids``) fails ONE
    pack cycle: the batch goes back to the slots' heads, and the next
    cycle serves it with real verdicts."""
    runs = []
    for pkg in PKGS:
        engine, flows = engines["http", pkg.root]
        f = pkg.faults
        with _Run(pkg, engine) as r:
            leases = [r.loop.connect(f"s{i}") for i in range(2)]
            ts = [r.submit(leases[i], flows[i * 64:(i + 1) * 64])
                  for i in range(2)]
            with f.inject(f.FaultPlan([f.FaultRule("engine.dispatch",
                                                   times=1)])):
                with pytest.raises(f.FaultInjected):
                    r.loop.step()
                assert not any(t.done for t in ts)
                assert r.loop.step() == 128
            assert sum((t.verdicts.tolist() for t in ts), []) == \
                _direct(engine, flows[:128])
            runs.append(([_ticket(t) for t in ts], r.books()))
    assert runs[0] == runs[1]


def test_chunks_encoded_before_a_session_reset_resolve_as_errors(engines):
    """A reset at encode orphans the chunks encoded before it: they
    resolve as ``session-reset`` errors, and resubmitted they serve."""
    runs = []
    for pkg in PKGS:
        engine, flows = engines["http", pkg.root]
        with _Run(pkg, engine) as r:
            r.loop.ring.session.max_rows = 16
            lease = r.loop.connect("s0")
            stale = r.submit(lease, flows[:60])     # > 16 rows interned
            fresh = r.submit(lease, flows[60:120])  # resets at encode
            r.loop.step()
            assert stale.error == "session-reset" and fresh.error is None
            retry = r.submit(lease, flows[:60])
            r.loop.step()
            assert retry.verdicts.tolist() == _direct(engine, flows[:60])
            runs.append(([_ticket(t) for t in (stale, fresh, retry)],
                         r.books(), r.loop.ring.session.resets))
    assert runs[0] == runs[1]
    assert runs[1][2] == 2


# ----------------------------------------------- leases and drain
def test_drain_flushes_pending_and_releases_all_leases(engines):
    runs = []
    for pkg in PKGS:
        engine, flows = engines["fqdn", pkg.root]
        with _Run(pkg, engine) as r:
            leases = [r.loop.connect(f"s{i}") for i in range(3)]
            ts = [r.submit(leases[i], flows[:100]) for i in range(3)]
            assert r.loop.drain() == 300
            for t in ts:
                assert t.verdicts.tolist() == _direct(engine, flows[:100])
            st = r.loop.status()
            assert st["occupancy"] == 0 and st["draining"]
            with pytest.raises(pkg.serveloop.ShedError) as exc:
                r.loop.connect("late")
            runs.append(([_ticket(t) for t in ts], r.books(),
                         exc.value.reason))
    assert runs[0] == runs[1]


def test_lease_expiry_and_reconnect_with_resume(engines):
    runs = []
    for pkg in PKGS:
        engine, flows = engines["http", pkg.root]
        with _Run(pkg, engine, ttl=5.0) as r:
            lease = r.loop.connect("s0")
            again = r.loop.connect("s0", resume=True)   # alive: renewed
            assert again is lease
            r.clock.advance(5.0)
            with pytest.raises(pkg.serveloop.LeaseExpired):
                r.submit(lease, flows[:8])
            assert r.loop.status()["occupancy"] == 0
            lease = r.loop.connect("s0", resume=True)   # fresh grant
            t = r.submit(lease, flows[:8])
            r.clock.advance(1.0)
            r.loop.step()
            other = r.loop.connect("s1")
            r.clock.advance(5.0)
            r.loop.step()                               # sweeps both
            runs.append((_ticket(t), r.books(), other.active,
                         t.latency))
    assert runs[0] == runs[1]
    assert runs[1][1]["expiries"] == 3 and runs[1][1]["grants"] == 3


def test_ticket_wait_times_out_on_virtual_clock():
    clk = PORT.simclock.VirtualClock()
    with PORT.simclock.use(clk):
        t = PORT.serveloop.ChunkTicket(4)
        got = []

        def waiter():
            try:
                t.wait(timeout=5.0)
            except TimeoutError:
                got.append(True)

        th = threading.Thread(target=waiter)
        th.start()
        while not clk._by_seq:
            threading.Event().wait(0.002)
        clk.advance(5.1)
        th.join(timeout=5.0)
        assert got == [True]


# -------------------------------------------------- hot swaps
def _churn_flows(http, dns, dbs):
    corpus = []
    for i, _ in enumerate(dbs):
        corpus += [http(i, 80, f"/svc{i}/p{j}/x") for j in range(4)]
        corpus += [http(i, 8080, f"/svc{i}/q{j}/x") for j in range(2)]
        corpus += [dns(i, f"api{i}.corp.io"), dns(i, "evil.net")]
    return corpus * 4


def _churn_world(pkg):
    """Three db identities, each with HTTP rules on 80 and 8080 and DNS
    rules on 53 → (engine_of(rules), http, dns, dbs)."""
    api, fl = pkg.api, pkg.flow
    alloc = pkg.identity.IdentityAllocator()
    LabelSet = pkg.labels.LabelSet
    web = alloc.allocate(LabelSet.from_dict({"app": "web"}))
    dbs = [alloc.allocate(LabelSet.from_dict({"app": f"db{i}"}))
           for i in range(3)]

    def engine_of(rules_of):
        repo = pkg.repository.Repository()
        rules = []
        for i in range(3):
            port_rules = [api.PortRule(
                ports=(api.PortProtocol(p, fl.Protocol.TCP),),
                rules=pkg.l7.L7Rules(http=tuple(
                    pkg.l7.PortRuleHTTP(path=x, method="GET")
                    for x in rules_of[i][p]))) for p in (80, 8080)]
            port_rules.append(api.PortRule(
                ports=(api.PortProtocol(53, fl.Protocol.UDP),),
                rules=pkg.l7.L7Rules(dns=tuple(
                    pkg.l7.PortRuleDNS(match_name=q)
                    for q in rules_of[i][53]))))
            rules.append(api.Rule(
                endpoint_selector=api.EndpointSelector.from_labels(
                    app=f"db{i}"),
                ingress=(api.IngressRule(
                    from_endpoints=(api.EndpointSelector.from_labels(
                        app="web"),),
                    to_ports=tuple(port_rules)),)))
        repo.add(rules, sanitize=False)
        resolver = pkg.mapstate.PolicyResolver(
            repo, pkg.selectorcache.SelectorCache(alloc))
        return pkg.engine({db: resolver.resolve(alloc.lookup(db))
                           for db in dbs}, bank_size=2)

    def http(i, port, path):
        return fl.Flow(src_identity=web, dst_identity=dbs[i], dport=port,
                       protocol=fl.Protocol.TCP,
                       direction=fl.TrafficDirection.INGRESS,
                       l7=fl.L7Type.HTTP,
                       http=fl.HTTPInfo(method="GET", path=path))

    def dns(i, q):
        return fl.Flow(src_identity=web, dst_identity=dbs[i], dport=53,
                       protocol=fl.Protocol.UDP,
                       direction=fl.TrafficDirection.INGRESS,
                       l7=fl.L7Type.DNS, dns=fl.DNSInfo(query=q))

    return engine_of, http, dns, dbs


def _rules():
    return {i: {80: [f"/svc{i}/p{j}/.*" for j in range(4)],
                8080: [f"/svc{i}/q{j}/.*" for j in range(2)],
                53: [f"api{i}.corp.io"]} for i in range(3)}


@pytest.mark.parametrize("grain", ["family", "port"])
def test_ring_survives_hot_swap_with_granular_refill(grain):
    """A commit changing ONLY db0's HTTP rules (on port 8080, for the
    port grain) refills only those memo rows: db0's DNS rows (and its
    port-80 rows, for the port grain) and every other identity keep
    serving from the memo. Verdicts equal the new engine's throughout,
    and every count equals the reference's."""
    runs = []
    for pkg in PKGS:
        engine_of, http, dns, dbs = _churn_world(pkg)
        rules = _rules()
        with _Run(pkg, engine_of(rules), capacity=8) as r:
            corpus = _churn_flows(http, dns, dbs)
            lease = r.loop.connect("s0")
            t1 = r.submit(lease, corpus)
            r.loop.step()
            assert t1.verdicts.tolist() == _direct(r.loader.engine, corpus)
            sess = r.loop.ring.session
            memo = sess.memo
            misses0, inv0, n_rows = memo.misses, memo.invalidations, \
                sess.n_rows
            db0 = dbs[0]
            want_rows = sum(1 for ep, l7t, dp in sess._row_eps
                            if ep == db0 and l7t == 1
                            and (grain == "family" or dp == 8080))
            rules[0][8080] = rules[0][8080] + ["/churn/added/.*"]
            r.loader.engine = engine_of(rules)
            kw = {"identity_families": {(db0, "http")}}
            if grain == "port":
                kw["identity_family_ports"] = {(db0, "http", 8080)}
            pkg.bump(identities={db0}, **kw)
            t2 = r.submit(lease, corpus)
            r.loop.step()
            assert sess.engine is r.loader.engine
            assert t2.verdicts.tolist() == _direct(r.loader.engine, corpus)
            refilled = memo.misses - misses0
            assert refilled == want_rows
            assert memo.invalidations == inv0 + 1
            assert sess.n_rows == n_rows
            probe = [http(0, 8080, "/churn/added/x")] * 8
            t3 = r.submit(lease, probe)
            r.loop.step()
            assert t3.verdicts.tolist() == _direct(r.loader.engine, probe)
            runs.append(([_ticket(t) for t in (t1, t2, t3)], r.books(),
                         refilled, n_rows))
    assert runs[0] == runs[1]
    refilled, n_rows = runs[1][2:]
    assert 0 < refilled < n_rows


# ------------------------------------------ the pack thread, checks
def test_pack_thread_serves_concurrent_submitters(engines):
    """``start()`` on the real clock with four submitter threads: every
    ticket resolves with the direct step's verdicts."""
    engine, flows = engines["kafka", PORT.root]
    want = _direct(engine, flows)
    loop = PORT.serveloop.ServeLoop(_StubLoader(engine), capacity=16,
                                    pack_interval_s=0.001)
    leases = [loop.connect(f"s{i}") for i in range(8)]
    results = {}

    def submitter(k):
        for rep in range(3):
            for i in range(0, len(flows), 50):
                t = loop.submit(leases[(k * 2 + rep) % 8],
                                *PORT.sections(flows[i:i + 50]))
                results[k, rep, i] = t

    loop.start()
    try:
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for (k, rep, i), t in results.items():
            assert t.wait(timeout=60.0).tolist() == want[i:i + 50]
    finally:
        loop.stop()
    assert loop._thread is None and loop.pack_failures == 0
    assert loop.served_records == 12 * len(flows)


def test_serve_loop_needs_a_torch_engine_and_refuses_a_canary(engines):
    jengine, _ = engines["http", JAX.root]
    with pytest.raises(RuntimeError, match="TorchVerdictEngine"):
        PORT.serveloop.ServeLoop(_StubLoader(jengine))
    with pytest.raises(RuntimeError, match="TorchVerdictEngine"):
        PORT.serveloop.ServeLoop(_StubLoader(None))
    engine, _ = engines["http", PORT.root]
    with pytest.raises(NotImplementedError, match="Q4"):
        PORT.serveloop.ServeLoop(_StubLoader(engine), canary=object())


def test_ring_residency_manifest_equals_reference(engines):
    """``resident_keys`` hashes row content, so both packages' rings
    hold the same manifest after the same traffic, and
    ``handoff_overlap`` prices a peer's manifest alike."""
    runs = []
    for pkg in PKGS:
        engine, flows = engines["kafka", pkg.root]
        with _Run(pkg, engine) as r:
            lease = r.loop.connect("s0")
            r.submit(lease, flows[:120])
            r.loop.step()
            runs.append(r.loop.ring)
    jring, ring = runs
    keys = ring.resident_keys()
    assert keys == jring.resident_keys() and len(keys) == ring.session.n_rows
    peer = frozenset(list(keys)[:10]) | {1, 2, 3}
    assert ring.handoff_overlap(peer) == jring.handoff_overlap(peer)
    assert ring.handoff_overlap(peer)[0] == 10


def test_traced_chunks_record_explain_entries_as_the_reference(engines):
    """A chunk submitted under a trace carries its id to the pack: the
    loop records the sampled flows' explain entries, the flow
    aggregate and the ``serve.chunk`` span by id, as the reference."""
    runs = []
    for pkg in PKGS:
        engine, flows = engines["http", pkg.root]
        tracing = __import__(f"{pkg.root}.runtime.tracing",
                             fromlist=["TRACER"])
        store = pkg.explain.ExplainStore()
        with _Run(pkg, engine, explain_store=store) as r:
            lease = r.loop.connect("s0", tenant="acme")
            with tracing.TRACER.trace("serve.stream", trace_id="t-serve-1"):
                t = r.submit(lease, flows[:40])
            untraced = r.submit(lease, flows[40:80])
            r.loop.step()
            entries = store.get("t-serve-1")
            # each package counts policy generations on its own
            now = pkg.memo.policy_generation()
            for e in entries:
                e.pop("t")
                p = e["provenance"]
                p.pop("bank_epoch", None)
                word = pkg.attribution.unpack_word(p.pop("word"))
                assert word["generation"] == p.pop("generation") == now
                p["word"] = {**word, "generation": "now"}
            spans = [(s["name"], s.get("attrs", {}).get("records"))
                     for s in tracing.TRACER.dump(trace_id="t-serve-1")
                     if s["name"] == "serve.chunk"]
            st = r.loop.status()
            runs.append((entries, _ticket(t), _ticket(untraced), spans,
                         st["provenance"], st["flows"]))
    assert runs[0] == runs[1]
    entries = runs[1][0]
    assert len(entries) == 8 and all(e["tenant"] == "acme" for e in entries)
    assert runs[1][3] == [("serve.chunk", 40)]


def test_admission_gate_and_slo_windows_as_the_reference(engines):
    """A gate bounding the leases sheds the third stream with its
    reason, and the SLO tracker's windows see the same served and shed
    requests as the reference's."""
    from types import SimpleNamespace

    slo = SimpleNamespace(enabled=True, serve_p99_ms=50.0, shed_rate=1e-3,
                          windows_s=(300.0, 3600.0))
    runs = []
    for pkg in PKGS:
        engine, flows = engines["http", pkg.root]
        holder = {}
        gate = pkg.admission.AdmissionGate(
            max_pending=2, surface="serve",
            depth_fn=lambda: holder["loop"].status()["occupancy"])
        with _Run(pkg, engine, gate=gate, slo=slo) as r:
            holder["loop"] = r.loop
            leases = [r.loop.connect(f"s{i}", tenant="acme")
                      for i in range(2)]
            with pytest.raises(pkg.serveloop.ShedError) as exc:
                r.loop.connect("s2", tenant="acme")
            ts = [r.submit(lz, flows[:16]) for lz in leases]
            r.clock.advance(0.2)                 # past the p99 target
            r.loop.step()
            runs.append((exc.value.reason, [_ticket(t) for t in ts],
                         r.loop.status()["slo"], r.books()))
    assert runs[0] == runs[1]
    assert runs[1][0] == PORT.admission.SHED_QUEUE_FULL
    assert runs[1][2]["burn_rates"]
