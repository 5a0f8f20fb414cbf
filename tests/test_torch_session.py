"""The port's incremental session against the JAX package's, on the CPU,
mirroring ``tests/test_incremental_session.py``.

Both packages' sessions take the same chunk sequence (each package's
own capture-image writer; the bytes are identical,
``tests/test_torch_capture.py``) and must agree exactly, chunk by
chunk: the verdicts, ``n_rows``, the string-table sizes, ``resets``,
the memo's hits, misses, invalidations and fill mark, and the rows a
policy delta marks dirty. Verdicts also equal each engine's direct
``verdict_flows``.

Covered: uneven chunks and a steady state that interns nothing, growth
across capacity doublings, the reset under cardinality pressure, auth,
the bank-scoped and port-granular memo refills after a hot swap driven
through a stub loader and each package's own
``POLICY_GENERATION.bump(PolicyDelta.banks(...))``, the rebind to the
loader's new :class:`TorchVerdictEngine` (and no rebind to anything
else), and the GENERIC-section chunk that raises naming Q5.

Sizes: the synth scenarios at 12 rules × 240 flows (http), 6 × 180
(fqdn), 12 × 200 (kafka).
"""

import dataclasses
import importlib

import numpy as np
import pytest

from cilium_tpu.core.config import EngineConfig as JaxEngineConfig
from cilium_tpu.engine import verdict as jax_verdict

from cilium_tpu_torch.core.config import EngineConfig
from cilium_tpu_torch.engine.compiled import CompiledPolicy
from cilium_tpu_torch.engine.verdict import TorchVerdictEngine

SIZES = {"http": (12, 240), "fqdn": (6, 180), "kafka": (12, 200)}


class _Pkg:
    """One package's modules and engine constructor."""

    def __init__(self, root: str):
        self.root = root
        self.jax = root == "cilium_tpu"
        for attr, mod in (("synth", "ingest.synth"),
                          ("binary", "ingest.binary"),
                          ("memo", "engine.memo"),
                          ("session", "engine.session"),
                          ("flow", "core.flow"),
                          ("api", "policy.api"),
                          ("l7", "policy.api.l7"),
                          ("identity", "core.identity"),
                          ("labels", "core.labels"),
                          ("mapstate", "policy.mapstate"),
                          ("repository", "policy.repository"),
                          ("selectorcache", "policy.selectorcache"),
                          ("attribution", "engine.attribution"),
                          ("serveloop", "runtime.serveloop"),
                          ("simclock", "runtime.simclock"),
                          ("faults", "runtime.faults"),
                          ("admission", "runtime.admission"),
                          ("explain", "runtime.explain"),
                          ("flowagg", "hubble.flowagg")):
            setattr(self, attr, importlib.import_module(f"{root}.{mod}"))

    def engine(self, per_identity, bank_size=None):
        cfg = JaxEngineConfig() if self.jax else EngineConfig()
        if bank_size is not None:
            cfg.bank_size = bank_size
        if self.jax:
            return jax_verdict.VerdictEngine(
                jax_verdict.CompiledPolicy.build(per_identity, cfg))
        return TorchVerdictEngine(CompiledPolicy.build(per_identity, cfg),
                                  device="cpu")

    def sections(self, flows):
        return self.binary.capture_from_bytes(
            self.binary.capture_to_bytes(flows))

    def bump(self, **kw):
        """A bank-scoped commit (or, with no arguments, a no-op one)."""
        g = self.memo.POLICY_GENERATION
        if not kw:
            return g.bump(self.memo.PolicyDelta.none())
        ids = kw.pop("identities")
        return g.bump(self.memo.PolicyDelta.banks(ids, set(), **kw))


JAX, PORT = _Pkg("cilium_tpu"), _Pkg("cilium_tpu_torch")
PKGS = (JAX, PORT)


class _StubLoader:
    """Just an ``.engine``, as the session and the serve loop read a
    loader."""

    def __init__(self, engine):
        self.engine = engine


def _direct(engine, flows):
    return np.asarray(engine.verdict_flows(flows)["verdict"]).tolist()


def _scenario(pkg, name, n_rules=None, n_flows=None):
    r, n = SIZES[name]
    return pkg.synth.realize_scenario(pkg.synth.scenario_by_name(
        name, n_rules or r, n_flows or n))


def _uniquified(flows, copies):
    """``copies`` clones of every flow, each with a unique http path
    (``?u=`` suffix), kafka client or dns label: one new row each."""
    out = []
    for k in range(copies):
        for i, f in enumerate(flows):
            tag = k * len(flows) + i
            if f.http is not None:
                f = dataclasses.replace(f, http=dataclasses.replace(
                    f.http, path=f"{f.http.path}?u={tag}"))
            elif f.kafka is not None:
                f = dataclasses.replace(f, kafka=dataclasses.replace(
                    f.kafka, client_id=f"{f.kafka.client_id}-u{tag}"))
            elif f.dns is not None and f.dns.query:
                f = dataclasses.replace(f, dns=dataclasses.replace(
                    f.dns, query=f"u{tag}.{f.dns.query}"))
            out.append(f)
    return out


def _state(sess):
    m = sess.memo
    return {"n_rows": sess.n_rows,
            "strings": {f: t.n for f, t in sess.tables.items()},
            "resets": sess.resets,
            "row_capacity": sess.row_capacity,
            "memo": None if m is None else (m.hits, m.misses,
                                            m.invalidations, m.filled)}


def _drive(pkg, sess, flows, size, authed_pairs=None):
    """Chunks of ``size`` through ``encode_ids`` + ``serve_ids`` →
    (verdicts, per-chunk [(novel, dirty rows after encode, state)])."""
    got, trail = [], []
    for i in range(0, len(flows), size):
        rec, l7, offsets, blob, gen = pkg.sections(flows[i:i + size])
        idx, novel = sess.encode_ids(rec, l7, offsets, blob, gen)
        dirty = sess._memo_dirty
        dev = sess.serve_ids(idx, authed_pairs=authed_pairs)
        got.extend(np.asarray(dev)[:len(idx)].tolist())
        trail.append((novel, None if dirty is None else dirty.tolist(),
                      _state(sess)))
    return got, trail


@pytest.fixture(scope="module")
def engines():
    """name → {pkg root: (engine, flows)}, built once."""
    out = {}
    for name in SIZES:
        out[name] = {}
        for pkg in PKGS:
            pi, sc = _scenario(pkg, name)
            out[name][pkg.root] = (pkg.engine(pi), sc.flows)
    return out


# ----------------------------------------------------------- verdicts
@pytest.mark.parametrize("name", list(SIZES))
def test_session_matches_reference_across_chunks(engines, name):
    runs = []
    for pkg in PKGS:
        engine, flows = engines[name][pkg.root]
        sess = pkg.session.IncrementalSession(engine)
        # uneven chunks force pad buckets AND repeated delta flushes
        got, trail = _drive(pkg, sess, flows, 71)
        assert got == _direct(engine, flows)
        before = _state(sess)
        # steady state: the same traffic again interns nothing
        steady = []
        for i in range(0, len(flows), 120):
            rec, l7, offsets, blob, gen = pkg.sections(flows[i:i + 120])
            n, dev = sess.verdict_chunk(rec, l7, offsets, blob, gen=gen)
            steady.extend(np.asarray(dev)[:n].tolist())
        after = _state(sess)
        assert (after["n_rows"], after["strings"]) == \
            (before["n_rows"], before["strings"])
        runs.append((got, trail, steady, after))
    (jgot, jtrail, jsteady, jafter), (got, trail, steady, after) = runs
    assert got == jgot and steady == jsteady == got
    assert trail == jtrail
    assert after == jafter
    assert len(set(got)) > 1


def test_session_growth_across_capacity_doublings():
    runs = []
    for pkg in PKGS:
        pi, sc = _scenario(pkg, "http")
        engine = pkg.engine(pi)
        flows = _uniquified(sc.flows, 2)
        sess = pkg.session.IncrementalSession(engine)
        got, trail = _drive(pkg, sess, flows, 160)
        assert got == _direct(engine, flows)
        runs.append((got, trail, sess.row_capacity,
                     {f: t.capacity for f, t in sess.tables.items()}))
    assert runs[0] == runs[1]
    got, trail, row_cap, caps = runs[1]
    # the row table and the path table doubled past the 256 floor
    assert row_cap >= 512 and caps["path"] >= 512
    assert trail[-1][2]["n_rows"] > 256


def test_session_reset_on_cardinality_pressure(engines):
    runs = []
    for pkg in PKGS:
        engine, flows = engines["http"][pkg.root]
        sess = pkg.session.IncrementalSession(engine, max_rows=8)
        got, trail = _drive(pkg, sess, flows, 40)
        assert got == _direct(engine, flows)
        runs.append((got, trail))
    assert runs[0] == runs[1]
    assert runs[1][1][-1][2]["resets"] >= 1


def test_session_enforces_auth():
    from test_torch_replay import _auth_world

    runs = []
    for pkg, tag in ((JAX, "jax"), (PORT, "port")):
        engine, flows, cart, pay = _auth_world(tag)
        sess = pkg.session.IncrementalSession(engine)
        flows = flows * 5
        closed, t1 = _drive(pkg, sess, flows, 5)
        pairs = np.array([[cart, pay]], dtype=np.int32)
        opened, t2 = _drive(pkg, sess, flows, 5, authed_pairs=pairs)
        assert closed == [2] * 5 and opened == [1] * 5
        runs.append((t1, t2))
    assert runs[0] == runs[1]


# ------------------------------------------------------ hot swaps
def _db_world(pkg, ports):
    """db ← web rules: per port (80/8080 HTTP paths, 53 DNS names) →
    (resolve(rules by port) → per-identity policy, http(), dns(), db)."""
    api, fl = pkg.api, pkg.flow
    alloc = pkg.identity.IdentityAllocator()
    LabelSet = pkg.labels.LabelSet
    db = alloc.allocate(LabelSet.from_dict({"app": "db"}))
    web = alloc.allocate(LabelSet.from_dict({"app": "web"}))

    def resolve(rules_by_port):
        port_rules = []
        for port, pats in sorted(rules_by_port.items()):
            if port == 53:
                port_rules.append(api.PortRule(
                    ports=(api.PortProtocol(53, fl.Protocol.UDP),),
                    rules=pkg.l7.L7Rules(dns=tuple(
                        pkg.l7.PortRuleDNS(match_name=q) for q in pats))))
            else:
                port_rules.append(api.PortRule(
                    ports=(api.PortProtocol(port, fl.Protocol.TCP),),
                    rules=pkg.l7.L7Rules(http=tuple(
                        pkg.l7.PortRuleHTTP(path=p, method="GET")
                        for p in pats))))
        rules = [api.Rule(
            endpoint_selector=api.EndpointSelector.from_labels(app="db"),
            ingress=(api.IngressRule(
                from_endpoints=(api.EndpointSelector.from_labels(
                    app="web"),),
                to_ports=tuple(port_rules)),))]
        repo = pkg.repository.Repository()
        repo.add(rules, sanitize=False)
        return {db: pkg.mapstate.PolicyResolver(
            repo, pkg.selectorcache.SelectorCache(alloc)).resolve(
                alloc.lookup(db))}

    def http(port, path):
        return fl.Flow(src_identity=web, dst_identity=db, dport=port,
                       protocol=fl.Protocol.TCP,
                       direction=fl.TrafficDirection.INGRESS,
                       l7=fl.L7Type.HTTP,
                       http=fl.HTTPInfo(method="GET", path=path))

    def dns(q):
        return fl.Flow(src_identity=web, dst_identity=db, dport=53,
                       protocol=fl.Protocol.UDP,
                       direction=fl.TrafficDirection.INGRESS,
                       l7=fl.L7Type.DNS, dns=fl.DNSInfo(query=q))

    return resolve, http, dns, db


def test_session_follows_bank_scoped_policy_churn():
    """A bank-scoped commit rebinds the session to the loader's new
    engine without a reset and refills only the rows it names; a no-op
    commit drops nothing. Every answer equals the serving engine's and
    the reference session's, state included."""
    base = [f"/p{i}/.*" for i in range(10)]
    runs = []
    for pkg in PKGS:
        resolve, http, _dns, db = _db_world(pkg, (80,))
        eng1 = pkg.engine(resolve({80: base}), bank_size=4)
        loader = _StubLoader(eng1)
        flows = ([http(80, f"/p{i}/x") for i in range(10)]
                 + [http(80, "/no")]) * 20
        sess = pkg.session.IncrementalSession(eng1, loader=loader)
        trail = [_drive(pkg, sess, flows, len(flows))]
        # CNP add on (db, http, 80)
        eng2 = pkg.engine(resolve({80: base + ["/new/.*"]}), bank_size=4)
        loader.engine = eng2
        pkg.bump(identities={db}, identity_families={(db, "http")},
                 identity_family_ports={(db, "http", 80)})
        trail.append(_drive(pkg, sess, flows, len(flows)))
        assert sess.engine is eng2
        assert trail[-1][0] == _direct(eng2, flows)
        # back to base, then a no-op commit: hits accrue, nothing drops
        eng3 = pkg.engine(resolve({80: base}), bank_size=4)
        loader.engine = eng3
        pkg.bump(identities={db}, identity_families={(db, "http")})
        trail.append(_drive(pkg, sess, flows, len(flows)))
        assert trail[-1][0] == _direct(eng3, flows)
        pkg.bump()
        trail.append(_drive(pkg, sess, flows, len(flows)))
        assert sess.engine is eng3
        runs.append(trail)
    assert runs[0] == runs[1]
    states = [t[1][0][2] for t in runs[1]]
    dirty = [t[1][0][1] for t in runs[1]]
    n_rows = states[0]["n_rows"]
    assert all(s["resets"] == 0 and s["n_rows"] == n_rows for s in states)
    # every row is (db, http, 80): the bank-scoped commits refill all
    assert dirty[1] == dirty[2] == list(range(n_rows)) and dirty[3] is None
    hits, misses, inv, _ = zip(*(s["memo"] for s in states))
    assert inv == (0, 1, 2, 2) and misses == (n_rows, 2 * n_rows,
                                              3 * n_rows, 3 * n_rows)
    assert hits[3] > hits[2]


def test_session_refill_is_port_granular():
    """A commit naming only (db, http, 8080) refills EXACTLY the http
    rows on 8080; the port-80 and DNS rows keep serving."""
    base = {80: [f"/stable{i}/.*" for i in range(4)],
            8080: [f"/alt{i}/.*" for i in range(4)],
            53: ["api.corp.io"]}
    runs = []
    for pkg in PKGS:
        resolve, http, dns, db = _db_world(pkg, (80, 8080, 53))
        eng1 = pkg.engine(resolve(base), bank_size=4)
        loader = _StubLoader(eng1)
        flows = ([http(80, f"/stable{i}/x") for i in range(4)]
                 + [http(8080, f"/alt{i}/x") for i in range(4)]
                 + [http(8080, "/nope"), dns("api.corp.io"),
                    dns("evil.net")]) * 16
        sess = pkg.session.IncrementalSession(eng1, loader=loader)
        first = _drive(pkg, sess, flows, 64)
        n8080 = [i for i, (_, l7t, dport) in enumerate(sess._row_eps)
                 if l7t == 1 and dport == 8080]
        eng2 = pkg.engine(resolve({**base, 8080: base[8080]
                                   + ["/alt-new/.*"]}), bank_size=4)
        loader.engine = eng2
        pkg.bump(identities={db}, identity_families={(db, "http")},
                 identity_family_ports={(db, "http", 8080)})
        second = _drive(pkg, sess, flows, len(flows))
        assert second[0] == _direct(eng2, flows)
        assert sess.engine is eng2
        runs.append((first, second, n8080))
    assert runs[0] == runs[1]
    first, second, n8080 = runs[1]
    assert 0 < len(n8080) < first[1][-1][2]["n_rows"]
    (_, dirty, state), = second[1]
    assert dirty == n8080
    assert state["memo"][1] - first[1][-1][2]["memo"][1] == len(n8080)
    assert state["resets"] == 0


def test_session_rebinds_only_to_a_torch_engine():
    """The swap check reads the engine's type: a loader whose engine is
    not a :class:`TorchVerdictEngine` (here the reference's) is not
    rebound to; a TorchVerdictEngine is."""
    resolve, http, _dns, db = _db_world(PORT, (80,))
    eng1 = PORT.engine(resolve({80: ["/a/.*"]}))
    flows = [http(80, "/a/x"), http(80, "/b")] * 4
    loader = _StubLoader(eng1)
    sess = PORT.session.IncrementalSession(eng1, loader=loader)
    _drive(PORT, sess, flows, 8)
    jresolve, _, _, _ = _db_world(JAX, (80,))
    loader.engine = JAX.engine(jresolve({80: ["/b"]}))
    PORT.bump(identities={db}, identity_families={(db, "http")})
    got, _ = _drive(PORT, sess, flows, 8)
    assert sess.engine is eng1 and got == _direct(eng1, flows)
    eng2 = PORT.engine(resolve({80: ["/b"]}))
    loader.engine = eng2
    PORT.bump(identities={db}, identity_families={(db, "http")})
    got, _ = _drive(PORT, sess, flows, 8)
    assert sess.engine is eng2 and got == _direct(eng2, flows)
    assert got != _direct(eng1, flows)


def test_generic_chunk_raises_naming_q5(engines):
    fl = PORT.flow
    engine, flows = engines["http"][PORT.root]
    chunk = list(flows[:4]) + [fl.Flow(
        src_identity=1, dst_identity=2, dport=9000, l7=fl.L7Type.GENERIC,
        generic=fl.GenericL7Info(proto="x", fields={"k": "v"}))]
    rec, l7, offsets, blob, gen = PORT.sections(chunk)
    assert gen is not None
    sess = PORT.session.IncrementalSession(engine)
    with pytest.raises(NotImplementedError, match="Q5"):
        sess.encode_ids(rec, l7, offsets, blob, gen)
