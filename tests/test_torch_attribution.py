"""The port's provenance plane against the JAX package's, on the CPU,
mirroring the engine-side half of ``tests/test_provenance.py``.

* the packed provenance word: ``pack_word``/``unpack_word`` give the
  reference's words over a grid of codes, families, generations, pack
  cycles and kernels;
* ``kernel_label`` of each scenario's engine, and its shapes;
* ``AttributionMap.resolve`` and ``rule_label`` equal for every
  (l7 type, code) of each scenario, and every code the direct step
  emits resolves;
* ``flow_family``, with frontend records raising naming Q5;
* ``ServedPack`` lanes (verdict, ``l7_match``, ``match_spec``), cited
  generations and memo-hit masks across a hot swap, equal to the
  reference session's; ``ServedPack.host`` reads back once;
* ``ServedPack.words``;
* explain entries (``runtime/explain.build_entries``), the flow
  aggregator's snapshot built from them and ``merge_snapshots``;
* the explain sample's flows rebuilt from capture sections
  (``records_to_flows``, ``records_to_flows_l7``).

Sizes: the synth scenarios at 12 rules × 240 flows (http), 6 × 180
(fqdn), 12 × 200 (kafka).
"""

import itertools

import numpy as np
import pytest
import torch

from test_torch_session import (
    JAX,
    PKGS,
    PORT,
    SIZES,
    _db_world,
    _direct,
    _scenario,
    _StubLoader,
)

KERNELS = ("", "legacy", "dfa-dense", "nfa-bitset", "mixed", "oracle",
           "unknown")


@pytest.fixture(scope="module")
def worlds():
    """name → {pkg root: (engine, flows, direct output)}."""
    out = {}
    for name in SIZES:
        out[name] = {}
        for pkg in PKGS:
            pi, sc = _scenario(pkg, name)
            eng = pkg.engine(pi)
            out[name][pkg.root] = (eng, sc.flows,
                                   {k: np.asarray(v) for k, v in
                                    eng.verdict_flows(sc.flows).items()})
    return out


def test_pack_word_equals_reference():
    grid = itertools.product((-1, 0, 1, 137, (1 << 20) - 2, 1 << 21),
                             range(8), (False, True),
                             (0, 1, 42, (1 << 24) + 5), (-1, 0, 77, 1500),
                             KERNELS)
    n = 0
    for args in grid:
        w = PORT.attribution.pack_word(*args)
        assert w == JAX.attribution.pack_word(*args), args
        assert PORT.attribution.unpack_word(w) == \
            JAX.attribution.unpack_word(w)
        n += 1
    assert n > 4000
    for legacy in (0, 12345, -7):
        assert PORT.attribution.unpack_word(legacy) is None \
            and JAX.attribution.unpack_word(legacy) is None
    d = PORT.attribution.unpack_word(PORT.attribution.pack_word(
        137, 1, True, 42, 77, "dfa-dense"))
    assert d == {"code": 137, "family": 1, "memo_hit": True,
                 "generation": 42, "pack_cycle": 77, "kernel": "dfa-dense"}


@pytest.mark.parametrize("name", list(SIZES))
def test_kernel_label_equals_reference(worlds, name):
    labels = [pkg.attribution.kernel_label(worlds[name][pkg.root][0])
              for pkg in PKGS]
    assert labels[0] == labels[1] != ""


def test_kernel_label_shapes():
    class _E:
        impl_plan = {}

    for plan, want in (({}, "legacy"),
                       ({"path": "dfa-dense", "dns": "dfa-dense"},
                        "dfa-dense"),
                       ({"path": "nfa-bitset", "dns": "dfa-dense"},
                        "mixed")):
        _E.impl_plan = plan
        assert PORT.attribution.kernel_label(_E()) == want == \
            JAX.attribution.kernel_label(_E())


@pytest.mark.parametrize("name", list(SIZES))
def test_attribution_map_resolves_as_the_reference(worlds, name):
    (jeng, jflows, jout), (eng, flows, out) = (
        worlds[name][pkg.root] for pkg in PKGS)
    np.testing.assert_array_equal(out["l7_match"], jout["l7_match"])
    jmap = JAX.attribution.AttributionMap.from_policy(jeng.policy)
    amap = eng.attribution
    assert amap is eng.attribution            # built once
    assert amap.space == jmap.space
    top = max(len(v) for v in amap._members.values()) + 2
    seen = 0
    for l7t, code in itertools.product(range(9), range(-1, top)):
        res = amap.resolve(l7t, code)
        assert res == jmap.resolve(l7t, code), (l7t, code)
        assert amap.rule_label(l7t, code) == jmap.rule_label(l7t, code)
        seen += res is not None
    assert seen > 0
    # every L7 winner of the direct step decodes to live rules, and
    # every allowed L7 flow has a winner
    l7m = out["l7_match"]
    assert (l7m[out["l7_ok"]] >= 0).all()
    for i, f in enumerate(flows):
        fam = PORT.attribution.flow_family(f)
        assert fam == JAX.attribution.flow_family(jflows[i])
        if l7m[i] >= 0:
            res = amap.resolve(fam, int(l7m[i]))
            assert res is not None and res["rule_ids"]
            assert amap.rule_label(fam, int(l7m[i]))


def test_flow_family_frontend_records_raise_naming_q5():
    fl = PORT.flow
    for proto, want in (("r2d2", None), ("cassandra", None),
                        ("x-custom", int(fl.L7Type.GENERIC))):
        f = fl.Flow(src_identity=1, dst_identity=2, dport=9000,
                    l7=fl.L7Type.GENERIC,
                    generic=fl.GenericL7Info(proto=proto, fields={}))
        if want is None:
            with pytest.raises(NotImplementedError, match="Q5"):
                PORT.attribution.flow_family(f)
        else:
            assert PORT.attribution.flow_family(f) == want
            jf = JAX.flow.Flow(src_identity=1, dst_identity=2, dport=9000,
                               l7=JAX.flow.L7Type.GENERIC,
                               generic=JAX.flow.GenericL7Info(
                                   proto=proto, fields={}))
            assert JAX.attribution.flow_family(jf) == want


def _pack(pack, n, gen_marks):
    """A ServedPack's first ``n`` rows, with cited generations named by
    ``gen_marks`` (the two packages count generations separately)."""
    h = pack.host()
    names = {g: k for k, g in gen_marks.items()}
    return {"verdict": np.asarray(h.verdict)[:n].tolist(),
            "l7_match": np.asarray(h.l7_match)[:n].tolist(),
            "match_spec": np.asarray(h.match_spec)[:n].tolist(),
            "memo_hit": np.asarray(h.memo_hit)[:n].tolist(),
            "gens": [names.get(int(g), int(g)) for g in h.gens[:n]],
            "generation": names.get(h.generation), "kernel": h.kernel}


def test_served_pack_across_hot_swap_equals_reference():
    """A bank-scoped swap of (db, http): the http rows refill and cite
    the new generation, the dns rows stay memo hits citing the old one;
    lanes, citations and hit masks equal the reference session's."""
    paths = [f"/p{i}/.*" for i in range(6)]
    names = [f"api{i}.corp.io" for i in range(4)]
    runs = []
    for pkg in PKGS:
        resolve, http, dns, db = _db_world(pkg, (80, 53))
        eng1 = pkg.engine(resolve({80: paths, 53: names}), bank_size=4)
        loader = _StubLoader(eng1)
        flows = ([http(80, f"/p{i}/x") for i in range(6)]
                 + [http(80, "/no")] + [dns(q) for q in names]
                 + [dns("evil.net")])
        n = len(flows)
        rec, l7, offsets, blob, gen = pkg.sections(flows)
        sess = pkg.session.IncrementalSession(eng1, loader=loader)
        marks = {"g1": pkg.memo.policy_generation()}
        packs = []
        for step in range(3):
            if step == 2:
                eng2 = pkg.engine(resolve({80: paths + ["/new/.*"],
                                           53: names}), bank_size=4)
                loader.engine = eng2
                marks["g2"] = pkg.bump(identities={db},
                                       identity_families={(db, "http")})
            idx, _ = sess.encode_ids(rec, l7, offsets, blob, gen)
            pack = sess.serve_ids(idx, provenance=True)
            assert isinstance(pack, pkg.attribution.ServedPack)
            packs.append(_pack(pack, n, marks))
        assert packs[2]["verdict"] == _direct(eng2, flows)
        runs.append(packs)
    assert runs[0] == runs[1]
    first, steady, swapped = runs[1]
    n_http = 7
    assert first["gens"] == ["g1"] * len(first["gens"])
    assert not any(first["memo_hit"]) and all(steady["memo_hit"])
    assert swapped["gens"] == ["g2"] * n_http + ["g1"] * (
        len(first["gens"]) - n_http)
    assert swapped["memo_hit"] == [False] * n_http + [True] * (
        len(first["gens"]) - n_http)
    assert swapped["generation"] == "g2"


def test_served_pack_host_reads_back_once(monkeypatch):
    lanes = [torch.arange(8, dtype=torch.int32) + k for k in range(3)]
    pack = PORT.attribution.ServedPack(
        verdict=lanes[0], l7_match=lanes[1], match_spec=lanes[2],
        gens=np.arange(8), memo_hit=np.zeros(8, dtype=bool),
        generation=3, kernel="dfa-dense", pack_cycle=2)
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **kw):
        calls.append(tuple(self.shape))
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    h = pack.slice(2, 5).host()
    assert calls == [(3, 5)]
    for got, lane in zip((h.verdict, h.l7_match, h.match_spec), lanes):
        assert got.dtype == np.int32
        assert got.tolist() == lane[2:7].tolist()
    assert h.gens.tolist() == [2, 3, 4, 5, 6] and h.pack_cycle == 2


@pytest.mark.parametrize("name", ["http", "fqdn"])
def test_explain_entries_and_flow_aggregate_equal_reference(worlds, name):
    snaps = []
    for pkg in PKGS:
        eng, flows, out = worlds[name][pkg.root]
        k = 40
        amap = pkg.attribution.AttributionMap.from_policy(eng.policy)
        entries = pkg.explain.build_entries(
            "t-1", "serve", flows[:k], out["verdict"][:k],
            out["l7_match"][:k], amap, gens=np.full(k, 3),
            memo_hit=np.arange(k) % 2 == 0, match_spec=out["match_spec"][:k],
            kernel="dfa-dense", pack_cycle=9, generation=3, host_id="h0",
            sample=k, tenant="acme")
        agg = pkg.flowagg.FlowAggregator(host="h0")
        agg.note_served(k)
        assert agg.observe_entries(entries) == k
        for e in entries:
            e.pop("t")
            e["provenance"].pop("bank_epoch", None)
        snaps.append((entries, agg.snapshot()))
    assert snaps[0] == snaps[1]
    assert any(e["provenance"]["explained"] for e in snaps[1][0])


def test_served_pack_words_equal_reference():
    rng = np.random.default_rng(5)
    lanes = dict(verdict=rng.integers(0, 6, 40).astype(np.int32),
                 l7_match=rng.integers(-1, 30, 40).astype(np.int32),
                 match_spec=rng.integers(-1, 9, 40).astype(np.int32),
                 gens=rng.integers(0, 1 << 25, 40),
                 memo_hit=rng.random(40) < 0.5)
    words = [pkg.attribution.ServedPack(
        **lanes, generation=7, kernel="dfa-dense", pack_cycle=1029).words()
        for pkg in PKGS]
    np.testing.assert_array_equal(words[1], words[0])


def test_flow_snapshots_merge_as_the_reference(worlds):
    merged = []
    for pkg in PKGS:
        eng, flows, out = worlds["http"][pkg.root]
        amap = pkg.attribution.AttributionMap.from_policy(eng.policy)
        snaps = []
        for h, lo in (("h0", 0), ("h1", 20), ("h2", 30)):
            agg = pkg.flowagg.FlowAggregator(host=h, max_keys=2)
            entries = pkg.explain.build_entries(
                "t", "serve", flows[lo:lo + 30], out["verdict"][lo:lo + 30],
                out["l7_match"][lo:lo + 30], amap, gens=np.full(30, 2),
                sample=30)
            for e in entries:
                e["provenance"].pop("bank_epoch", None)
            agg.note_served(30)
            agg.observe_entries(entries)
            snaps.append(agg.snapshot())
        merged.append(pkg.flowagg.merge_snapshots(snaps))
    assert merged[0] == merged[1]
    assert merged[1]["overflow"] > 0 and merged[1]["records"] == 90


@pytest.mark.parametrize("name", list(SIZES))
def test_records_back_to_flows_as_the_reference(worlds, name):
    """The explain sample's reconstruction: ``records_to_flows`` and
    ``records_to_flows_l7`` rebuild the reference's flows from capture
    sections, and ``flow_to_dict`` serializes them alike."""
    dicts = []
    for pkg in PKGS:
        _, flows, _ = worlds[name][pkg.root]
        rec, l7, offsets, blob, gen = pkg.sections(flows[:50])
        hub = __import__(f"{pkg.root}.ingest.hubble", fromlist=["x"])
        dicts.append((
            [hub.flow_to_dict(f) for f in pkg.binary.records_to_flows_l7(
                rec, l7, offsets, blob, gen=gen)],
            [hub.flow_to_dict(f) for f in
             pkg.binary.records_to_flows(rec)]))
    assert dicts[0] == dicts[1]
    _, flows, _ = worlds[name][PORT.root]
    assert [(d["source"], d["destination"], d["l4"]) for d in dicts[1][0]] \
        == [(d["source"], d["destination"], d["l4"]) for d in
            map(hub.flow_to_dict, flows[:50])]
