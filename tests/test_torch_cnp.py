"""The port's CiliumNetworkPolicy loader against the JAX package's, on
the CPU, exact.

* ``policy/api/_yaml.py``, the port's reader of the YAML subset CNP
  files use, equals ``yaml.safe_load_all`` on every file under
  ``examples/policies``, on the CNP texts of the reference's tests, on
  YAML 1.1's scalar corners (``yes``/``on``/``off`` booleans, octal,
  underscores, base 60, quoted numbers) and on hypothesis-made documents
  of the subset, dumped by PyYAML in block and flow style, with comments
  woven in; it raises ``ValueError`` naming the line on anchors,
  aliases, tags, block scalars and the rest outside the subset;
* ``load_cnp_dir`` / ``load_cnp_yaml_text`` equal the reference's, rule
  by rule, field by field (dataclasses and enums as plain data);
* the mixed scenario (BASELINE configs[3]: the corpus × synthetic
  tuples, seed 0) makes the same tuples in both packages, and its
  compiled arrays are byte-equal;
* the control-plane golden (``tests/golden/corpus_verdicts.json``): the
  corpus loaded by the port's loader, resolved by the port's resolver
  over the reference agent's identities and named ports (the port has no
  agent yet: queue 1's Q13), equals the agent's MapStates, and the
  port's engine gives the golden verdicts.

These tests need ``pyyaml`` (the reference's loader reads with it).
"""

import dataclasses
import enum
import glob
import json
import os
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

yaml = pytest.importorskip("yaml")

from cilium_tpu.policy.api import cnp as jax_cnp  # noqa: E402

from cilium_tpu_torch.policy.api import cnp as port_cnp  # noqa: E402
from cilium_tpu_torch.policy.api._yaml import safe_load_all  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
CORPUS = os.path.join(REPO, "examples", "policies")
CORPUS_FILES = sorted(glob.glob(os.path.join(CORPUS, "**", "*.yaml"),
                                recursive=True))
#: reference test modules whose ``CNP`` text the reader must read alike
CNP_TEXT_MODULES = ("test_accesslog_ingest", "test_agent_dns_e2e",
                    "test_api_watcher", "test_auth_mode", "test_cli")


def _pyyaml(text):
    return list(yaml.safe_load_all(text))


def _plain(x):
    """Dataclasses, enums and sets as plain comparable data."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            _plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, (set, frozenset)):
        return frozenset(_plain(v) for v in x)
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    return x


# ------------------------------------------------------------ the reader
def test_the_corpus_is_the_published_one():
    assert len(CORPUS_FILES) == 31
    multi = [os.path.relpath(p, CORPUS) for p in CORPUS_FILES
             if len(_pyyaml(open(p).read())) > 1]
    assert {"l7/multi-spec.yaml", "realistic/ecommerce.yaml",
            "realistic/fintech.yaml"} <= set(multi)


@pytest.mark.parametrize("path", CORPUS_FILES,
                         ids=[os.path.relpath(p, CORPUS)
                              for p in CORPUS_FILES])
def test_reader_equals_pyyaml_on_the_corpus(path):
    with open(path) as f:
        text = f.read()
    assert safe_load_all(text) == _pyyaml(text)


@pytest.mark.parametrize("module", CNP_TEXT_MODULES)
def test_reader_equals_pyyaml_on_the_reference_tests_cnps(module):
    sys.path.insert(0, TESTS)
    text = __import__(module).CNP
    assert safe_load_all(text) == _pyyaml(text)


SCALARS = """\
a: yes
b: No
c: ON
d: off
e: True
f: ~
g: null
h:
i: 017
j: 08
k: 1_000
l: 0x1F
m: 0b101
n: +12
o: -0
p: 1:30
q: 1.5e+3
r: 1e3
s: .5
t: -.inf
u: .NaN
v: "22"
w: '0x10'
x: y
z: 1.2.3
aa: '#not a comment'
ab: 'it''s'
ac: "\\x41\\u00e9\\t\\"q\\""
ad: http://x/y:z
ae: b:c
af: -1
ag: 12 # a comment
ah: [1, 'a', "b", {c: d}, []]
ai: {x, y: , z: [1,
     2]}
"""


def test_reader_resolves_scalars_as_pyyaml():
    got, want = safe_load_all(SCALARS), _pyyaml(SCALARS)
    nan = [k for k, v in want[0].items() if v != v]
    assert nan == ["u"] and got[0]["u"] != got[0]["u"]
    for d in (got[0], want[0]):
        del d["u"]
    assert got == want
    assert got[0]["v"] == "22" and got[0]["i"] == 15 and got[0]["j"] == "08"


@pytest.mark.parametrize("text", [
    "a: 1\n---\n", "---\n---\na: 1\n", "# only a comment\n", "",
    "---\n# c\n", "a:\n- 1\n- - 2\n  - 3\n-\n", "- a: 1\n  b: [x]\n- c\n",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3\n", "foo\n", "  a: 1\n  b: 2\n",
    "ports: [{port: \"22\", protocol: TCP}]\n", "a: b # c\r\nd: e\r\n",
])
def test_reader_equals_pyyaml_on_documents_and_nesting(text):
    assert safe_load_all(text) == _pyyaml(text)


@pytest.mark.parametrize("text", [
    "a: &x 1\n", "a: 1\nb: *x\n", "a: !!str 1\n", "a: !Ref x\n",
    "a: |\n  x\n", "a: >\n  x\n", "? a\n: b\n", "a: 2001-12-14\n",
    "<<: {a: 1}\n", "a: b\n  c\n", "a: 'x\n  y'\n", "a:\n\t- 1\n",
    "%YAML 1.1\n---\na: 1\n", "a: [b\n  c]\n", "--- a\n", "a: 1\n...\n",
    "a: - 1\n", "a: b: c\n", "[a]: b\n", "a: @x\n",
])
def test_reader_raises_outside_the_subset(text):
    with pytest.raises(ValueError, match=r"line \d+"):
        safe_load_all(text)


_KEYS = st.one_of(
    st.text(alphabet="abcdefghijklmnopqrstuvwxyz-_.0123456789:/",
            min_size=1, max_size=12),
    st.integers(-1000, 1000), st.booleans(), st.none())
_STRINGS = st.text(
    alphabet=st.sampled_from(
        list("abcXYZ019 -_.:/#'\"{}[],&*!|>%@`?=~\\") + ["é", "ü", "中"]),
    max_size=16)
_LEAVES = st.one_of(
    st.none(), st.booleans(), st.integers(-10 ** 9, 10 ** 9),
    st.floats(allow_nan=False, allow_infinity=True), _STRINGS,
    st.sampled_from(["yes", "No", "on", "OFF", "~", "null", "017", "08",
                     "1_000", "0x1F", "1:30", ".5", "22", "-", "?", ":",
                     "a: b", "a #b", " lead", "trail "]))
_DOCS = st.recursive(
    _LEAVES, lambda kids: st.one_of(
        st.lists(kids, max_size=4),
        st.dictionaries(_KEYS, kids, max_size=4)),
    max_leaves=16)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(docs=st.lists(_DOCS.filter(lambda d: isinstance(d, (dict, list))),
                     min_size=1, max_size=3),
       flow=st.sampled_from([False, True, None]),
       unicode=st.booleans(),
       comments=st.lists(st.booleans(), max_size=40))
def test_reader_equals_pyyaml_on_hypothesis_documents(docs, flow, unicode,
                                                      comments):
    text = "---\n".join(
        yaml.safe_dump(d, default_flow_style=flow, width=10 ** 9,
                       allow_unicode=unicode, sort_keys=False)
        for d in docs)
    # a comment line after some lines: never inside a flow collection,
    # since each document's flow collections sit on one line
    lines = text.split("\n")
    woven = []
    for i, line in enumerate(lines):
        woven.append(line)
        if i < len(comments) and comments[i] and i < len(lines) - 1:
            woven.append("  # a comment")
    text = "\n".join(woven)
    want = _pyyaml(text)
    assert want == docs
    assert safe_load_all(text) == want


# ------------------------------------------------------------ the loader
def test_load_cnp_dir_equals_the_reference():
    want, got = jax_cnp.load_cnp_dir(CORPUS), port_cnp.load_cnp_dir(CORPUS)
    assert len(got) == len(want) == 35
    assert sum(len(c.rules) for c in got) == 101
    for w, g in zip(want, got):
        assert (g.name, g.namespace, g.kind, g.labels) == \
            (w.name, w.namespace, w.kind, w.labels)
        assert len(g.rules) == len(w.rules)
        for wr, gr in zip(w.rules, g.rules):
            assert _plain(gr) == _plain(wr), (w.name, wr.description)


@pytest.mark.parametrize("module", CNP_TEXT_MODULES)
def test_load_cnp_yaml_text_equals_the_reference(module):
    sys.path.insert(0, TESTS)
    text = __import__(module).CNP
    assert _plain(port_cnp.load_cnp_yaml_text(text)) == \
        _plain(jax_cnp.load_cnp_yaml_text(text))


def test_loader_errors_equal_the_reference():
    for text in ("kind: Pod\nmetadata: {name: x}\n",
                 "kind: CiliumNetworkPolicy\nspec:\n  nodeSelector: {}\n"):
        for mod in (jax_cnp, port_cnp):
            with pytest.raises(ValueError):
                mod.load_cnp_yaml_text(text)


# ------------------------------------------------ configs[3]: the corpus
@pytest.fixture(scope="module")
def mixed():
    """Each package's mixed scenario (corpus × 3000 tuples, seed 0),
    realized."""
    sys.path.insert(0, TESTS)
    from test_torch_loader import JAX, PORT

    return {pkg.root: pkg.synth.realize_scenario(
        pkg.synth.synth_mixed_scenario(CORPUS, n_tuples=3000, seed=0))
        for pkg in (JAX, PORT)}


def test_mixed_tuples_equal_the_reference(mixed):
    def key(f):
        return (f.src_identity, f.dst_identity, f.dport, int(f.protocol),
                int(f.direction), int(f.l7), _plain(f.http),
                _plain(f.kafka), _plain(f.dns), f._src_name, f._dst_name)

    (_, js), (_, ps) = mixed["cilium_tpu"], mixed["cilium_tpu_torch"]
    assert js.ids == ps.ids
    assert [key(f) for f in ps.flows] == [key(f) for f in js.flows]
    assert len(ps.rules) == 101


def test_mixed_compiled_arrays_equal_the_reference(mixed):
    from test_torch_loader import JAX, PORT, _assert_same_policy, _build

    jpi, ppi = mixed["cilium_tpu"][0], mixed["cilium_tpu_torch"][0]
    assert sorted(jpi) == sorted(ppi)
    _assert_same_policy(_build(JAX, jpi), _build(PORT, ppi))


# --------------------------------------------- the control-plane golden
def _port_labels(labels):
    from cilium_tpu_torch.core.labels import Label, LabelSet

    return LabelSet(Label(key=lb.key, value=lb.value, source=lb.source)
                    for lb in labels)


def test_port_loader_and_resolver_give_the_golden_verdicts(tmp_path):
    """The corpus through the port's ``load_cnp_yaml`` (each file, in the
    golden agent's order) and ``PolicyResolver``, over the reference
    agent's identities and named ports; MapStates equal the agent's, and
    the port's engine gives the golden verdicts."""
    sys.path.insert(0, TESTS)
    import test_controlplane_golden as g
    from test_torch_loader import _to_port

    from cilium_tpu_torch.core.config import Config
    from cilium_tpu_torch.policy.mapstate import PolicyResolver
    from cilium_tpu_torch.policy.repository import Repository
    from cilium_tpu_torch.policy.selectorcache import SelectorCache
    from cilium_tpu_torch.runtime.loader import Loader

    agent, ids = g.build_agent()
    try:
        flows = g.build_flows(ids)
        ref = dict(agent.loader.per_identity)
        identities = dict(agent.selector_cache.identities())
        em = agent.endpoint_manager
        np_of = {}
        for ep in em.endpoints():
            table = np_of.setdefault(ep.identity, {})
            for k, v in ep.named_ports.items():
                table.setdefault(k, v)
        cluster = em.cluster_name
    finally:
        agent.stop()
    cache = SelectorCache()
    for nid, labels in sorted(identities.items()):
        cache.add_identity(nid, _port_labels(labels))
    repo = Repository()
    for path in sorted(glob.glob(os.path.join(CORPUS, "*", "*.yaml"))):
        for cnp in port_cnp.load_cnp_yaml(path):
            repo.add(cnp.rules)
    resolver = PolicyResolver(repo, cache, cluster_name=cluster,
                              named_ports_of=lambda nid: np_of.get(nid, {}))
    per_identity = {nid: resolver.resolve(_port_labels(identities[nid]),
                                          named_ports=np_of.get(nid, {}))
                    for nid in ref}
    for nid, ms in ref.items():
        assert _plain(per_identity[nid].entries) == \
            _plain(_to_port(ms).entries), nid
    with open(g.GOLDEN) as fp:
        golden = json.load(fp)["verdicts"]
    cfg = Config()
    cfg.loader.cache_dir = str(tmp_path)
    ld = Loader(cfg, device="cpu")
    try:
        ld.regenerate(per_identity, revision=1)
        got = ld.engine.verdict_flows(_to_port(flows))["verdict"]
    finally:
        ld.close()
    assert [int(v) for v in got] == golden
    assert len(golden) == len(flows) and len(set(golden)) > 1
    assert np.isin(golden, [1, 2, 5]).all()
