"""The port's Hubble protobuf codec (``ingest/flowpb.py``) against the
JAX package's, on the CPU.

* ``encode_flow`` gives the same bytes in both packages over the
  reference-capture golden's flows, the reference test's sample flows
  (HTTP, DNS, Kafka, ICMP, drops), unknown and unnamed Kafka roles,
  ICMPv6, SCTP and empty labels, and hypothesis-random flows;
  ``decode_flow`` on each package's bytes gives equal ``flow_to_dict``;
* a capture written by either package reads back equal in the other
  (``read_pb_capture`` / ``iter_pb_capture`` with ``start`` and
  ``limit``), ``looks_like_pb_capture`` agrees on every format, the
  wire errors are the port's ``CaptureError`` with the reference's
  messages, and the Kafka role table is derived from the port's own
  ``policy/api/l7.py``, an unknown role never collapsing onto produce;
* the decoded flows of the http, kafka and fqdn scenarios verdict
  equal on all ten lanes through each package's ``Loader`` (the
  reference with the gate on, ``JAX_PLATFORMS=cpu``; the port with
  ``device="cpu"``), and the reference's unknown-role ACL case gives
  the same verdicts.

Mirrors ``tests/test_flowpb.py``.
"""

import importlib
import json
import os
import types

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from test_torch_service import make_loader

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "reference_capture.jsonl")
LANES = ("verdict", "match_spec", "ruleset", "allowed", "l3l4_allowed",
         "redirect", "l7_ok", "l7_log", "auth_required", "l7_match")


def _pkg(root):
    ns = types.SimpleNamespace(root=root, jax=root == "cilium_tpu")
    for attr, mod in (("flow", "core.flow"),
                      ("flowpb", "ingest.flowpb"),
                      ("hubble", "ingest.hubble"),
                      ("accesslog", "ingest.accesslog"),
                      ("binary", "ingest.binary"),
                      ("synth", "ingest.synth"),
                      ("config", "core.config"),
                      ("loader", "runtime.loader"),
                      ("l7", "policy.api.l7"),
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


def sample_flows(pkg):
    """The reference test's samples, and the edges: unknown (-1) and
    unnamed (99) Kafka roles, a named one (8), ICMPv6, SCTP, labels,
    a node name, a DNS rcode, an absolute URL."""
    F = pkg.flow
    return [
        F.Flow(src_identity=101, dst_identity=202, dport=80, sport=4444,
               l7=F.L7Type.HTTP, verdict=F.Verdict.FORWARDED, time=1234.5,
               http=F.HTTPInfo(method="POST", path="/api/y?q=1",
                               host="svc.local",
                               headers=(("X-Token", "secret"),
                                        ("Accept", "json")))),
        F.Flow(src_identity=103, dst_identity=204, dport=9092,
               l7=F.L7Type.KAFKA,
               kafka=F.KafkaInfo(api_key=1, api_version=7, topic="orders",
                                 correlation_id=42)),
        F.Flow(src_identity=105, dst_identity=206, dport=53,
               protocol=F.Protocol.UDP,
               direction=F.TrafficDirection.EGRESS, l7=F.L7Type.DNS,
               dns=F.DNSInfo(query="docs.corp.io", rcode=3)),
        F.Flow(src_identity=107, dst_identity=208, dport=8,
               protocol=F.Protocol.ICMP),
        F.Flow(src_identity=109, dst_identity=210, dport=443,
               direction=F.TrafficDirection.EGRESS,
               verdict=F.Verdict.DROPPED),
        F.Flow(src_identity=1, dst_identity=2, dport=128,
               protocol=F.Protocol.ICMPV6, node_name="node-a",
               src_labels=("k8s:app=a", "k8s:env=prod"), dst_labels=()),
        F.Flow(src_identity=3, dst_identity=4, dport=3868, sport=7,
               protocol=F.Protocol.SCTP, verdict=F.Verdict.AUDIT),
        F.Flow(dport=9092, l7=F.L7Type.KAFKA,
               kafka=F.KafkaInfo(api_key=-1, topic="t")),
        F.Flow(dport=9092, l7=F.L7Type.KAFKA,
               kafka=F.KafkaInfo(api_key=99, api_version=2,
                                 client_id="c", correlation_id=7)),
        F.Flow(dport=9092, l7=F.L7Type.KAFKA,
               kafka=F.KafkaInfo(api_key=8, topic="offsets")),
        F.Flow(dport=80, l7=F.L7Type.HTTP, time=1.000000001,
               http=F.HTTPInfo(method="GET", code=200,
                               path="http://svc.local/api/x?p=2")),
        F.Flow(),
    ]


def golden_flows(pkg):
    with open(GOLDEN) as fp:
        return [pkg.accesslog.parse_capture_line(json.loads(line))
                for line in fp if line.strip()]


def _dicts(pkg, flows):
    return [pkg.hubble.flow_to_dict(f) for f in flows]


# ------------------------------------------------------- wire bytes
@pytest.mark.parametrize("source", ["samples", "golden"])
def test_encode_is_byte_equal_and_decodes_equal(source):
    make = sample_flows if source == "samples" else golden_flows
    wires = {p.root: [p.flowpb.encode_flow(f) for f in make(p)]
             for p in PKGS}
    assert wires["cilium_tpu_torch"] == wires["cilium_tpu"]
    for wire in wires.values():
        # each package decodes the other's bytes to the same flows
        assert (_dicts(PORT, [PORT.flowpb.decode_flow(b) for b in wire])
                == _dicts(JAX, [JAX.flowpb.decode_flow(b) for b in wire]))


def test_decoded_edges_equal_the_reference():
    want = _dicts(JAX, [JAX.flowpb.decode_flow(JAX.flowpb.encode_flow(f))
                        for f in sample_flows(JAX)])
    got = _dicts(PORT, [PORT.flowpb.decode_flow(
        PORT.flowpb.encode_flow(f)) for f in sample_flows(PORT)])
    assert got == want
    by_topic = {d["l7"]["kafka"]["topic"]: d["l7"]["kafka"]["api_key"]
                for d in got if "kafka" in d.get("l7", {})}
    # -1 stays the unknown sentinel, never 0 (produce)
    assert by_topic == {"orders": 1, "t": -1, "": 99, "offsets": 8}
    absolute = got[10]["l7"]["http"]
    assert absolute["url"] == "/api/x?p=2" and absolute["host"] == "svc.local"


_text = st.text(alphabet=st.characters(blacklist_categories=("Cs",)),
                max_size=12)


@st.composite
def _flow_fields(draw):
    proto = draw(st.sampled_from(["TCP", "UDP", "SCTP", "ICMP", "ICMPV6"]))
    d = {"src_identity": draw(st.integers(0, 1 << 24)),
         "dst_identity": draw(st.integers(0, 1 << 24)),
         "dport": draw(st.integers(0, 65535)),
         "sport": draw(st.integers(0, 65535)),
         "protocol": proto,
         "direction": draw(st.sampled_from(["INGRESS", "EGRESS"])),
         "verdict": draw(st.sampled_from(
             [int(v) for v in PORT.flow.Verdict])),
         "time": draw(st.sampled_from([0.0, 1.5, 1753866000.25,
                                       7.000000123])),
         "node_name": draw(_text),
         "src_labels": tuple(draw(st.lists(_text, max_size=3))),
         "dst_labels": tuple(draw(st.lists(_text, max_size=3))),
         "l7": draw(st.sampled_from(["NONE", "HTTP", "DNS", "KAFKA"]))}
    if d["l7"] == "HTTP":
        d["http"] = {"method": draw(_text), "path": draw(_text),
                     "protocol": draw(st.sampled_from(["HTTP/1.1",
                                                       "HTTP/2", ""])),
                     "code": draw(st.integers(0, 599)),
                     "headers": tuple(draw(st.lists(st.tuples(_text, _text),
                                                    max_size=3)))}
    elif d["l7"] == "DNS":
        d["dns"] = {"query": draw(_text), "rcode": draw(st.integers(0, 23))}
    elif d["l7"] == "KAFKA":
        d["kafka"] = {"api_key": draw(st.sampled_from(
                          [-1, 0, 1, 3, 8, 18, 36, 67, 1000])),
                      "api_version": draw(st.integers(0, 20)),
                      "topic": draw(_text),
                      "correlation_id": draw(st.integers(0, 1 << 31))}
    return d


def _make(pkg, d):
    F = pkg.flow
    f = F.Flow(src_identity=d["src_identity"], dst_identity=d["dst_identity"],
               dport=d["dport"], sport=d["sport"],
               protocol=F.Protocol[d["protocol"]],
               direction=F.TrafficDirection[d["direction"]],
               verdict=F.Verdict(d["verdict"]), time=d["time"],
               node_name=d["node_name"], src_labels=d["src_labels"],
               dst_labels=d["dst_labels"], l7=F.L7Type[d["l7"]])
    if "http" in d:
        f.http = F.HTTPInfo(**d["http"])
    if "dns" in d:
        f.dns = F.DNSInfo(**d["dns"])
    if "kafka" in d:
        f.kafka = F.KafkaInfo(**d["kafka"])
    return f


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_flow_fields())
def test_random_flows_encode_and_decode_equal(d):
    wire = JAX.flowpb.encode_flow(_make(JAX, d))
    assert PORT.flowpb.encode_flow(_make(PORT, d)) == wire
    assert (PORT.hubble.flow_to_dict(PORT.flowpb.decode_flow(wire))
            == JAX.hubble.flow_to_dict(JAX.flowpb.decode_flow(wire)))


# ---------------------------------------------------------- captures
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-writes", "port-writes"])
def test_capture_written_by_one_reads_back_in_the_other(tmp_path, writer,
                                                         reader):
    path = str(tmp_path / "cap.pb")
    flows = sample_flows(writer) + golden_flows(writer)
    assert writer.flowpb.write_pb_capture(path, flows) == len(flows)
    want = _dicts(writer, [writer.flowpb.decode_flow(
        writer.flowpb.encode_flow(f)) for f in flows])
    assert _dicts(reader, reader.flowpb.read_pb_capture(path)) == want
    for start, limit in ((0, None), (5, None), (5, 7), (len(flows), 3),
                         (len(flows) + 2, None), (0, 0)):
        got = _dicts(reader, reader.flowpb.iter_pb_capture(
            path, start=start, limit=limit))
        assert got == want[start:None if limit is None else start + limit]
    # and the two writers' files are byte-equal
    other = str(tmp_path / "other.pb")
    reader.flowpb.write_pb_capture(
        other, sample_flows(reader) + golden_flows(reader))
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


def test_sniffer_agrees_on_every_format(tmp_path):
    pb = str(tmp_path / "c.pb")
    PORT.flowpb.write_pb_capture(pb, sample_flows(PORT))
    jsonl = tmp_path / "c.jsonl"
    jsonl.write_text('{"flow": {}}\n')
    ct = str(tmp_path / "c.bin")
    PORT.binary.write_capture_l7(ct, sample_flows(PORT)[:1])
    junk = tmp_path / "junk.bin"
    junk.write_bytes(bytes([0x40]) + b"\xff" * 0x40)
    empty = tmp_path / "empty.pb"
    empty.write_bytes(b"")
    huge = tmp_path / "huge.pb"
    huge.write_bytes(b"\xff\xff\xff\x7f")      # a 256 MiB length
    cases = [pb, str(jsonl), ct, str(junk), str(empty), str(huge)]
    got = [PORT.flowpb.looks_like_pb_capture(p) for p in cases]
    assert got == [JAX.flowpb.looks_like_pb_capture(p) for p in cases]
    assert got == [True, False, False, False, False, False]
    assert list(PORT.flowpb.iter_pb_capture(str(empty))) == []


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 — compared class and message
        return type(e).__name__, str(e)
    return None


def test_wire_errors_are_the_ports_capture_errors(tmp_path):
    assert issubclass(PORT.flowpb.PBError, PORT.binary.CaptureError)
    assert not issubclass(PORT.flowpb.PBError, JAX.binary.CaptureError)
    good = PORT.flowpb.encode_flow(sample_flows(PORT)[0])
    bad = [good[:3], good[:-2], b"\x80", b"\x80" * 11, b"\x0b",
           b"\x09\x01", b"\x0d\x01", b"\x12\x05ab"]
    for wire in bad:
        want = _raised(JAX.flowpb.decode_flow, wire)
        assert want is not None and want[0] == "PBError", wire
        assert _raised(PORT.flowpb.decode_flow, wire) == want, wire
    # a truncated stream fails the same way in the reader
    path = str(tmp_path / "t.pb")
    PORT.flowpb.write_pb_capture(path, sample_flows(PORT)[:3])
    with open(path, "rb") as fp:
        data = fp.read()
    with open(path, "wb") as fp:
        fp.write(data[:-4])
    for pkg in PKGS:
        with pytest.raises(pkg.flowpb.PBError, match="truncated message"):
            pkg.flowpb.read_pb_capture(path)
    # a negative number errors loudly instead of hanging the encoder
    for pkg in PKGS:
        f = sample_flows(pkg)[1]
        f.kafka.api_version = -1
        with pytest.raises(pkg.flowpb.PBError, match="negative varint"):
            pkg.flowpb.encode_flow(f)


def test_unknown_fields_skip_alike():
    """A capture from a newer schema (extra fields of every wire type)
    decodes the consumed subset alike."""
    out = {}
    for pkg in PKGS:
        pb = pkg.flowpb
        msg = bytearray(pb.encode_flow(sample_flows(pkg)[0]))
        pb._tag(msg, 99, pb._VARINT)
        pb._write_varint(msg, 12345)
        pb._tag(msg, 100, pb._I64)
        msg += b"\x01\x02\x03\x04\x05\x06\x07\x08"
        pb._put_len(msg, 101, b"opaque-submessage")
        pb._tag(msg, 102, pb._I32)
        msg += b"\xaa\xbb\xcc\xdd"
        out[pkg.root] = (bytes(msg),
                         pkg.hubble.flow_to_dict(pb.decode_flow(bytes(msg))))
    assert out["cilium_tpu_torch"] == out["cilium_tpu"]
    assert out["cilium_tpu_torch"][1]["l7"]["http"]["method"] == "POST"


def test_kafka_roles_are_derived_from_the_ports_table():
    pb = PORT.flowpb
    assert pb._KAFKA_APIKEY_NUMS is PORT.l7.KAFKA_API_KEYS
    assert pb._KAFKA_APIKEY_NUMS == JAX.flowpb._KAFKA_APIKEY_NUMS
    assert pb._KAFKA_APIKEY_NAMES == JAX.flowpb._KAFKA_APIKEY_NAMES
    assert pb.KAFKA_APIKEY_UNKNOWN == JAX.flowpb.KAFKA_APIKEY_UNKNOWN == -1
    roles = ("somefutureapi", "offsetcommit", "produce", "42", "", "-3")
    keys = {}
    for p in PKGS:
        keys[p.root] = []
        for role in roles:
            out = bytearray()
            p.flowpb._put_varint(out, p.flowpb._K_VERSION, 3)
            p.flowpb._put_str(out, p.flowpb._K_APIKEY, role)
            keys[p.root].append(
                p.flowpb._dec_kafka(memoryview(bytes(out))).api_key)
    assert keys["cilium_tpu_torch"] == keys["cilium_tpu"]
    assert keys["cilium_tpu_torch"][:4] == [-1, 8, 0, 42]


# ---------------------------------------------------- through Loader
def _lanes(out):
    return {k: np.asarray(out[k]) for k in LANES}


@pytest.mark.parametrize("name,n_rules,n_flows", [("http", 12, 200),
                                                  ("kafka", 12, 200),
                                                  ("fqdn", 4, 150)])
def test_decoded_flows_verdict_equal_through_each_loader(tmp_path, name,
                                                         n_rules, n_flows):
    got = {}
    for pkg in PKGS:
        per_identity, sc = pkg.synth.realize_scenario(
            pkg.synth.scenario_by_name(name, n_rules, n_flows))
        path = str(tmp_path / f"{pkg.root}.pb")
        pkg.flowpb.write_pb_capture(path, sc.flows)
        flows = pkg.flowpb.read_pb_capture(path)
        ld = make_loader(pkg, tmp_path / pkg.root)
        try:
            ld.regenerate(per_identity, revision=1)
            out = ld.engine.verdict_flows(flows,
                                          authed_pairs=pkg.unenforced)
        finally:
            ld.close()
        with open(path, "rb") as fp:
            got[pkg.root] = (fp.read(), _lanes(out))
    (jwire, want), (pwire, lanes) = got["cilium_tpu"], got["cilium_tpu_torch"]
    assert pwire == jwire
    for k in LANES:
        np.testing.assert_array_equal(lanes[k], want[k], k)
    assert len(set(lanes["verdict"].tolist())) > 1  # a real mix


def test_unknown_role_matches_only_unconstrained_rules(tmp_path):
    """The reference's ACL case: an unknown-role (-1) record decoded
    from the wire is DROPPED under a produce-scoped rule and
    REDIRECTED under an unconstrained one, alike in both packages."""
    got = {}
    for pkg in PKGS:
        api, F = pkg.api, pkg.flow
        verdicts = []
        for kafka_rule in (api.PortRuleKafka(role="produce", topic="t"),
                           api.PortRuleKafka(topic="t")):
            rules = [api.Rule(
                endpoint_selector=api.EndpointSelector.from_labels(app="k"),
                ingress=(api.IngressRule(to_ports=(api.PortRule(
                    ports=(api.PortProtocol(9092, F.Protocol.TCP),),
                    rules=api.L7Rules(kafka=(kafka_rule,))),)),))]
            alloc = pkg.identity.IdentityAllocator()
            ids = {n: alloc.allocate(pkg.labels.LabelSet.from_dict(
                {"app": n})) for n in ("k", "c")}
            repo = pkg.repository.Repository()
            repo.add(rules, sanitize=False)
            res = pkg.mapstate.PolicyResolver(
                repo, pkg.selectorcache.SelectorCache(alloc))
            per_identity = {i: res.resolve(alloc.lookup(i))
                            for i in ids.values()}
            out = bytearray()
            pkg.flowpb._put_str(out, pkg.flowpb._K_APIKEY, "somefutureapi")
            pkg.flowpb._put_str(out, pkg.flowpb._K_TOPIC, "t")
            flow = F.Flow(src_identity=ids["c"], dst_identity=ids["k"],
                          dport=9092, l7=F.L7Type.KAFKA,
                          kafka=pkg.flowpb._dec_kafka(memoryview(bytes(out))))
            ld = make_loader(pkg, tmp_path / pkg.root)
            try:
                ld.regenerate(per_identity, revision=1)
                verdicts.append(int(ld.engine.verdict_flows(
                    [flow])["verdict"][0]))
            finally:
                ld.close()
        got[pkg.root] = verdicts
    assert got["cilium_tpu_torch"] == got["cilium_tpu"] == [2, 5]
