"""The port's proxylib parsers against the JAX package's, on the CPU.

The same wire bytes go through each package's parser over its own
``PolicyBridge`` and ``Loader`` (the reference gate on,
``JAX_PLATFORMS=cpu``; the port ``device="cpu"``): the ops, the
injected bytes (Kafka broker errors, the HTTP 403, rewritten request
frames) and the LOG access-log records must be equal. Covered: the
parser framework, the frames of the reference's proxylib and flexible
Kafka tests, hypothesis-random splits of the same byte streams, header
rewrites, and the generic-record parsers — r2d2, memcache and cassandra
(protocol frontends: their records verdict on the ``l7g`` field) and the
test parsers (``test.lineparser``/``test.blockparser`` records on the
generic pair path, ``test.passer``) — on the reference's golden wire
corpora (``tests/test_frontends.py``), directly and over the socket.
"""

import base64
import struct

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from test_frontends import GOLDEN_RULES, GOLDEN_WIRE
from test_frontends import PORTS as GEN_PORTS
from test_kafka_flexible import (
    fetch_v12,
    metadata_v9,
    produce_v3,
    produce_v9,
)
from test_torch_service import (
    JAX,
    PKGS,
    PORT,
    make_loader,
    proxy_world,
    strip,
)

#: the generic-record parsers, each on its own port of ``gen``
GEN_PROTO_PORTS = {**GEN_PORTS, "test.lineparser": 4000,
                   "test.blockparser": 4001, "test.passer": 4002}
GEN_RULES = {**GOLDEN_RULES,
             "test.lineparser": [{"line": "allowed"}, {"line": "ok go"}],
             "test.blockparser": [{"prefix": "ok"}],
             "test.passer": []}


def _block(body: bytes) -> bytes:
    """One ``<len>:<body>`` block, ``len`` counting the whole block."""
    n = len(body) + 2
    while len(str(n)) + 1 + len(body) != n:
        n += 1
    return str(n).encode() + b":" + body


#: request-direction wire per parser (the three frontends: the
#: reference's golden corpora)
GEN_WIRE = {**GOLDEN_WIRE,
            "test.lineparser": [b"allowed\n", b"denied\nok go\r\n",
                                b"ok", b" go\n", b"\n"],
            "test.blockparser": [_block(b"ok one"), _block(b"no two"),
                                 _block(b"ok")[:3], _block(b"ok")[3:],
                                 b"x:bad", _block(b"")],
            "test.passer": [b"anything", b"at all"]}


def generic_world(pkg):
    """``gen`` admits each generic-record parser's rules on its port,
    from ``cli``."""
    api, flow = pkg.api, pkg.flow
    sel = api.EndpointSelector.from_labels
    rules = [api.Rule(endpoint_selector=sel(app="gen"),
                      ingress=(api.IngressRule(to_ports=tuple(
                          api.PortRule(
                              ports=(api.PortProtocol(port,
                                                      flow.Protocol.TCP),),
                              rules=api.L7Rules(l7proto=proto, l7=tuple(
                                  api.PortRuleL7.from_dict(r)
                                  for r in GEN_RULES[proto])))
                          for proto, port in GEN_PROTO_PORTS.items())),))]
    alloc = pkg.identity.IdentityAllocator()
    ids = {n: alloc.allocate(pkg.labels.LabelSet.from_dict({"app": n}))
           for n in ("gen", "cli")}
    repo = pkg.repository.Repository()
    repo.add(rules, sanitize=False)
    res = pkg.mapstate.PolicyResolver(
        repo, pkg.selectorcache.SelectorCache(alloc))
    return {i: res.resolve(alloc.lookup(i)) for i in ids.values()}, ids


def _plain_record(r):
    """A parsed record as comparable data (the two packages' classes
    differ)."""
    return (type(r).__name__, tuple(sorted(vars(r).items())))


def _conn(pkg, proto, ids, dst, dport):
    return pkg.proxylib.Connection(
        proto=proto, connection_id=1, ingress=True,
        src_identity=ids["cli"], dst_identity=ids[dst], dport=dport)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """pkg root → {"rewrite" | "log" | "generic": (bridge loader,
    ids)}."""
    out = {}
    for pkg in PKGS:
        out[pkg.root] = {}
        for kind in ("rewrite", "log", "generic"):
            per, ids = (generic_world(pkg) if kind == "generic" else
                        proxy_world(pkg, log_action=kind == "log"))
            ld = make_loader(pkg, tmp_path_factory.mktemp(pkg.root))
            ld.regenerate(per, revision=1)
            out[pkg.root][kind] = (ld, ids)
    yield out
    for by_kind in out.values():
        for ld, _ in by_kind.values():
            ld.close()


def _drive(pkg, loader, ids, proto, chunks, accesslog=None):
    """Feed ``chunks`` to a fresh parser over a real bridge → (ops per
    chunk, client-bound and upstream-bound injects per chunk)."""
    bridge = pkg.service.PolicyBridge(loader, deadline_ms=1.0,
                                      accesslog_fn=accesslog)
    try:
        dst, dport = (("kafka", 9092) if proto == "kafka" else
                      ("web", 80) if proto == "http" else
                      ("gen", GEN_PROTO_PORTS[proto]))
        conn = _conn(pkg, proto, ids, dst, dport)
        parser = pkg.proxylib.create_parser(proto, conn,
                                            bridge.policy_check(conn))
        out = []
        for reply, data in chunks:
            ops = parser.on_data(reply, False, data)
            out.append(([(int(o), int(n)) for o, n in ops],
                        conn.take_inject(reply=True),
                        conn.take_inject(reply=False)))
        return out
    finally:
        bridge.batcher.close()


def _both(worlds, kind, proto, chunks):
    got = {}
    for pkg in PKGS:
        ld, ids = worlds[pkg.root][kind]
        got[pkg.root] = _drive(pkg, ld, ids, proto, chunks)
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    return got["cilium_tpu_torch"]


# ============================================================ framework
def test_parser_framework():
    P = PORT.proxylib
    assert P.registered_parsers() == JAX.proxylib.registered_parsers()
    assert set(P.registered_parsers()) == set(GEN_PROTO_PORTS) | {
        "http", "kafka"}
    assert [int(o) for o in P.OpType] == [int(o) for o in
                                          JAX.proxylib.OpType]
    assert [int(v) for v in P.ParserVerdict] == [
        int(v) for v in JAX.proxylib.ParserVerdict]
    conn = P.Connection(proto="http", connection_id=1, ingress=True,
                        src_identity=1, dst_identity=2)
    with pytest.raises(KeyError, match="no parser registered"):
        P.create_parser("nope", conn, lambda r: True)
    # injects drain per direction, in order
    assert conn.inject(b"a") == (P.OpType.INJECT, 1)
    conn.inject(b"up", reply=False)
    conn.inject(b"b")
    assert conn.take_inject(reply=False) == b"up"
    assert conn.take_inject() == b"ab" and conn.take_inject() == b""


@pytest.mark.parametrize("name", ["r2d2", "memcache", "cassandra",
                                  "test.passer", "test.lineparser",
                                  "test.blockparser"])
def test_generic_parsers_are_refused_naming_q5(worlds, name):
    """The generic-record parsers, registered in both packages: their
    records (a recording policy check) and, over each package's own
    loader and ``PolicyBridge``, their ops and injects equal the
    reference's on the golden wire, every chunk split in two so MORE
    accounting rides along."""
    assert name in PORT.proxylib.registered_parsers()
    records = {}
    for pkg in PKGS:
        conn = pkg.proxylib.Connection(proto=name, connection_id=1,
                                       ingress=True, src_identity=1,
                                       dst_identity=2)
        seen = []
        pkg.proxylib.create_parser(name, conn,
                                   lambda r: seen.append(r) or True)
        for chunk in GEN_WIRE[name]:
            conn.on_data(False, False, chunk)
        records[pkg.root] = [_plain_record(r) for r in seen]
    assert records["cilium_tpu_torch"] == records["cilium_tpu"]
    assert bool(records["cilium_tpu"]) == (name != "test.passer")
    chunks = []
    for chunk in GEN_WIRE[name]:
        mid = max(1, len(chunk) // 2)
        chunks += [(False, chunk[:mid]), (False, chunk[mid:])]
    out = _both(worlds, "generic", name, chunks + [(True, b"reply")])
    ops = [o for step, _, _ in out for o, _ in step]
    if name != "test.passer":
        assert 1 in ops and 2 in ops, ops


def test_service_answers_q5_for_a_generic_parser(worlds, tmp_path):
    """``on_new_connection`` and ``on_data`` over each package's socket
    for r2d2, memcache and cassandra: the responses (ops, injects)
    equal the reference's."""
    from test_torch_service import client, served

    got = {}
    for pkg in PKGS:
        ld, ids = worlds[pkg.root]["generic"]
        resps = []
        with served(pkg, ld, tmp_path / f"{pkg.root}.sock",
                    deadline_ms=1.0) as svc, client(pkg, svc) as c:
            for k, proto in enumerate(("r2d2", "memcache", "cassandra")):
                resps.append(strip(c.call({
                    "op": "on_new_connection", "proto": proto,
                    "conn": 10 + k, "ingress": True, "src": ids["cli"],
                    "dst": ids["gen"],
                    "dport": GEN_PROTO_PORTS[proto]})))
                for chunk in GEN_WIRE[proto]:
                    resps.append(strip(c.call({
                        "op": "on_data", "conn": 10 + k, "reply": False,
                        "end": False,
                        "data_b64": base64.b64encode(chunk).decode()})))
        got[pkg.root] = resps
    assert got["cilium_tpu_torch"] == got["cilium_tpu"]
    ops = [o for r in got["cilium_tpu"] for o, _ in r.get("ops", ())]
    assert 1 in ops and 2 in ops
    assert any("inject_b64" in r for r in got["cilium_tpu"])


# ======================================================= fixed frames
def test_kafka_frames_equal_the_reference(worlds):
    """The reference's ``test_kafka_parser_frames``: PASS, a denied
    produce's broker error + DROP, a denied fetch, a split frame."""
    enc = PORT.kafka.encode_request
    assert enc(0, 1, 7, "cli-1", "allowed-topic") == \
        JAX.kafka.encode_request(0, 1, 7, "cli-1", "allowed-topic")
    good = enc(0, 1, 7, "cli-1", "allowed-topic")
    bad = enc(0, 1, 8, "cli-1", "secret-topic")
    fetch = enc(1, 2, 9, "cli-1", "allowed-topic")
    meta = enc(3, 0, 10, "cli-1", ["a", "b"])
    out = _both(worlds, "rewrite", "kafka",
                [(False, good + bad), (False, fetch), (False, meta),
                 (False, good[:5]), (False, good[5:]),
                 (True, b"broker-response"), (False, b"\x00\x00")])
    (ops, err, _), (fops, ferr, _) = out[0], out[1]
    assert ops == [(1, len(good)), (3, len(err)), (2, len(bad))]
    size, corr = struct.unpack_from(">ii", err, 0)
    assert (size, corr) == (len(err) - 4, 8)
    assert fops[-1] == (2, len(fetch)) and ferr
    assert out[3][0][0][0] == 0 and out[4][0] == [(1, len(good))]
    assert out[5][0] == [(1, 15)]


def test_http_frames_equal_the_reference(worlds):
    """The reference's ``test_http_parser_frames`` and its pipelined
    rewrite-and-deny case: rewritten frames ride the upstream inject,
    the 403 the client-bound one."""
    good = b"GET /ok/x HTTP/1.1\r\nhost: web\r\n\r\n"
    bad = (b"POST /ok/x HTTP/1.1\r\nhost: web\r\ncontent-length: 2"
           b"\r\n\r\nhi")
    rewrite = (b"GET /ok/x HTTP/1.1\r\nhost: web\r\nX-Rep: old\r\n"
               b"X-Del: bad\r\ncontent-length: 2\r\n\r\nhi")
    satisfied = (b"GET /ok/y HTTP/1.1\r\nhost: web\r\nX-Add: v1\r\n"
                 b"X-Rep: v2\r\nX-Del: good\r\n\r\n")
    denied = b"POST /nope HTTP/1.1\r\nhost: web\r\n\r\n"
    garbage = b"\r\n\r\n"
    out = _both(worlds, "rewrite", "http",
                [(False, good), (False, bad), (False, rewrite),
                 (False, satisfied), (False, rewrite + denied),
                 (False, bad[:10]), (False, bad[10:]), (True, b"HTTP/1.1"),
                 (False, garbage)])
    assert out[1][0][0] == (2, len(bad)) and out[1][1].startswith(
        b"HTTP/1.1 403")
    ops, client_inj, up = out[2]
    assert ops[0] == (2, len(rewrite)) and ops[1][0] == 3
    head, body = up.split(b"\r\n\r\n", 1)
    assert body == b"hi" and b"X-Rep: v2" in head and b"X-Del" not in head
    assert client_inj == b""
    assert out[3][0] == [(1, len(satisfied))]
    assert [o for o, _ in out[4][0]] == [2, 3, 2, 3]
    assert out[4][2].startswith(b"GET /ok/x") and \
        out[4][1].startswith(b"HTTP/1.1 403")


def test_log_action_emits_the_same_accesslog(worlds):
    """A LOG-action mismatch on an allowed request reaches the
    bridge's access-log sink with its verdict; a satisfied match does
    not."""
    frames = [(False, b"GET /ok/x HTTP/1.1\r\nhost: w\r\n\r\n"),
              (False, b"GET /ok/y HTTP/1.1\r\nX-Trace: on\r\n\r\n"),
              (False, b"GET /no HTTP/1.1\r\nhost: w\r\n\r\n")]
    logs = {}
    for pkg in PKGS:
        ld, ids = worlds[pkg.root]["log"]
        seen = []
        ops = _drive(pkg, ld, ids, "http", frames, accesslog=seen.append)
        logs[pkg.root] = (ops, [(f.http.path, int(f.verdict), int(f.l7))
                                for f in seen])
    assert logs["cilium_tpu_torch"] == logs["cilium_tpu"]
    ops, logged = logs["cilium_tpu_torch"]
    assert [o[0][0][0] for o in ops] == [1, 1, 2]
    assert logged == [("/ok/x", 5, int(PORT.flow.L7Type.HTTP))]


# =========================================== flexible (KIP-482) frames
FLEX = [produce_v9, fetch_v12, produce_v3]


@pytest.mark.parametrize("make", FLEX + [metadata_v9],
                         ids=lambda f: f.__name__)
def test_kafka_flexible_records_equal_the_reference(make):
    frames = ([make()] if make is metadata_v9
              else [make("orders"), make("allowed-topic")])
    if make is produce_v9:
        frames.append(make("a", "b", "c"))
    for fr in frames:
        for cut in (fr, fr[:20] + b"\xff" * (len(fr) - 20)):
            want = JAX.kafka.parse_request_records(cut[4:])
            got = PORT.kafka.parse_request_records(cut[4:])
            assert [_plain_record(r) for r in got] == \
                [_plain_record(r) for r in want]


def test_kafka_flexible_frames_enforce_like_the_reference(worlds):
    chunks = []
    for make in FLEX:
        chunks += [(False, make("allowed-topic")),
                   (False, make("secret-topic"))]
    fetch_v13 = bytearray(fetch_v12("allowed-topic"))
    struct.pack_into(">h", fetch_v13, 6, 13)
    chunks += [(False, metadata_v9()), (False, bytes(fetch_v13)),
               (False, b"".join(c for _, c in chunks[:4]))]
    out = _both(worlds, "rewrite", "kafka", chunks)
    assert out[0][0] == [(1, len(chunks[0][1]))]
    assert out[1][0][-1] == (2, len(chunks[1][1])) and out[1][1] == b""


# ============================================ random splits (hypothesis)
def _stream(proto):
    enc = PORT.kafka.encode_request
    if proto == "kafka":
        parts = [enc(0, 1, 1, "c", "allowed-topic"),
                 enc(0, 1, 2, "c", "secret-topic"),
                 produce_v9("allowed-topic"), fetch_v12("secret-topic"),
                 enc(1, 0, 3, "c", "allowed-topic"),
                 produce_v3("allowed-topic"), metadata_v9(),
                 enc(3, 0, 4, "c", ["x", "allowed-topic"])]
    else:
        parts = [b"GET /ok/a HTTP/1.1\r\nhost: web\r\nX-Rep: old\r\n\r\n",
                 b"POST /ok/b HTTP/1.1\r\ncontent-length: 3\r\n\r\nabc",
                 b"GET /ok/c HTTP/1.1\r\nX-Add: v1\r\nX-Rep: v2\r\n"
                 b"X-Del: good\r\n\r\n",
                 b"GET /nope HTTP/1.1\r\nhost: w\r\n\r\n",
                 b"GET /ok/d HTTP/1.1\r\ncontent-length: -4\r\n\r\n"]
    return b"".join(parts)


STREAMS = {p: _stream(p) for p in ("kafka", "http")}


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(proto=st.sampled_from(["kafka", "http"]),
       cuts=st.lists(st.floats(0.0, 1.0), max_size=8))
def test_random_splits_equal_the_reference(worlds, proto, cuts):
    data = STREAMS[proto]
    points = sorted({int(c * len(data)) for c in cuts} | {0, len(data)})
    chunks = [(False, data[a:b]) for a, b in zip(points, points[1:])]
    out = _both(worlds, "rewrite", proto, chunks)
    # however the stream is cut, every byte is decided exactly once
    decided = sum(n for ops, _, _ in out for o, n in ops if o in (1, 2))
    assert decided == len(data)
