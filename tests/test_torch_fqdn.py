"""The port's toFQDNs runtime against the JAX package's, on the CPU.

* counterparts of the reference's ``tests/test_fqdn.py`` (the DNS cache's
  TTL and restore, the NameManager feeding the SelectorCache, its GC,
  the proxy's ``check_allowed`` and ``check_batch``) and
  ``tests/test_dns_wire.py`` (the codec, and the ``DNSProxyServer`` over
  fake UDP and TCP upstreams: forwarding, REFUSED for denied names and
  unknown clients, the txid check, SERVFAIL on a timeout, pipelined
  TCP), each run on the port;
* the wire codec byte-identical to the reference's, and ``cidr_labels``,
  ``IPCache`` (LPM lookup, listeners, ``dump``) and the DNS cache's
  answers equal;
* ``check_batch`` with ``use_tpu=True`` (the banked DFA, here on
  ``device="cpu"``: the plain versions) equal to the reference's (its
  banked DFA on the CPU) on the fqdn scenario's 100-name universe under
  its rules, under both DFA arms, and on hypothesis qnames (upper case,
  trailing dots, non-ASCII, past 256 bytes);
* what the port adds: ``use_tpu`` on and ``device`` ``cuda`` by default
  (raising without it), the counted degrade to the regex set on the
  ``dnsproxy.query`` fault, ``NotImplementedError`` and kernel failures
  passing a CPU proxy's degrade, every device error passing a ``cuda``
  proxy's, and the check-and-install that keeps a concurrent
  ``update_allowed`` from installing a stale automaton.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cilium_tpu import ipcache as jax_ipcache
from cilium_tpu.core.identity import IdentityAllocator as JaxAllocator
from cilium_tpu.fqdn import DNSCache as JaxDNSCache
from cilium_tpu.fqdn import DNSProxy as JaxDNSProxy
from cilium_tpu.fqdn import wire as jax_wire
from cilium_tpu.ingest import synth as jax_synth
from cilium_tpu.policy.api.l7 import PortRuleDNS as JaxPortRuleDNS

from cilium_tpu_torch import ipcache
from cilium_tpu_torch.core.identity import IdentityAllocator
from cilium_tpu_torch.fqdn import DNSCache, DNSProxy, NameManager, wire
from cilium_tpu_torch.fqdn.dnsproxy import QUERY_POINT
from cilium_tpu_torch.fqdn.server import DNSProxyServer
from cilium_tpu_torch.ingest import synth
from cilium_tpu_torch.ipcache import IPCache
from cilium_tpu_torch.policy.api.l7 import PortRuleDNS
from cilium_tpu_torch.policy.api.selector import FQDNSelector
from cilium_tpu_torch.policy.selectorcache import SelectorCache
from cilium_tpu_torch.runtime import faults
from cilium_tpu_torch.runtime.metrics import DNSPROXY_FALLBACKS, METRICS


def _proxy(**kw):
    return DNSProxy(use_tpu=True, device="cpu", **kw)


# ------------------------------------------- counterparts of test_fqdn.py
def test_dns_cache_ttl_and_restore():
    c = DNSCache(min_ttl=10)
    c.update(100.0, "www.example.com", ["1.2.3.4"], ttl=30)
    c.update(100.0, "www.example.com", ["1.2.3.5"], ttl=5)  # clamped to 10
    assert c.lookup("www.example.com", now=105.0) == ["1.2.3.4", "1.2.3.5"]
    assert c.lookup("WWW.example.com.", now=115.0) == ["1.2.3.4"]
    affected = c.expire(now=131.0)
    assert "www.example.com." in affected
    assert c.lookup("www.example.com", now=131.0) == []
    c2 = DNSCache.from_json(c.to_json())
    assert c2.names() == c.names()


def test_name_manager_feeds_selector_cache():
    alloc = IdentityAllocator()
    cache = SelectorCache(alloc)
    ipc = IPCache(alloc, cache)
    nm = NameManager(cache, ipc)
    sel = FQDNSelector(match_pattern="*.cilium.io")
    nm.register_selector(sel)
    updated = []
    nm.on_update = lambda sels: updated.append(sels)

    assert nm.update_generate_dns(1000.0, "www.cilium.io",
                                  ["10.0.0.1", "10.0.0.2"], ttl=300)
    ids = cache.get_selections(sel)
    assert len(ids) == 2
    assert all(i >= (1 << 24) for i in ids)  # local CIDR scope
    assert ipc.lookup("10.0.0.1") in ids
    assert updated
    assert not nm.update_generate_dns(1000.0, "evil.com", ["6.6.6.6"],
                                      ttl=300)
    assert not nm.update_generate_dns(1000.0, "a.b.cilium.io", ["7.7.7.7"],
                                      ttl=300)


def test_name_manager_gc_removes_selections():
    alloc = IdentityAllocator()
    cache = SelectorCache(alloc)
    ipc = IPCache(alloc, cache)
    nm = NameManager(cache, ipc, DNSCache(min_ttl=1))
    sel = FQDNSelector(match_name="api.example.com")
    nm.register_selector(sel)
    nm.update_generate_dns(100.0, "api.example.com", ["9.9.9.9"], ttl=10)
    assert len(cache.get_selections(sel)) == 1
    nm.gc(now=200.0)
    assert len(cache.get_selections(sel)) == 0
    # an unregistered selector is never resurrected by a resync
    nm.unregister_selector(sel)
    nm.update_generate_dns(300.0, "api.example.com", ["9.9.9.9"], ttl=10)
    assert nm.registered_selectors() == []


def test_dns_proxy_check_allowed_and_batch():
    proxy = DNSProxy(use_tpu=False)
    rules = [PortRuleDNS(match_pattern="*.cilium.io"),
             PortRuleDNS(match_name="example.com")]
    proxy.update_allowed(42, 53, rules)
    assert proxy.check_allowed(42, 53, "www.cilium.io")
    assert proxy.check_allowed(42, 53, "EXAMPLE.COM.")
    assert not proxy.check_allowed(42, 53, "evil.com")
    assert not proxy.check_allowed(42, 53, "a.b.cilium.io")
    assert not proxy.check_allowed(7, 53, "www.cilium.io")
    qnames = ["www.cilium.io", "evil.com", "example.com", "x.example.com"]
    want = np.array([True, False, True, False])
    np.testing.assert_array_equal(proxy.check_batch(42, 53, qnames), want)
    on = _proxy()
    on.update_allowed(42, 53, rules)
    np.testing.assert_array_equal(on.check_batch(42, 53, qnames), want)
    assert on.check_batch(42, 53, []).shape == (0,)
    assert not on.check_batch(9, 53, qnames).any()
    proxy.update_allowed(42, 53, [])
    assert not proxy.check_allowed(42, 53, "www.cilium.io")


# -------------------------------------- counterparts of test_dns_wire.py
def test_query_roundtrip():
    q = wire.encode_query(0x1234, "www.example.com")
    msg = wire.decode(q)
    assert msg.txid == 0x1234 and not msg.is_response
    assert msg.qname == "www.example.com"
    assert msg.questions[0].qtype == wire.QTYPE_A


def test_response_with_answers_roundtrip():
    q = wire.encode_query(7, "a.io")
    resp = wire.encode_response(q, wire.RCODE_NOERROR, answers=[
        ("a.io", wire.QTYPE_A, 300, bytes([10, 1, 2, 3])),
        ("a.io", wire.QTYPE_A, 60, bytes([10, 1, 2, 4])),
    ])
    msg = wire.decode(resp)
    assert msg.is_response and msg.rcode == wire.RCODE_NOERROR
    assert msg.txid == 7 and msg.qname == "a.io"
    assert [a.ip for a in msg.answers] == ["10.1.2.3", "10.1.2.4"]
    assert [a.ttl for a in msg.answers] == [300, 60]


def test_compression_pointer_decode():
    hdr = struct.pack("!6H", 1, 0x8180, 1, 1, 0, 0)
    question = wire.encode_name("www.example.com") + struct.pack("!HH", 1, 1)
    answer = bytes([0xC0, 12]) + struct.pack("!HHIH", 1, 1, 60, 4) + \
        bytes([1, 2, 3, 4])
    msg = wire.decode(hdr + question + answer)
    assert msg.answers[0].name == "www.example.com"
    assert msg.answers[0].ip == "1.2.3.4"


def test_decode_rejects_malformed():
    with pytest.raises(wire.DNSDecodeError):
        wire.decode(b"\x00" * 5)
    hdr = struct.pack("!6H", 1, 0, 1, 0, 0, 0)
    with pytest.raises(wire.DNSDecodeError):
        wire.decode(hdr + bytes([0xC0, 12]) + b"\x00\x01\x00\x01")
    with pytest.raises(wire.DNSDecodeError):
        wire.decode(struct.pack("!6H", 1, 0, 1, 0, 0, 0) + bytes([63]))


class FakeUpstream:
    """In-process UDP resolver answering every A query with fixed IPs."""

    def __init__(self, ips=("192.0.2.10",), ttl=120, rcode=0, forge=False):
        self.ips, self.ttl, self.rcode, self.forge = list(ips), ttl, rcode, \
            forge
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.5)
        self.address = self.sock.getsockname()
        self.queries = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                data, client = self.sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                return
            msg = wire.decode(data)
            self.queries.append(msg.qname)
            answers = [(msg.qname, wire.QTYPE_A, self.ttl,
                        socket.inet_aton(ip)) for ip in self.ips] \
                if self.rcode == 0 else []
            resp = bytearray(wire.encode_response(data, self.rcode, answers))
            if self.forge:      # an off-path forgery: the wrong txid
                struct.pack_into("!H", resp, 0, (msg.txid + 1) & 0xFFFF)
            self.sock.sendto(bytes(resp), client)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
        self.sock.close()


class FakeTCPUpstream:
    """In-process TCP resolver (RFC 7766 framing), fixed A answers."""

    def __init__(self, ips=("192.0.2.10",), ttl=120):
        self.ips, self.ttl = list(ips), ttl
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.sock.settimeout(0.5)
        self.address = self.sock.getsockname()
        self.queries = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                conn.settimeout(2.0)
                while True:
                    try:
                        hdr = DNSProxyServer._recvn(conn, 2)
                        if hdr is None:
                            break
                        data = DNSProxyServer._recvn(
                            conn, int.from_bytes(hdr, "big"))
                    except (socket.timeout, OSError):
                        break
                    msg = wire.decode(data)
                    self.queries.append(msg.qname)
                    resp = wire.encode_response(data, 0, [
                        (msg.qname, wire.QTYPE_A, self.ttl,
                         socket.inet_aton(ip)) for ip in self.ips])
                    conn.sendall(len(resp).to_bytes(2, "big") + resp)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
        self.sock.close()


def _ask(addr, qname, txid=42, timeout=3.0, query=None):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    try:
        s.sendto(query or wire.encode_query(txid, qname), addr)
        data, _ = s.recvfrom(4096)
    finally:
        s.close()
    return wire.decode(data)


def _ask_tcp(addr, qnames, txid=42, timeout=3.0):
    out = []
    with socket.create_connection(addr, timeout=timeout) as s:
        for i, qname in enumerate(qnames):
            q = wire.encode_query(txid + i, qname)
            s.sendall(len(q).to_bytes(2, "big") + q)
            hdr = DNSProxyServer._recvn(s, 2)
            assert hdr is not None, "proxy closed mid-exchange"
            out.append(wire.decode(DNSProxyServer._recvn(
                s, int.from_bytes(hdr, "big"))))
    return out


@pytest.fixture
def proxy_stack():
    upstream = FakeUpstream()
    cache = DNSCache()
    proxy = DNSProxy(name_manager=NameManager(None, None, cache),
                     use_tpu=False)
    proxy.update_allowed(7, 53, [PortRuleDNS(match_pattern="*.allowed.io")])
    verdicts = []
    server = DNSProxyServer(
        proxy, endpoint_of=lambda ip: 7 if ip == "127.0.0.1" else None,
        upstream=upstream.address,
        on_verdict=lambda *a: verdicts.append(a)).start()
    yield upstream, cache, server, verdicts
    server.stop()
    upstream.close()


def test_non_ascii_qname_denied_not_crashed(proxy_stack):
    upstream, _, server, _ = proxy_stack
    hdr = struct.pack("!6H", 9, 0x0100, 1, 0, 0, 0)
    name = bytes([4, 0xC3, 0xA9, 0x76, 0x6C]) + wire.encode_name(
        "example.com")
    msg = _ask(server.address, "", query=hdr + name + struct.pack("!HH", 1,
                                                                  1))
    assert msg.rcode == wire.RCODE_REFUSED and msg.txid == 9
    assert upstream.queries == []


def test_allowed_query_forwarded_and_observed(proxy_stack):
    upstream, cache, server, verdicts = proxy_stack
    msg = _ask(server.address, "api.allowed.io")
    assert msg.rcode == wire.RCODE_NOERROR and msg.txid == 42
    assert [a.ip for a in msg.answers] == ["192.0.2.10"]
    assert upstream.queries == ["api.allowed.io"]
    assert cache.lookup("api.allowed.io") == ["192.0.2.10"]
    assert verdicts == [("api.allowed.io", 7, True, 0)]


def test_denied_query_refused_without_upstream(proxy_stack):
    upstream, cache, server, verdicts = proxy_stack
    msg = _ask(server.address, "evil.example.com")
    assert msg.rcode == wire.RCODE_REFUSED and msg.answers == []
    assert upstream.queries == []
    assert cache.lookup("evil.example.com") == []
    assert verdicts == [("evil.example.com", 7, False, wire.RCODE_REFUSED)]


def test_unknown_client_refused():
    upstream = FakeUpstream()
    server = DNSProxyServer(DNSProxy(use_tpu=False),
                            endpoint_of=lambda ip: None,
                            upstream=upstream.address).start()
    try:
        assert _ask(server.address, "x.io").rcode == wire.RCODE_REFUSED
    finally:
        server.stop()
        upstream.close()


def test_forged_txid_never_relayed_or_observed():
    upstream = FakeUpstream(ips=("6.6.6.6",), forge=True)
    cache = DNSCache()
    proxy = DNSProxy(name_manager=NameManager(None, None, cache),
                     use_tpu=False)
    proxy.update_allowed(7, 53, [PortRuleDNS(match_pattern="*")])
    server = DNSProxyServer(proxy, endpoint_of=lambda ip: 7,
                            upstream=upstream.address, timeout=0.4).start()
    try:
        msg = _ask(server.address, "www.bank.com", timeout=5.0)
        assert msg.rcode == wire.RCODE_SERVFAIL
        assert cache.lookup("www.bank.com") == []
    finally:
        server.stop()
        upstream.close()


def test_upstream_timeout_is_servfail():
    dead = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    dead.bind(("127.0.0.1", 0))
    proxy = DNSProxy(use_tpu=False)
    proxy.update_allowed(7, 53, [PortRuleDNS(match_pattern="*")])
    server = DNSProxyServer(proxy, endpoint_of=lambda ip: 7,
                            upstream=dead.getsockname(), timeout=0.3).start()
    try:
        assert _ask(server.address, "slow.io",
                    timeout=5.0).rcode == wire.RCODE_SERVFAIL
    finally:
        server.stop()
        dead.close()


def test_tcp_allowed_query_forwards_and_caches():
    upstream = FakeTCPUpstream(ips=("192.0.2.55",), ttl=90)
    cache = DNSCache()
    proxy = DNSProxy(name_manager=NameManager(None, None, cache),
                     use_tpu=False)
    proxy.update_allowed(7, 53, [PortRuleDNS(match_pattern="*.allowed.io")])
    server = DNSProxyServer(proxy, endpoint_of=lambda ip: 7,
                            upstream=upstream.address).start()
    try:
        (msg,) = _ask_tcp(server.address, ["api.allowed.io"])
        assert msg.rcode == wire.RCODE_NOERROR
        assert [a.ip for a in msg.answers] == ["192.0.2.55"]
        assert cache.lookup("api.allowed.io") == ["192.0.2.55"]
        (msg,) = _ask_tcp(server.address, ["evil.other.io"])
        assert msg.rcode == wire.RCODE_REFUSED
        assert upstream.queries == ["api.allowed.io"]
    finally:
        server.stop()
        upstream.close()


def test_tcp_pipelined_queries_one_connection():
    upstream = FakeTCPUpstream()
    proxy = DNSProxy(use_tpu=False)
    proxy.update_allowed(7, 53, [PortRuleDNS(match_pattern="*")])
    server = DNSProxyServer(proxy, endpoint_of=lambda ip: 7,
                            upstream=upstream.address).start()
    try:
        msgs = _ask_tcp(server.address, ["a.x.io", "b.x.io", "c.x.io"])
        assert [m.rcode for m in msgs] == [0, 0, 0]
        assert upstream.queries == ["a.x.io", "b.x.io", "c.x.io"]
    finally:
        server.stop()
        upstream.close()


def test_server_counts_queries_and_survives_a_raising_hook():
    upstream = FakeUpstream()
    proxy = DNSProxy(use_tpu=False)
    proxy.update_allowed(7, 53, [PortRuleDNS(match_pattern="*.ok.io")])

    def endpoint_of(ip):
        raise RuntimeError("hook failed")

    errors0 = METRICS.get("cilium_tpu_fqdn_handler_errors_total")
    server = DNSProxyServer(proxy, endpoint_of=endpoint_of,
                            upstream=upstream.address).start()
    try:
        with pytest.raises(socket.timeout):
            _ask(server.address, "a.ok.io", timeout=0.5)
        server.endpoint_of = lambda ip: 7
        allow0 = METRICS.get("cilium_tpu_fqdn_queries_total",
                             {"verdict": "allow"})
        assert _ask(server.address, "a.ok.io").rcode == wire.RCODE_NOERROR
        assert METRICS.get("cilium_tpu_fqdn_queries_total",
                           {"verdict": "allow"}) == allow0 + 1
    finally:
        server.stop()
        upstream.close()
    assert METRICS.get("cilium_tpu_fqdn_handler_errors_total") == errors0 + 1


# ---------------------------------------- equal to the reference's code
@pytest.mark.parametrize("qname,qtype", [
    ("www.example.com", 1), ("a.io.", 28), ("x", 5), ("", 1),
    ("-.b_c.d-e", 1)])
def test_wire_encode_is_byte_identical(qname, qtype):
    q = wire.encode_query(513, qname, qtype)
    assert q == jax_wire.encode_query(513, qname, qtype)
    answers = [(qname or "r", wire.QTYPE_A, 30, bytes([10, 0, 0, 1])),
               (qname or "r", wire.QTYPE_AAAA, 5, bytes(range(16)))]
    for rcode in (0, 2, 3, 5):
        got = wire.encode_response(q, rcode, answers)
        assert got == jax_wire.encode_response(q, rcode, answers)
        a, b = wire.decode(got), jax_wire.decode(got)
        assert (a.txid, a.flags, a.qname, [x.ip for x in a.answers]) == \
            (b.txid, b.flags, b.qname, [x.ip for x in b.answers])
    with pytest.raises(wire.DNSDecodeError):
        wire.encode_name("é.io")


def test_cidr_labels_and_ipcache_equal_the_reference():
    for prefix in ("10.0.0.0/8", "10.1.2.3/32", "2001:db8::/32", "0.0.0.0/0"):
        assert ipcache.cidr_labels(prefix).format() == \
            jax_ipcache.cidr_labels(prefix).format()
    out = {}
    for mod, alloc in ((ipcache, IdentityAllocator()),
                       (jax_ipcache, JaxAllocator())):
        seen = []
        c = mod.IPCache(alloc)
        c.subscribe(lambda p, nid, up, seen=seen: seen.append((p, int(nid),
                                                               up)))
        a = c.upsert("10.0.0.0/8")
        b = c.upsert("10.1.0.0/16")
        c.upsert("10.1.2.3")
        assert c.upsert("10.0.0.0/8") == a           # unchanged: no event
        c.upsert("192.0.2.0/24", identity=77)
        c.upsert("192.0.2.0/24", identity=78)        # remap
        look = [c.lookup(ip) for ip in ("10.9.9.9", "10.1.9.9", "10.1.2.3",
                                        "192.0.2.1", "11.0.0.1")]
        c.delete("10.1.0.0/16")
        c.delete("10.1.0.0/16")                      # absent: no event
        out[mod.__name__] = (seen, look, c.lookup("10.1.9.9"), c.dump(),
                             len(c))
        assert look[0] == a and look[1] == b and look[4] is None
    assert out["cilium_tpu_torch.ipcache"] == out["cilium_tpu.ipcache"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ipcache_lookup_equals_the_reference_under_churn(seed):
    """The port probes one prefix length at a time; the reference scans
    every entry. Nested and overlapping IPv4 and IPv6 prefixes, remaps
    and deletes (a length emptied and filled again) give the same
    longest-prefix answers."""
    rng = np.random.default_rng(seed)

    def prefix():
        if rng.random() < 0.3:
            return f"2001:db8:{rng.integers(0, 4):x}::/{rng.integers(32, 129)}"
        return (f"10.{rng.integers(0, 3)}.{rng.integers(0, 3)}."
                f"{rng.integers(0, 4)}/{rng.integers(0, 33)}")

    ops = [(rng.choice(["up", "up", "del"]), prefix(),
            int(rng.integers(100, 110))) for _ in range(300)]
    ips = ([f"10.{a}.{b}.{c}" for a in range(3) for b in range(3)
            for c in range(5)] + ["11.0.0.1", "2001:db8::1",
                                  "2001:db8:3::ffff", "2001:db9::1"])
    out = {}
    for mod in (ipcache, jax_ipcache):
        c = mod.IPCache(IdentityAllocator() if mod is ipcache
                        else JaxAllocator())
        looks = []
        for op, p, nid in ops:
            if op == "up":
                c.upsert(p, identity=nid)
            else:
                c.delete(p)
            looks.append([None if (x := c.lookup(ip)) is None else int(x)
                          for ip in ips])
        out[mod.__name__] = (looks, c.dump())
    assert out["cilium_tpu_torch.ipcache"] == out["cilium_tpu.ipcache"]
    assert any(v is not None for v in out["cilium_tpu.ipcache"][0][-1])


def test_dns_cache_equals_the_reference():
    got, want = DNSCache(min_ttl=5), JaxDNSCache(min_ttl=5)
    for c in (got, want):
        c.update(10.0, "A.example.com.", ["1.1.1.1", "2.2.2.2"], ttl=1)
        c.update(12.0, "a.example.com", ["2.2.2.2", "3.3.3.3"], ttl=30)
        c.update(12.0, "b.example.com", ["4.4.4.4"], ttl=2)
    import re

    rx = re.compile(r"^[a-z]\.example\.com\.$")
    for now in (11.0, 16.0, 20.0):
        assert got.lookup("a.example.com", now=now) == \
            want.lookup("a.example.com", now=now)
        assert got.lookup_by_regex(rx, now=now) == \
            want.lookup_by_regex(rx, now=now)
    assert got.expire(now=16.0) == want.expire(now=16.0)
    assert got.to_json() == want.to_json() and got.names() == want.names()


@pytest.fixture(scope="module")
def fqdn_universe():
    """The fqdn scenario (10 rules × 100 names) in both packages."""
    port = synth.scenario_by_name("fqdn", 10, 100)
    ref = jax_synth.scenario_by_name("fqdn", 10, 100)
    rules = [d for r in port.rules for er in r.egress for pr in er.to_ports
             for d in pr.rules.dns]
    jrules = [d for r in ref.rules for er in r.egress for pr in er.to_ports
              for d in pr.rules.dns]
    names = [f.dns.query for f in port.flows]
    assert names == [f.dns.query for f in ref.flows]
    return rules, jrules, names


def _both(rules, jrules):
    port, ref = _proxy(), JaxDNSProxy(use_tpu=True)
    port.update_allowed(3, 53, rules)
    ref.update_allowed(3, 53, jrules)
    return port, ref


#: the corpus's crawler rules (``dns/fqdn-egress.yaml``): a bank of at
#: most 128 states, which the oblivious arm scans itself (the fqdn
#: rules' 138-state bank falls back to the gather arm, warning)
SMALL_RULES = (("*.cilium.io", ""), ("", "example.com"))


@pytest.mark.parametrize("rule_set", ["fqdn", "corpus"])
@pytest.mark.parametrize("arm", ["gather", "pallas"])
def test_check_batch_equals_the_reference_on_the_universe(
        fqdn_universe, arm, rule_set, monkeypatch):
    monkeypatch.setenv("CILIUM_TPU_DFA_IMPL", arm)
    rules, jrules, names = fqdn_universe
    if rule_set == "corpus":
        rules = [PortRuleDNS(match_pattern=p, match_name=n)
                 for p, n in SMALL_RULES]
        jrules = [JaxPortRuleDNS(match_pattern=p, match_name=n)
                  for p, n in SMALL_RULES]
    port, ref = _both(rules, jrules)
    stack = port._get_banked((3, 53), port._rules[(3, 53)])["trans"].shape
    assert (stack[1] <= 128) == (rule_set == "corpus")
    probes = names + [n.upper() + "." for n in names] + [
        "svc0.cilium.io", "api-x.sub2.k8s.local", "nope.io", ""]
    got = port.check_batch(3, 53, probes)
    np.testing.assert_array_equal(got, ref.check_batch(3, 53, probes))
    np.testing.assert_array_equal(
        got, [port.check_allowed(3, 53, q) for q in probes])
    assert 0 < got.sum() < len(got)


@settings(max_examples=20, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(qnames=st.lists(st.one_of(
    st.text(alphabet="abcdeXYZ0123-_.é中", max_size=40),
    st.sampled_from(["SVC0.CILIUM.IO.", "host5.cilium.io..", "a" * 300,
                     "x." * 140 + "example.com", "api-1.sub2.k8s.local."])),
    min_size=1, max_size=24))
def test_check_batch_equals_the_reference_on_hypothesis_qnames(
        fqdn_universe, qnames):
    rules, jrules, _ = fqdn_universe
    port, ref = _both(rules, jrules)
    np.testing.assert_array_equal(port.check_batch(3, 53, qnames),
                                  ref.check_batch(3, 53, qnames))


# ------------------------------------------------ what the port adds
def test_proxy_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DNSProxy()                              # use_tpu is on by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DNSProxy(use_tpu=True)
    assert DNSProxy(use_tpu=False).device is None  # the regex proxy needs none
    assert _proxy().device == torch.device("cpu")


def test_fault_degrades_to_regex_and_is_counted():
    proxy = _proxy()
    proxy.update_allowed(1, 53, [PortRuleDNS(match_pattern="*.io")])
    qnames = ["a.io", "b.com", "c.io"]
    n0 = METRICS.get(DNSPROXY_FALLBACKS)
    with faults.inject(faults.FaultPlan([faults.FaultRule(QUERY_POINT,
                                                          times=1)])):
        first = proxy.check_batch(1, 53, qnames)
        second = proxy.check_batch(1, 53, qnames)
    np.testing.assert_array_equal(first, [True, False, True])
    np.testing.assert_array_equal(second, first)
    assert METRICS.get(DNSPROXY_FALLBACKS) == n0 + 1


@pytest.mark.parametrize("exc", [
    NotImplementedError("arrives with queue 1, Q13"),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_unported_input_and_kernel_failure_pass_the_degrade(exc,
                                                            monkeypatch):
    from cilium_tpu_torch.engine import dfa_kernel

    proxy = _proxy()
    proxy.update_allowed(1, 53, [PortRuleDNS(match_pattern="*.io")])

    def boom(*a, **kw):
        raise exc

    monkeypatch.setattr(dfa_kernel, "dfa_scan_banked", boom)
    n0 = METRICS.get(DNSPROXY_FALLBACKS)
    with pytest.raises(type(exc)):
        proxy.check_batch(1, 53, ["a.io"])
    assert METRICS.get(DNSPROXY_FALLBACKS) == n0
    monkeypatch.setattr(dfa_kernel, "dfa_scan_banked",
                        lambda *a, **kw: (_ for _ in ()).throw(
                            MemoryError("out of memory")))
    np.testing.assert_array_equal(proxy.check_batch(1, 53, ["a.io"]), [True])
    assert METRICS.get(DNSPROXY_FALLBACKS) == n0 + 1


def test_a_card_proxy_degrades_only_the_injected_fault(monkeypatch):
    """On a ``cuda`` proxy an error of the device path (here an out of
    memory raised by the scan) is raised and counts no fallback; the
    injected ``dnsproxy.query`` fault still degrades, counted once. The
    scan is stubbed, so the proxy only claims the card's device."""
    proxy = _proxy()
    proxy.update_allowed(1, 53, [PortRuleDNS(match_pattern="*.io")])
    monkeypatch.setattr(proxy, "device", torch.device("cuda"))

    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(proxy, "_scan", oom)
    n0 = METRICS.get(DNSPROXY_FALLBACKS)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        proxy.check_batch(1, 53, ["a.io"])
    assert METRICS.get(DNSPROXY_FALLBACKS) == n0
    with faults.inject(faults.FaultPlan([faults.FaultRule(QUERY_POINT,
                                                          times=1)])):
        got = proxy.check_batch(1, 53, ["a.io", "b.com"])
    np.testing.assert_array_equal(got, [True, False])
    assert METRICS.get(DNSPROXY_FALLBACKS) == n0 + 1


def test_a_concurrent_update_never_installs_a_stale_automaton(monkeypatch):
    """``_get_banked`` compiles outside the lock; when ``update_allowed``
    moves the rules on meanwhile, the stale automaton serves the call
    that built it but is not installed, and the next call builds the
    new rules' one."""
    from cilium_tpu_torch.fqdn import dnsproxy as dp

    proxy = _proxy()
    proxy.update_allowed(1, 53, [PortRuleDNS(match_name="old.io")])
    real = dp.compile_patterns
    calls = []

    def racing(srcs, *a, **kw):
        calls.append(list(srcs))
        if len(calls) == 1:
            proxy.update_allowed(1, 53, [PortRuleDNS(match_name="new.io")])
        return real(srcs, *a, **kw)

    monkeypatch.setattr(dp, "compile_patterns", racing)
    proxy.check_batch(1, 53, ["old.io"])
    assert (1, 53) not in proxy._banked
    np.testing.assert_array_equal(
        proxy.check_batch(1, 53, ["old.io", "new.io"]), [False, True])
    assert len(calls) == 2 and proxy._banked[(1, 53)][0] == tuple(
        proxy._rules[(1, 53)])
    proxy.check_batch(1, 53, ["new.io"])
    assert len(calls) == 2                      # installed: no recompile


def test_server_times_out_cleanly_on_stop():
    upstream = FakeUpstream()
    server = DNSProxyServer(DNSProxy(use_tpu=False),
                            endpoint_of=lambda ip: 7,
                            upstream=upstream.address).start()
    t0 = time.monotonic()
    server.stop()
    upstream.close()
    assert time.monotonic() - t0 < 5.0
