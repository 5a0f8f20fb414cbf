"""Transparent DNS proxy server, UDP and TCP (counterpart of the
reference's ``fqdn/server.py``, copied).

Per query it (1) maps the client source address to its endpoint, (2)
runs ``check_allowed`` (host regex, as in the reference), (3) on deny
answers REFUSED without touching the network, (4) on allow forwards
upstream, checks the answer's txid and question, relays it, and feeds
the observed IPs to the NameManager so FQDN selectors materialize as
ipcache identities. An upstream that does not answer in time gets the
client a SERVFAIL. A TCP listener shares the same verdict path (RFC
7766 length framing), the truncation fallback clients take when a UDP
answer sets TC.

This is the wire half on top of :class:`cilium_tpu_torch.fqdn.dnsproxy
.DNSProxy` (the verdict half), using the stdlib codec in ``wire.py``.
Allowed queries are forwarded on a pool of handler threads (TCP
connections on a pool of their own), so upstream round trips never
block the receive loop.
"""

from __future__ import annotations

import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

from cilium_tpu_torch.fqdn import wire
from cilium_tpu_torch.fqdn.dnsproxy import DNSProxy
from cilium_tpu_torch.runtime import simclock
from cilium_tpu_torch.runtime.metrics import (
    FQDN_HANDLER_ERRORS,
    FQDN_MALFORMED_QUERIES,
    FQDN_QUERIES,
    FQDN_UNKNOWN_CLIENT,
    FQDN_UPSTREAM_TIMEOUTS,
    METRICS,
)

#: verdict callback signature: (qname, endpoint_id, allowed, rcode)
VerdictHook = Callable[[str, int, bool, int], None]


class DNSProxyServer:
    """Serve DNS on a UDP socket, enforcing the proxy's allow-rules.

    ``endpoint_of``: maps a client source IP to its endpoint id
    (the reference derives this from the socket's original destination
    + endpoint lookup); return None for unknown clients → REFUSED.
    """

    def __init__(
        self,
        proxy: DNSProxy,
        endpoint_of: Callable[[str], Optional[int]],
        upstream: Tuple[str, int] = ("127.0.0.53", 53),
        bind: Tuple[str, int] = ("127.0.0.1", 0),
        dport: int = 53,
        timeout: float = 2.0,
        on_verdict: Optional[VerdictHook] = None,
    ) -> None:
        self.proxy = proxy
        self.endpoint_of = endpoint_of
        self.upstream = upstream
        self.dport = dport
        self.timeout = timeout
        self.on_verdict = on_verdict
        # UDP + TCP on the SAME address (reference proxy.go serves
        # both; clients fall back to TCP on truncated UDP answers).
        # With an ephemeral request (port 0) the kernel picks the UDP
        # port blind to the TCP namespace, so an occupied TCP port
        # retries with a fresh UDP bind; an EXPLICIT port conflict is
        # the caller's error and raises
        for attempt in range(10):
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.bind(bind)
            self.address = self._sock.getsockname()
            self._tcp_sock = socket.socket(socket.AF_INET,
                                           socket.SOCK_STREAM)
            self._tcp_sock.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
            try:
                self._tcp_sock.bind((self.address[0], self.address[1]))
                break
            except OSError:
                self._sock.close()
                self._tcp_sock.close()
                if bind[1] != 0 or attempt == 9:
                    raise
        self._sock.settimeout(0.5)
        self._tcp_sock.listen(16)
        self._tcp_sock.settimeout(0.5)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tcp_thread: Optional[threading.Thread] = None
        # bounded worker pool; stop() drains it so no handler outlives
        # the server (a late upstream answer must not race agent teardown)
        self._pool = ThreadPoolExecutor(max_workers=16,
                                        thread_name_prefix="dns-handler")
        # TCP connections get their OWN pool: a handler owns its
        # connection for its whole lifetime (idle clients renew the
        # timeout indefinitely), so sharing the UDP pool would let 16
        # idle TCP clients starve every UDP forward
        self._tcp_pool = ThreadPoolExecutor(max_workers=32,
                                            thread_name_prefix="dns-tcp")

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "DNSProxyServer":
        self._thread = threading.Thread(
            target=self._serve, name="dns-proxy", daemon=True)
        self._thread.start()
        self._tcp_thread = threading.Thread(
            target=self._serve_tcp, name="dns-proxy-tcp", daemon=True)
        self._tcp_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self._tcp_thread:
            self._tcp_thread.join(timeout=5)
        self._pool.shutdown(wait=True)  # bounded by the upstream timeout
        self._tcp_pool.shutdown(wait=True)  # handlers exit on _stop
        self._sock.close()
        self._tcp_sock.close()

    # -- serve loop -------------------------------------------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                data, client = self._sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            # decode + endpoint + verdict run INLINE (microseconds, no
            # network I/O) so denials never convoy behind handlers stuck
            # on a dead upstream; only allowed queries hit the pool.
            # User callbacks (endpoint_of / on_verdict) may raise — a
            # bad query must drop that query, never the serve loop
            try:
                fwd = self._verdict_phase(
                    data, client[0],
                    lambda rcode: self._reply(client, data, rcode))
            except Exception:
                METRICS.inc(FQDN_HANDLER_ERRORS, 1)
                continue
            if fwd is None:
                continue
            try:
                self._pool.submit(self._forward, data, client, *fwd)
            except RuntimeError:
                break  # pool shut down mid-stop

    def _reply(self, client, query: bytes, rcode: int) -> None:
        try:
            self._sock.sendto(wire.encode_response(query, rcode), client)
        except (OSError, wire.DNSDecodeError):
            pass

    def _verdict_phase(self, data: bytes, client_ip: str, reply):
        """Fast path (shared by the UDP loop and TCP handlers): decode,
        map the client to an endpoint, evaluate the verdict, answer
        denials immediately via ``reply(rcode)``. Returns
        (msg, qname, ep) when the query should be forwarded."""
        try:
            msg = wire.decode(data)
        except wire.DNSDecodeError:
            METRICS.inc(FQDN_MALFORMED_QUERIES, 1)
            return None  # not even parseable enough to answer
        if msg.is_response or not msg.questions:
            return None
        qname = msg.qname
        ep = self.endpoint_of(client_ip)
        if ep is None:
            METRICS.inc(FQDN_UNKNOWN_CLIENT, 1)
            reply(wire.RCODE_REFUSED)
            return None
        allowed = self.proxy.check_allowed(ep, self.dport, qname)
        METRICS.inc(FQDN_QUERIES, 1,
                    labels={"verdict": "allow" if allowed else "deny"})
        if not allowed:
            if self.on_verdict:
                self.on_verdict(qname, ep, False, wire.RCODE_REFUSED)
            reply(wire.RCODE_REFUSED)
            return None
        return (msg, qname, ep)

    # -- TCP path (truncation fallback; RFC 7766 length framing) ----------
    def _serve_tcp(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._tcp_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                self._tcp_pool.submit(self._handle_tcp_conn, conn, addr)
            except RuntimeError:
                conn.close()
                break

    @staticmethod
    def _recvn(conn, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _handle_tcp_conn(self, conn, addr) -> None:
        """One TCP connection; queries are pipelined (many frames per
        connection, answered in order — the reference handles each
        sequentially per connection too)."""
        with conn:
            conn.settimeout(self.timeout)
            while not self._stop.is_set():
                try:
                    hdr = self._recvn(conn, 2)
                    if hdr is None:
                        return
                    data = self._recvn(conn, int.from_bytes(hdr, "big"))
                    if data is None:
                        return
                except (socket.timeout, OSError):
                    return

                def reply(rcode, _data=data):
                    try:
                        resp = wire.encode_response(_data, rcode)
                        conn.sendall(len(resp).to_bytes(2, "big") + resp)
                    except (OSError, wire.DNSDecodeError):
                        pass

                try:
                    fwd = self._verdict_phase(data, addr[0], reply)
                except Exception:
                    METRICS.inc(FQDN_HANDLER_ERRORS, 1)
                    continue
                if fwd is None:
                    continue
                resp = self._forward_tcp_upstream(data, *fwd)
                if resp is None:
                    reply(wire.RCODE_SERVFAIL)
                    continue
                try:
                    conn.sendall(len(resp).to_bytes(2, "big") + resp)
                except OSError:
                    return

    def _forward_tcp_upstream(self, data: bytes, msg, qname: str,
                              ep: int) -> Optional[bytes]:
        """Forward one query upstream over TCP; returns the validated
        response bytes (txid + question checked) or None."""
        try:
            with socket.create_connection(self.upstream,
                                          timeout=self.timeout) as up:
                up.sendall(len(data).to_bytes(2, "big") + data)
                hdr = self._recvn(up, 2)
                if hdr is None:
                    raise OSError("upstream closed")
                resp = self._recvn(up, int.from_bytes(hdr, "big"))
                if resp is None:
                    raise OSError("upstream closed mid-frame")
        except (socket.timeout, OSError):
            METRICS.inc(FQDN_UPSTREAM_TIMEOUTS, 1)
            return None
        try:
            parsed = wire.decode(resp)
        except wire.DNSDecodeError:
            return None
        if not (parsed.txid == msg.txid and parsed.is_response
                and parsed.qname.lower() == qname.lower()):
            return None
        ips = [a.ip for a in parsed.answers if a.ip]
        if ips and parsed.rcode == wire.RCODE_NOERROR:
            ttl = min((a.ttl for a in parsed.answers if a.ip), default=0)
            self.proxy.observe_response(simclock.wall(), qname, ips,
                                        ttl=int(ttl))
        if self.on_verdict:
            self.on_verdict(qname, ep, True, parsed.rcode)
        return resp

    def _forward(self, data: bytes, client, msg, qname: str,
                 ep: int) -> None:
        # forward upstream on a fresh, CONNECTED socket: connect() makes
        # the kernel reject datagrams from any other source address, and
        # the txid + question check below rejects off-path forgeries
        # racing the resolver — both must pass before the answer is
        # relayed or observed (cache-poisoning guard)
        up = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        resp = None
        try:
            up.settimeout(self.timeout)
            up.connect(self.upstream)
            up.send(data)
            deadline = simclock.now() + self.timeout
            while resp is None:
                remaining = deadline - simclock.now()
                if remaining <= 0:
                    raise socket.timeout()
                up.settimeout(remaining)
                candidate = up.recv(4096)
                try:
                    parsed = wire.decode(candidate)
                except wire.DNSDecodeError:
                    continue  # garbage from the right address: keep waiting
                if (parsed.txid == msg.txid and parsed.is_response
                        and parsed.qname.lower() == qname.lower()):
                    resp = candidate
        except (socket.timeout, OSError):
            METRICS.inc(FQDN_UPSTREAM_TIMEOUTS, 1)
            self._reply(client, data, wire.RCODE_SERVFAIL)
            return
        finally:
            up.close()

        ips = [a.ip for a in parsed.answers if a.ip]
        if ips and parsed.rcode == wire.RCODE_NOERROR:
            ttl = min((a.ttl for a in parsed.answers if a.ip), default=0)
            self.proxy.observe_response(simclock.wall(), qname, ips,
                                        ttl=int(ttl))
        if self.on_verdict:
            self.on_verdict(qname, ep, True, parsed.rcode)
        try:
            self._sock.sendto(resp, client)
        except OSError:
            pass
