"""Accesslog server: the proxy→agent L7 record channel.

Reference: ``pkg/envoy``'s accesslog server — Envoy (and proxylib
parsers) write per-request access-log records to a unix socket the
agent owns; ``pkg/hubble/parser/seven`` turns them into flowpb L7
flows feeding the observer. Ours: a SOCK_STREAM unix socket accepting
newline-delimited JSON in EITHER capture schema (Envoy accesslog
entries or flowpb flows — ``ingest/accesslog.parse_capture_line``);
parsed flows land in the agent's Observer ring (and therefore the
hubble socket, relay, metrics, exporter) exactly like datapath
events.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from typing import Optional

from cilium_tpu_torch.ingest.accesslog import parse_capture_line
from cilium_tpu_torch.runtime.metrics import METRICS


class AccessLogServer:
    def __init__(self, observer, socket_path: str) -> None:
        self.observer = observer
        self.socket_path = socket_path
        if os.path.exists(socket_path):
            os.unlink(socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(socket_path)
        self._sock.listen(16)
        self._sock.settimeout(0.5)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conn_threads: list = []

    def start(self) -> "AccessLogServer":
        self._thread = threading.Thread(
            target=self._serve, name="accesslog-server", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        for t in self._conn_threads:
            t.join(timeout=2)
        self._sock.close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name="accesslog-conn", daemon=True)
            t.start()
            # prune finished handlers — connection-per-burst proxies
            # would otherwise grow this list for the process lifetime
            self._conn_threads = [x for x in self._conn_threads
                                  if x.is_alive()]
            self._conn_threads.append(t)

    def _handle(self, conn) -> None:
        """One writer connection: newline-delimited JSON records. A
        malformed line is counted and skipped — one bad record must
        not sever the proxy's log stream."""
        buf = b""
        with conn:
            conn.settimeout(0.5)
            while not self._stop.is_set():
                try:
                    chunk = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not chunk:
                    break
                buf += chunk
                *lines, buf = buf.split(b"\n")
                self._ingest(lines)
            if buf.strip():
                self._ingest([buf])

    def _ingest(self, lines) -> None:
        flows = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                flows.append(parse_capture_line(json.loads(line)))
            except (ValueError, KeyError, TypeError, AttributeError):
                # AttributeError: valid JSON that is not an object (a
                # list, a number); the reference lets it end the
                # connection's thread
                METRICS.inc(
                    "cilium_tpu_accesslog_decode_errors_total", 1)
        if flows:
            self.observer.observe(flows)
            METRICS.inc("cilium_tpu_accesslog_records_total",
                        len(flows))
