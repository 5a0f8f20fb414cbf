"""DNS proxy verdict path (counterpart of the reference's
``fqdn/dnsproxy.py``).

A transparent proxy holding per-(endpoint, port) allow-rules;
``check_allowed(endpoint, dport, qname)`` is the per-query hot path
(BASELINE configs[0]); allowed responses feed the NameManager.

Two matchers behind one interface, as in the reference:

* the host: a compiled-regex set (``check_allowed``, and
  ``check_batch`` with ``use_tpu=False``);
* the card: ``check_batch`` with ``use_tpu=True`` (the reference's name
  for the gate, and the default) scans the ``[N, 256]`` qname batch with
  the banked DFA (``engine/dfa_kernel.dfa_scan_banked``) on the proxy's
  ``device``: kernel KD under the ``gather`` arm, K2 under ``oblivious``
  for banks of at most 128 states. ``device`` defaults to ``cuda`` and
  the constructor raises without it; ``device="cpu"`` runs the plain
  versions.

The ``dnsproxy.query`` fault degrades the batch to the regex set (same
sources, same verdicts) and counts it
(``cilium_tpu_dnsproxy_fallback_total``), as the reference does. On a
``cuda`` proxy nothing else degrades: an error of the device path
(out of memory, a kernel failure, a wrapper's shape check) is raised,
so the host never answers for work the card failed. A proxy on the CPU
degrades any error but a ``NotImplementedError`` or a kernel failure
(``_build.is_kernel_failure``), which pass as they pass the verdict
service's breaker.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from cilium_tpu_torch.core.device import DeviceLike, resolve_device
from cilium_tpu_torch.fqdn.namemanager import NameManager
from cilium_tpu_torch.policy.api.l7 import PortRuleDNS
from cilium_tpu_torch.policy.compiler import matchpattern
from cilium_tpu_torch.policy.compiler.dfa import compile_patterns
from cilium_tpu_torch.runtime import faults
from cilium_tpu_torch.runtime.metrics import DNSPROXY_FALLBACKS, METRICS
from cilium_tpu_torch.runtime.tracing import (
    PHASE_DEVICE,
    PHASE_FALLBACK,
    PHASE_HOST,
    TRACER,
)

#: fires in the banked-DFA batch path; a device fault degrades the
#: batch to the regex matcher (same verdicts, slower)
QUERY_POINT = faults.register_point(
    "dnsproxy.query", "banked-DFA DNS batch verdict")

#: bytes of a qname the device path scans (longer names are cut)
QNAME_LEN = 256


def _passes(exc: BaseException) -> bool:
    """An error a CPU proxy's degrade lets through: an input the port
    does not serve yet, or a kernel that failed."""
    from cilium_tpu_torch.engine import _build

    return isinstance(exc, NotImplementedError) or \
        _build.is_kernel_failure(exc)


class DNSProxy:
    def __init__(self, name_manager: Optional[NameManager] = None,
                 use_tpu: bool = True, device: DeviceLike = None) -> None:
        self._lock = threading.Lock()
        self.name_manager = name_manager
        self.use_tpu = use_tpu
        #: where ``check_batch`` scans when ``use_tpu`` is on
        self.device = resolve_device(device) if use_tpu else device
        # (endpoint_id, dport) → list of regex sources
        self._rules: Dict[Tuple[int, int], List[str]] = {}
        self._compiled: Dict[Tuple[int, int], List["re.Pattern"]] = {}
        self._banked: Dict[Tuple[int, int], object] = {}

    def update_allowed(self, endpoint_id: int, dport: int,
                       rules: Sequence[PortRuleDNS]) -> None:
        """Install the allow-set for an endpoint+port (the reference's
        UpdateAllowed, called at regeneration time)."""
        srcs: List[str] = []
        for r in rules:
            if r.match_name:
                srcs.append(matchpattern.name_to_regex(r.match_name))
            elif r.match_pattern:
                srcs.append(matchpattern.to_regex(r.match_pattern))
        key = (endpoint_id, dport)
        with self._lock:
            if not srcs:
                self._rules.pop(key, None)
                self._compiled.pop(key, None)
                self._banked.pop(key, None)
                return
            self._rules[key] = srcs
            self._compiled[key] = [re.compile(s) for s in srcs]
            self._banked.pop(key, None)  # lazily rebuilt

    def check_allowed(self, endpoint_id: int, dport: int,
                      qname: str) -> bool:
        """The per-query hot path (host regex)."""
        q = matchpattern.sanitize_name(qname)
        with self._lock:
            pats = self._compiled.get((endpoint_id, dport))
        if pats is None:
            return False  # no rules installed → deny (proxy is opt-in)
        return any(p.match(q) for p in pats)

    def check_batch(self, endpoint_id: int, dport: int,
                    qnames: Sequence[str]) -> np.ndarray:
        """Batched verdicts: the banked DFA on the proxy's device when
        ``use_tpu`` is on, else the regex set."""
        key = (endpoint_id, dport)
        with self._lock:
            srcs = self._rules.get(key)
            pats = self._compiled.get(key)
        if srcs is None or pats is None:
            return np.zeros(len(qnames), dtype=bool)
        with TRACER.trace("dnsproxy.batch", endpoint=endpoint_id,
                          queries=len(qnames)):
            with TRACER.span("dns.sanitize", phase=PHASE_HOST,
                             records=len(qnames)):
                sanitized = [matchpattern.sanitize_name(q)
                             for q in qnames]
            if not self.use_tpu:
                with TRACER.span("dns.regex", phase=PHASE_FALLBACK,
                                 records=len(sanitized)):
                    return np.array(
                        [any(p.match(q) for p in pats)
                         for q in sanitized], dtype=bool)
            try:
                faults.maybe_fail(QUERY_POINT)
            except Exception:  # noqa: BLE001 — the injected device fault
                return self._degrade(pats, sanitized)
            try:
                with TRACER.span("dns.dfa", phase=PHASE_DEVICE,
                                 records=len(sanitized)):
                    return self._scan(key, srcs, sanitized)
            except Exception as exc:  # noqa: BLE001 — CPU path: degrade
                if self.device.type != "cpu" or _passes(exc):
                    raise
                return self._degrade(pats, sanitized)

    @staticmethod
    def _degrade(pats, sanitized: List[str]) -> np.ndarray:
        """The counted fallback: the regex set and the banked DFA are
        compiled from the SAME sources, so it answers identically."""
        METRICS.inc(DNSPROXY_FALLBACKS)
        with TRACER.span("dns.regex", phase=PHASE_FALLBACK,
                         records=len(sanitized)):
            return np.array([any(p.match(q) for p in pats)
                             for q in sanitized], dtype=bool)

    def _scan(self, key, srcs, sanitized: List[str]) -> np.ndarray:
        """The banked DFA over the sanitized names ``[N, QNAME_LEN]``
        on the proxy's device → allowed [N]."""
        import torch

        from cilium_tpu_torch.engine.dfa_kernel import (
            dfa_scan_banked,
            resolve_impl,
        )

        n = len(sanitized)
        if n == 0:
            return np.zeros(0, dtype=bool)
        st = self._get_banked(key, srcs)
        data = np.zeros((n, QNAME_LEN), dtype=np.uint8)
        lengths = np.zeros(n, dtype=np.int32)
        for i, q in enumerate(sanitized):
            bs = q.encode("utf-8")[:QNAME_LEN]
            data[i, :len(bs)] = np.frombuffer(bs, dtype=np.uint8)
            lengths[i] = len(bs)
        words = dfa_scan_banked(
            st["trans"], st["byteclass"], st["start"], st["accept"],
            torch.from_numpy(data).to(self.device),
            torch.from_numpy(lengths).to(self.device),
            impl=resolve_impl())
        return (words.reshape(n, -1) != 0).any(dim=1).cpu().numpy()

    def _get_banked(self, key, srcs):
        """Staged device tensors for the key's automaton, cached keyed
        by the rule sources (a concurrent ``update_allowed`` cannot
        leave a stale automaton, and steady-state calls skip the compile
        and the upload)."""
        from cilium_tpu_torch.weights import stage_array

        want = tuple(srcs)
        with self._lock:
            cached = self._banked.get(key)
            if cached is not None and cached[0] == want:
                return cached[1]
        stacked = compile_patterns(list(want)).stacked()
        staged = {k: stage_array(v, self.device)
                  for k, v in stacked.items() if k != "lane_of"}
        with self._lock:
            # only install if the rules have not moved on meanwhile
            if self._rules.get(key) == list(want):
                self._banked[key] = (want, staged)
        return staged

    def observe_response(self, lookup_time: float, qname: str,
                         ips: Iterable[str], ttl: int = 0) -> None:
        """Forwarded-response hook → NameManager."""
        if self.name_manager is not None:
            self.name_manager.update_generate_dns(lookup_time, qname, ips,
                                                  ttl)
