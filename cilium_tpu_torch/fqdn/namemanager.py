"""NameManager: observed DNS answers → identities → policy updates
(counterpart of the reference's ``fqdn/namemanager.py``, copied).

Registered ``FQDNSelector``s are matched against every observed DNS
answer; matching IPs get CIDR identities through the ipcache, and the
SelectorCache's FQDN selections are updated
(``SelectorCache.update_fqdn_selections``) so dependent MapStates can
be regenerated incrementally.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Set

from cilium_tpu_torch.fqdn.cache import DNSCache
from cilium_tpu_torch.ipcache import IPCache
from cilium_tpu_torch.policy.api.selector import FQDNSelector
from cilium_tpu_torch.policy.compiler import matchpattern
from cilium_tpu_torch.policy.selectorcache import SelectorCache


class NameManager:
    def __init__(self, selector_cache: SelectorCache, ipcache: IPCache,
                 dns_cache: Optional[DNSCache] = None) -> None:
        self._lock = threading.Lock()
        self.selector_cache = selector_cache
        self.ipcache = ipcache
        self.cache = dns_cache or DNSCache()
        self._selectors: Dict[FQDNSelector, "re.Pattern"] = {}
        #: called with the set of selectors whose selections changed —
        #: the hook that triggers endpoint regeneration (§3.2 tail)
        self.on_update: Optional[Callable[[Set[FQDNSelector]], None]] = None

    def register_selector(self, sel: FQDNSelector) -> None:
        if sel.match_name:
            src = matchpattern.name_to_regex(sel.match_name)
        else:
            src = matchpattern.to_regex(sel.match_pattern)
        with self._lock:
            self._selectors[sel] = re.compile(src)
        self.selector_cache.add_selector(sel)
        # replay cached names against the new selector
        self._resync([sel])

    def unregister_selector(self, sel: FQDNSelector) -> None:
        with self._lock:
            self._selectors.pop(sel, None)
        self.selector_cache.remove_selector(sel)

    def registered_selectors(self) -> List[FQDNSelector]:
        with self._lock:
            return list(self._selectors)

    def update_generate_dns(self, lookup_time: float, name: str,
                            ips: Iterable[str], ttl: int = 0) -> bool:
        """Ingest one DNS answer (the reference's UpdateGenerateDNS).
        Returns True if any selector's selections changed."""
        ips = list(ips)
        changed = self.cache.update(lookup_time, name, ips, ttl)
        qname = matchpattern.sanitize_name(name)
        with self._lock:
            matching = [s for s, rx in self._selectors.items()
                        if rx.match(qname)]
        if not matching:
            return False
        return self._resync(matching, now=lookup_time)

    def _resync(self, selectors: List[FQDNSelector],
                now: Optional[float] = None) -> bool:
        """Recompute selections for ``selectors`` from the DNS cache."""
        updated: Set[FQDNSelector] = set()
        with self._lock:
            rx_of = {s: self._selectors[s] for s in selectors
                     if s in self._selectors}
        for sel, rx in rx_of.items():
            ips: Set[str] = set()
            for name, name_ips in self.cache.lookup_by_regex(
                    rx, now=now).items():
                ips.update(name_ips)
            ids = {self.ipcache.upsert(f"{ip}/32" if ":" not in ip
                                       else f"{ip}/128")
                   for ip in ips}
            # update_fqdn_selections is a no-op (False) for selectors a
            # concurrent policy delete already removed — no resurrection
            if self.selector_cache.update_fqdn_selections(sel, ids):
                updated.add(sel)
        if updated and self.on_update is not None:
            self.on_update(updated)
        return bool(updated)

    def gc(self, now: Optional[float] = None) -> None:
        """Expire TTLs and resync affected selectors (the reference's
        periodic DNS GC controller)."""
        affected_names = self.cache.expire(now)
        if not affected_names:
            return
        with self._lock:
            selectors = [
                s for s, rx in self._selectors.items()
                if any(rx.match(n) for n in affected_names)
            ]
        if selectors:
            self._resync(selectors, now=now)
