"""toFQDNs runtime (counterpart of the reference's ``fqdn`` package):
the per-name TTL cache, observed-answer → identity plumbing
(NameManager → ipcache → SelectorCache), the DNS proxy's verdict path
(host regex, or the banked DFA on the card in batches; BASELINE
configs[0]) and its UDP/TCP server. The glob → regex compile lives in
``policy.compiler.matchpattern``.
"""

from cilium_tpu_torch.fqdn.cache import DNSCache
from cilium_tpu_torch.fqdn.namemanager import NameManager
from cilium_tpu_torch.fqdn.dnsproxy import DNSProxy
from cilium_tpu_torch.fqdn.server import DNSProxyServer

__all__ = ["DNSCache", "NameManager", "DNSProxy", "DNSProxyServer"]
