"""Load balancing: services, Maglev consistent hashing, batched
backend selection on the device (counterpart of the reference's
``loadbalancer/``; reference: ``pkg/loadbalancer``, ``pkg/service``,
``pkg/maglev`` — SURVEY.md §2.4)."""

from cilium_tpu_torch.loadbalancer.kernel import lb_lookup
from cilium_tpu_torch.loadbalancer.maglev import (
    DEFAULT_TABLE_SIZE, disruption, fnv1a, fnv1a_words, maglev_table,
)
from cilium_tpu_torch.loadbalancer.service import (
    Backend, BackendState, Frontend, PackedLB, Service, ServiceManager,
    ServiceType,
)

__all__ = [
    "Backend", "BackendState", "DEFAULT_TABLE_SIZE", "Frontend",
    "PackedLB", "Service", "ServiceManager", "ServiceType",
    "disruption", "fnv1a", "fnv1a_words", "lb_lookup", "maglev_table",
]
