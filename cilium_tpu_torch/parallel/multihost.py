"""Host identity — the fleet seam (the reference's
``parallel/multihost.host_id``).

Everything that attributes work to a HOST (the serving-fleet router,
provenance stamps on bench lines, the explain plane's (host,
pack-cycle) scope) names hosts through :func:`host_id`, so simulated
in-process replicas and real multi-process runs agree on the format.
The reference's multi-process runtime and global device mesh are not
ported; where the reference asks JAX for the process index, the port
asks ``torch.distributed`` for its rank.
"""

from __future__ import annotations

import os
from typing import Optional


def host_id(index: Optional[int] = None) -> str:
    """Stable host identity:

    * ``index`` given → ``host-<index>`` (the fleetserve simulated
      replicas, where many "hosts" share one process);
    * ``CILIUM_TPU_HOST_ID`` set → that value verbatim (operators
      pinning an external identity, and the bench harness making fleet
      lines attributable);
    * otherwise ``host-<rank>`` when a ``torch.distributed`` process
      group is initialised, ``host-0`` when none is.
    """
    if index is not None:
        return f"host-{int(index)}"
    env = os.environ.get("CILIUM_TPU_HOST_ID", "")
    if env:
        return env
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return f"host-{dist.get_rank()}"
    return "host-0"
