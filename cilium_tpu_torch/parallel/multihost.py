"""Multi-process support (the reference's ``parallel/multihost.py``).

One process per rank; after :func:`init_multihost` every process is a
rank of one ``torch.distributed`` world, and a :func:`global_mesh`
spans all of them. Rule tensors are deterministic functions of the
ruleset (content-hashed by the artifact cache), so every rank stages
identical policy arrays without any state exchange — the property that
lets cilium agents run shared-nothing off a common CRD store.

Everything that attributes work to a HOST (the serving-fleet router,
provenance stamps on bench lines, the explain plane's (host,
pack-cycle) scope) names hosts through :func:`host_id`, so simulated
in-process replicas and real multi-process runs agree on the format;
where the reference asks JAX for the process index, the port asks
``torch.distributed`` for its rank.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from cilium_tpu_torch.core.device import DeviceLike
from cilium_tpu_torch.parallel.mesh import Mesh, make_mesh


def init_multihost(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   backend: Optional[str] = None,
                   timeout_s: float = 600.0) -> bool:
    """Initialise ``torch.distributed`` when running multi-process.

    Arguments default from torchrun's standard environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT`` through
    ``init_method="env://"``). Returns True when a process group was
    initialised (or already was), False for the single-process case —
    callers need no branch, the global mesh just spans one rank.
    ``backend`` defaults to ``nccl`` where CUDA is available, else
    ``gloo``; where ``LOCAL_RANK`` is set, the rank's current CUDA
    device is ``LOCAL_RANK`` modulo the devices it sees."""
    if dist.is_initialized():
        return True
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if world_size is None or world_size <= 1:
        return False  # single-process
    cuda = torch.cuda.is_available()
    if cuda and "LOCAL_RANK" in env:
        torch.cuda.set_device(int(env["LOCAL_RANK"])
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if cuda else "gloo"),
        init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(shape: Optional[Tuple[int, ...]] = None,
                axis_names: Sequence[str] = ("data",),
                device: DeviceLike = None) -> Mesh:
    """Mesh over every rank of the world.

    Default: all ranks on one ``data`` axis — pure DP, because policy
    tensors replicate and flow slices never interact. Pass a 2-D shape
    (e.g. ``(hosts, ranks_per_host)`` as ``("data", "expert")``) to keep
    EP's exchange inside a host while DP spans hosts — put the chatty
    axis on the fast interconnect."""
    return make_mesh(shape, axis_names, None, device)


def process_span() -> Tuple[int, int]:
    """(rank, world size) — for sharding host-side work such as
    flow-capture file assignment across agent processes; ``(0, 1)``
    without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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
    if dist.is_available() and dist.is_initialized():
        return f"host-{dist.get_rank()}"
    return "host-0"
