"""Parallelism layer: rank meshes, shardings, multi-process (the
reference's ``parallel/``), over ``torch.distributed``.

In the reference one process drives a device mesh through
``shard_map``; here each rank is a process that runs the ``shard_map``
body on its own shard (``mesh.py``). The strategy map, one module each:

* **DP** (``sharding.py``) — flows sharded on the batch axis; rule
  tensors replicated; zero collectives.
* **TP** (``tp.py``) — the DFA transition table sharded on its *state*
  axis; one-hot matmul step with a ``psum`` a byte.
* **PP** (``pipeline.py``) — host→device copies double-buffered on a
  side stream across batches.
* **SP/CP** (``engine/longscan.py``, ``cp.py``) — long payloads:
  blockwise composition inside a rank, one carry exchange across ranks.
* **EP / Ulysses** (``ulysses.py``) — DFA banks sharded on the
  ``expert`` axis, one ``all_to_all`` between the scan and the resolve.
* **Multi-process / elastic** (``multihost.py``) — a process group from
  torchrun's environment; content-hashed rule tensors make every
  rank's staging deterministic, so ranks restart without state exchange.

Every collective goes through ``collectives.py``'s ledger. The
reference's ``compat.py`` has no counterpart: it shims ``shard_map``
across jax generations, and there is no ``shard_map`` here.
"""

from cilium_tpu_torch.parallel.collectives import (
    LEDGER,
    gather_global,
    gather_global_dict,
)
from cilium_tpu_torch.parallel.mesh import (
    LocalWorld,
    Mesh,
    data_parallel_mesh,
    make_mesh,
)
from cilium_tpu_torch.parallel.multihost import (
    global_mesh,
    host_id,
    init_multihost,
    process_span,
)
from cilium_tpu_torch.parallel.pipeline import collect, run_pipelined
from cilium_tpu_torch.parallel.sharding import (
    make_sharded_step,
    read_global,
    shard_flow_batch,
    shard_policy_arrays,
    stage_for_lane,
)
from cilium_tpu_torch.parallel.tp import (
    dfa_scan_banked_tp,
    dfa_scan_tp,
    pad_states,
)
from cilium_tpu_torch.parallel.ulysses import ulysses_scan_banked

__all__ = [
    "make_mesh",
    "data_parallel_mesh",
    "global_mesh",
    "init_multihost",
    "process_span",
    "host_id",
    "collect",
    "run_pipelined",
    "shard_policy_arrays",
    "shard_flow_batch",
    "make_sharded_step",
    "stage_for_lane",
    "read_global",
    "dfa_scan_tp",
    "dfa_scan_banked_tp",
    "pad_states",
    "ulysses_scan_banked",
    "LEDGER",
    "gather_global",
    "gather_global_dict",
    "LocalWorld",
    "Mesh",
]
