"""Stage a compiled policy's arrays as the port's device tensors — the
port's "weights carried across".

``arrays_from_reference`` takes a ``CompiledPolicy.arrays`` dict plus
the ``plan_for_engine`` extras, built by either package (their arrays
are byte-equal), and returns tensors on ``device``. uint32 arrays
(accept words, ruleset and group masks, the kafka api-key masks) are
re-read as int32 bit patterns: torch's uint32 lacks the bitwise and
comparison operators the resolve needs, and the bits are what matter.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cilium_tpu_torch.core.device import DeviceLike, resolve_device


def stage_array(v, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(v))
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy()).to(device)


def arrays_from_reference(arrays: Dict[str, np.ndarray],
                          device: DeviceLike = None
                          ) -> Dict[str, torch.Tensor]:
    """{name: numpy array} → {name: tensor on ``device``} (default
    ``cuda``; raises without it)."""
    dev = resolve_device(device)
    return {k: stage_array(v, dev) for k, v in arrays.items()}
