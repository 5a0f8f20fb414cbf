"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless its caller names another
device. Without CUDA and without an explicit device it raises: a
verdict path that silently drops to the CPU would report CPU numbers
under the card's name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda`` (raises when CUDA is absent); anything else
    is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; "
                "pass device='cpu' explicitly to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)
