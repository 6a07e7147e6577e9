"""Where the port's entry points run: on the card unless told otherwise.

`GridBool.from_mesh`, `build_grid`, `voxelize_mesh`, `build_scene` and
`build_tri_accel` take `device=None`, which means the CUDA card.  A
machine without one raises instead of quietly running on the CPU;
callers that want the plain PyTorch versions pass `device="cpu"`.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """device=None -> torch.device("cuda"), raising where there is no
    card; anything else -> torch.device(device)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port's entry points run on the card "
                "by default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
