"""Shared kernel-side helpers (counterpart of ``repro/kernels/_util.py``)."""
from __future__ import annotations

import torch

# Sentinel for negated-distance running top-k scratch: far below any real
# -dist² so masked/uninitialized slots can never be selected.
NEG_BIG = -1e30


def pad_dim(a: torch.Tensor, axis: int, mult: int, fill) -> torch.Tensor:
    """Pad ``axis`` up to a multiple of ``mult`` with ``fill``."""
    pad = (-a.shape[axis]) % mult
    if pad == 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=a.device)],
                     dim=axis)


def pad_rows(a: torch.Tensor, mult: int, fill) -> torch.Tensor:
    """Pad axis 0 up to a multiple of ``mult`` with ``fill``."""
    return pad_dim(a, 0, mult, fill)
