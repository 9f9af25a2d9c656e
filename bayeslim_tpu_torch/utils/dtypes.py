"""
Default dtype and device policy, physical constants, complex views.

Counterpart of bayeslim_tpu/utils/dtypes.py (isreal_view :75).

- The default real dtype is float32 (the working type on the card);
  float64 is asked for explicitly (the CPU parity tests do so).
- The default device is CUDA. ``resolve_device(None)`` returns
  ``cuda`` and raises when no GPU is present: nothing quietly runs on
  the CPU. Callers that want the CPU pass ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "_float", "set_default_dtype", "resolve_device",
    "viewreal", "viewcomp", "isreal_view", "D2R", "R2D", "C_MS",
]

D2R = np.pi / 180.0
R2D = 180.0 / np.pi
C_MS = 2.99792458e8  # speed of light [m/s]

_DEFAULT_REAL = [torch.float32]


def set_default_dtype(dtype=None):
    """Set the default real dtype of model constructors (None resets
    to float32)."""
    _DEFAULT_REAL[0] = torch.float32 if dtype is None else dtype


def _float():
    """Default real floating dtype."""
    return _DEFAULT_REAL[0]


def resolve_device(device=None):
    """``device=None`` means CUDA; raise if it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bayeslim_tpu_torch defaults to device='cuda' but no CUDA "
            "device is available; pass device='cpu' explicitly to run "
            "on the CPU")
    return dev


def viewcomp(x):
    """View a real tensor with trailing dim 2 as complex; complex
    tensors pass through."""
    if x.is_complex():
        return x
    if x.shape[-1] != 2:
        raise ValueError("viewcomp requires trailing dim of 2")
    return torch.complex(x[..., 0], x[..., 1])


def viewreal(x):
    """View a complex tensor as real with a trailing dim of 2."""
    if not x.is_complex():
        return x
    return torch.stack([x.real, x.imag], dim=-1)


def isreal_view(x):
    """True if x (a tensor or an array) looks like a real-pair view of
    a complex array: real, with a trailing axis of 2."""
    if isinstance(x, torch.Tensor):
        return (not x.is_complex()) and x.ndim > 0 and x.shape[-1] == 2
    x = np.asarray(x)
    return (not np.iscomplexobj(x)) and x.ndim > 0 and x.shape[-1] == 2
