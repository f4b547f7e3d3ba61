"""Device selection shared by the port's entry points.

Every entry point takes ``device=None``, which means ``cuda:0``.  Without a
card that is an error, never a quiet fall back to the CPU: a caller that
wants the plain CPU path asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises without CUDA); else ``device`` as is."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain CPU path")
    return torch.device("cuda", 0)


def as_digits(arr, device=None) -> torch.Tensor:
    """``arr`` (numpy or tensor) as an int8 tensor on the resolved device."""
    dev = resolve_device(device)
    if isinstance(arr, np.ndarray):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return arr.to(device=dev, dtype=torch.int8)
