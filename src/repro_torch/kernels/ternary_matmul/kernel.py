"""The packed-ternary matmul kernel: CUDA for Hopper, with its plain version.

:func:`ternary_matmul` computes ``y[M, N] = (x[M, K] @ unpack(packed)) *
scale`` with the weights 2-bit in device memory (CUDA source
``csrc/ternary_matmul.cu``).  Given tensors on the CPU it runs the plain
version :func:`~.ref.ternary_matmul_ref`; given CUDA tensors it launches the
kernel, or raises.  ``launch_counts`` counts kernel launches (plain runs do
not count).  The kernel builds through :mod:`repro_torch.kernels.cuda_lib`.
"""
from __future__ import annotations

from pathlib import Path

import torch

from .. import cuda_lib
from ..cuda_lib import I32 as _I, I64 as _LL, VP as _VP
from .ref import PACK, ternary_matmul_ref

BM_TILES = (1, 2, 4, 8, 16)          # M tiles the kernel is built for
MAX_GRID_Y = 65535

launch_counts = {"ternary_matmul": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

cuda_lib.register(cuda_lib.CudaLibrary(
    "ternary_matmul", Path(__file__).resolve().with_name("csrc"),
    "ternary_matmul.cu", (), "ternary_matmul_launch",
    (_VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _I, _VP)))


def m_tile(m: int) -> int:
    """The kernel's M tile: the smallest of :data:`BM_TILES` covering
    ``min(m, 16)`` — a decode batch computes no padding rows."""
    return next(b for b in BM_TILES if b >= min(m, BM_TILES[-1]))


def ternary_matmul(x: torch.Tensor, packed: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """y[M, N] = (x[M, K] @ unpack(packed)[K', N]) * scale[N].

    ``x`` [M, K] with K <= K' = 16 * packed.shape[0] (the missing columns
    count as zero); ``packed`` [K'/16, N] int32; ``scale`` [N].  y has x's
    dtype.  On CUDA tensors x must be float32 or bfloat16.
    """
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"x and packed must be 2-D, got {tuple(x.shape)} "
                         f"and {tuple(packed.shape)}")
    if x.shape[1] > packed.shape[0] * PACK:
        raise ValueError(f"x K={x.shape[1]} exceeds packed K'="
                         f"{packed.shape[0] * PACK}")
    if scale.reshape(-1).shape[0] != packed.shape[1]:
        raise ValueError(f"scale has {scale.numel()} entries for N="
                         f"{packed.shape[1]}")
    if x.device.type == "cpu":
        return ternary_matmul_ref(x, packed, scale.reshape(-1))
    return _launch(x, packed, scale.reshape(-1))


def _launch(x, packed, scale):
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"ternary_matmul: the CUDA kernel needs CUDA "
                         f"tensors, got x on {dev}")
    if packed.device != dev or scale.device != dev:
        raise ValueError(f"ternary_matmul: x on {dev}, packed on "
                         f"{packed.device}, scale on {scale.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"ternary_matmul: x must be float32 or bfloat16, "
                         f"got {x.dtype}")
    if packed.dtype != torch.int32:
        raise ValueError(f"ternary_matmul: packed must be int32, got "
                         f"{packed.dtype}")
    m, kx = x.shape
    k16, n = packed.shape
    bm = m_tile(m)
    if -(-m // bm) > MAX_GRID_Y:
        raise ValueError(f"M={m} needs more than {MAX_GRID_Y} row tiles")
    x = x.contiguous()
    packed = packed.contiguous()
    scale = scale.to(torch.float32).contiguous()
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return y
    launch = cuda_lib.entry("ternary_matmul")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                     y.data_ptr(), m, kx, k16, n, _DTYPES[x.dtype], bm,
                     stream)
    cuda_lib.check_status(err, "ternary_matmul")
    launch_counts["ternary_matmul"] += 1
    return y
