"""The packed-ternary matmul kernels: CUDA for Hopper, with their plain
version.

:func:`ternary_matmul` computes ``y[M, N] = (x[M, K] @ unpack(packed)) *
scale`` with the weights 2-bit in device memory.  Given tensors on the CPU
it runs the plain version :func:`~.ref.ternary_matmul_ref`; given CUDA
tensors it launches one of two kernels, or raises.  :func:`kernel_for`
picks by rows alone, for fp32 and bf16 x alike: at least :data:`TC_MIN_M`
rows run on the tensor cores (``csrc/ternary_matmul_tc.cu``, ``mma.sync`` on
B fragments decoded from the words in registers; fp32 x as three exact bf16
passes; M tile from :func:`tc_m_tile`), fewer on the CUDA cores
(``csrc/ternary_matmul.cu``, fp32 FMAs; a grid spread over the card by
:func:`cuda_core_shape`).  ``launch_counts`` counts the launches of each
kernel (plain runs do not count).  Both build through
:mod:`repro_torch.kernels.cuda_lib`.
"""
from __future__ import annotations

import functools
from pathlib import Path

import torch

from .. import cuda_lib
from ..cuda_lib import I32 as _I, I64 as _LL, VP as _VP
from .ref import PACK, ternary_matmul_ref

BM_TILES = (1, 2, 4, 8, 16)        # M tiles of the CUDA-core kernel
TC_M_TILES = (16, 64, 128)         # M tiles of the tensor-core kernel
TC_PREFILL_TILE = 64               # the M tile for grids that fill the card
TC_MIN_M = 16                      # rows from which the tensor cores run
TC_BN = 128                        # columns per CTA of the tensor-core kernel
CC_COLS = (1, 4)                   # CUDA-core kernel: columns per lane
CC_SPLITS = (1, 2, 4)              # CUDA-core kernel: CTAs splitting K
CC_CHUNK_WORDS = 32                # CUDA-core kernel: words per K chunk
MAX_GRID_Y = 65535

launch_counts = {"ternary_matmul": 0, "ternary_matmul_tc": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_CSRC = Path(__file__).resolve().with_name("csrc")
cuda_lib.register(cuda_lib.CudaLibrary(
    "ternary_matmul", _CSRC, "ternary_matmul.cu", (), "ternary_matmul_launch",
    (_VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _I, _I, _I, _VP)))
cuda_lib.register(cuda_lib.CudaLibrary(
    "ternary_matmul_tc", _CSRC, "ternary_matmul_tc.cu", (),
    "ternary_matmul_tc_launch",
    (_VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _I, _I, _I, _VP)))


def kernel_for(dtype: torch.dtype, m: int) -> str:
    """The kernel a CUDA call launches for x with ``m`` rows, fp32 or bf16
    alike: ``"ternary_matmul_tc"`` for m >= TC_MIN_M, else
    ``"ternary_matmul"``."""
    return "ternary_matmul_tc" if m >= TC_MIN_M else "ternary_matmul"


def m_tile(m: int) -> int:
    """The CUDA-core kernel's M tile: the smallest of :data:`BM_TILES`
    covering ``min(m, 16)`` — a decode batch computes no padding rows."""
    return next(b for b in BM_TILES if b >= min(m, BM_TILES[-1]))


def cuda_core_shape(m: int, n: int, k16: int, n_sm: int
                    ) -> tuple[int, int, int]:
    """The CUDA-core kernel's (M tile, columns per lane, K split): four
    columns per lane (128 per CTA) where that grid gives each of the
    ``n_sm`` SMs a CTA, else one (32 per CTA); then the K chunks split over
    a cluster of 2 or 4 CTAs while the grid is smaller than the card and
    every CTA keeps at least one chunk."""
    bm = m_tile(m)
    tiles = -(-m // bm)
    cols = CC_COLS[-1] if -(-n // (32 * CC_COLS[-1])) * tiles >= n_sm \
        else CC_COLS[0]
    ctas = -(-n // (32 * cols)) * tiles
    chunks = -(-k16 // CC_CHUNK_WORDS)
    split = CC_SPLITS[0]
    while (ctas * split < n_sm and split < CC_SPLITS[-1]
           and chunks >= 2 * split):
        split *= 2
    return bm, cols, split


def tc_m_tile(m: int, n: int, n_sm: int) -> int:
    """The tensor-core kernel's M tile: :data:`TC_PREFILL_TILE` rows where
    that grid gives each of the ``n_sm`` SMs a CTA, else 16 (more CTAs, and
    no padding rows for a decode batch).  The 128-row tile is built for
    comparison: on an H100 it trailed the 64-row one at every MLP shape
    that ``chip_smoke.py`` times (PERF.md)."""
    tile = TC_PREFILL_TILE
    if m >= tile and -(-m // tile) * -(-n // TC_BN) >= n_sm:
        return tile
    return TC_M_TILES[0]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if kernel_for(x.dtype, x.shape[0]) == "ternary_matmul_tc":
        return _launch_tensor_cores(x, packed, scale)
    return _launch_cuda_cores(x, packed, scale)


def _checked(x, packed, scale):
    """Refuse what the kernels do not take; the contiguous operands, scale
    as fp32, and the empty output."""
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
    y = torch.empty((x.shape[0], packed.shape[1]), dtype=x.dtype, device=dev)
    return (x.contiguous(), packed.contiguous(),
            scale.to(torch.float32).contiguous(), y)


def _launch_cuda_cores(x, packed, scale):
    """The CUDA-core kernel, for either dtype and any M."""
    x, packed, scale, y = _checked(x, packed, scale)
    m, kx = x.shape
    k16, n = packed.shape
    bm, cols, split = cuda_core_shape(m, n, k16, _sm_count(x.device.index))
    if -(-m // bm) > MAX_GRID_Y:
        raise ValueError(f"M={m} needs more than {MAX_GRID_Y} row tiles")
    if m == 0 or n == 0:
        return y
    launch = cuda_lib.entry("ternary_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                     y.data_ptr(), m, kx, k16, n, _DTYPES[x.dtype], bm,
                     cols, split, stream)
    cuda_lib.check_status(err, "ternary_matmul")
    launch_counts["ternary_matmul"] += 1
    return y


def _launch_tensor_cores(x, packed, scale, bm=None):
    """The tensor-core kernel, for either dtype (fp32 as three bf16
    passes) and any M; ``bm`` overrides the M tile."""
    x, packed, scale, y = _checked(x, packed, scale)
    m, kx = x.shape
    k16, n = packed.shape
    if bm is None:
        bm = tc_m_tile(m, n, _sm_count(x.device.index))
    if bm not in TC_M_TILES:
        raise ValueError(f"ternary_matmul_tc: M tile {bm} not in "
                         f"{TC_M_TILES}")
    if -(-m // bm) > MAX_GRID_Y:
        raise ValueError(f"M={m} needs more than {MAX_GRID_Y} row tiles")
    if m == 0 or n == 0:
        return y
    # 16-byte cp.async needs every row start 16-byte aligned
    x_vec = (kx * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    w_vec = n % 4 == 0 and packed.data_ptr() % 16 == 0
    launch = cuda_lib.entry("ternary_matmul_tc")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                     y.data_ptr(), m, kx, k16, n, _DTYPES[x.dtype], bm,
                     int(x_vec), int(w_vec), stream)
    cuda_lib.check_status(err, "ternary_matmul_tc")
    launch_counts["ternary_matmul_tc"] += 1
    return y
