"""The packed-ternary matmul kernels: CUDA for Hopper, with their plain
version.

:func:`ternary_matmul` computes ``y[M, N] = (x[M, K] @ unpack(packed)) *
scale`` with the weights 2-bit in device memory.  Given tensors on the CPU
it runs the plain version :func:`~.ref.ternary_matmul_ref`; given CUDA
tensors it launches one of two kernels, or raises.  :func:`kernel_for`
picks by rows alone, for fp32 and bf16 x alike: at least :data:`TC_MIN_M`
rows run on the tensor cores (``csrc/ternary_matmul_tc.cu``, warpgroup
``wgmma`` with the weights as A, decoded from the words straight into
registers, and x as B in shared memory; fp32 x as three exact bf16 passes;
tile and K split from :func:`tc_shape`), fewer on the CUDA cores
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
TC_MIN_M = 16                      # rows from which the tensor cores run
# the tensor-core kernel's tiles, (tokens, outputs) per CTA, by x's dtype,
# each with the words of K (16 trits each) in one step of its pipeline
TC_TILES = {torch.bfloat16: {(16, 64): 16, (64, 64): 4, (64, 128): 4,
                             (128, 128): 8, (64, 256): 4, (256, 128): 8,
                             (128, 256): 4},
            torch.float32: {(16, 64): 8, (64, 64): 4, (64, 128): 4,
                            (128, 128): 4, (64, 256): 4}}
TC_SPLITS = (1, 2, 4, 8)           # tensor-core kernel: CTAs splitting K
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
    (_VP, _VP, _VP, _VP, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _I, _VP)))


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


def tc_shape(m: int, n: int, k16: int, n_sm: int,
             dtype: torch.dtype = torch.bfloat16) -> tuple[int, int, int]:
    """The tensor-core kernel's (tokens per CTA, outputs per CTA, K split).

    At most 16 rows take 16 tokens (a decode batch of 16: no padding rows)
    by one warpgroup's 64 outputs, and up to 64 rows 64 by 64.  More take,
    for bf16 x, 128 outputs by 128 tokens where that grid gives at least
    every other of the ``n_sm`` SMs a CTA, else by 64; for fp32 x, whose
    three passes make a step three times the work, 256 outputs by 64
    tokens where that grid does so, else 128 by 64.  Then K's steps
    (:data:`TC_TILES` gives a tile's words per step) split over a cluster
    of 2, 4 or 8 CTAs: a decode tile's while the grid holds fewer than four
    CTAs an SM and every CTA keeps two steps (its steps are short, and more
    of them in flight hide their latency); another's while the grid covers
    less than three quarters of the card and every CTA keeps eight steps
    (a grid of 128 CTAs on 132 SMs gains nothing from a split and pays for
    its partial sums; a CTA of few steps pays for its pipeline's fill)."""
    def ctas(bt, bw):
        return -(-m // bt) * -(-n // bw)
    if m <= 16:
        bt, bw = 16, 64
    elif m < 64:
        bt, bw = 64, 64
    elif dtype == torch.float32:
        bt, bw = (64, 256) if 2 * ctas(64, 256) >= n_sm else (64, 128)
    else:
        bt, bw = (128, 128) if m >= 128 and 2 * ctas(128, 128) >= n_sm \
            else (64, 128)
    steps = -(-k16 // TC_TILES[dtype][bt, bw])
    split = TC_SPLITS[0]
    while split < TC_SPLITS[-1] and (
            ctas(bt, bw) * split < 4 * n_sm and steps >= 4 * split
            if bt == 16 else
            4 * ctas(bt, bw) * split < 3 * n_sm and steps >= 16 * split):
        split *= 2
    return bt, bw, split


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


def _launch_tensor_cores(x, packed, scale, shape=None):
    """The tensor-core kernel, for either dtype (fp32 as three bf16
    passes) and any M; ``shape`` = (tokens, outputs, K split) overrides
    :func:`tc_shape`."""
    x, packed, scale, y = _checked(x, packed, scale)
    m, kx = x.shape
    k16, n = packed.shape
    if shape is None:
        shape = tc_shape(m, n, k16, _sm_count(x.device.index), x.dtype)
    bt, bw, split = shape
    if (bt, bw) not in TC_TILES[x.dtype] or split not in TC_SPLITS:
        raise ValueError(f"ternary_matmul_tc: tile {(bt, bw)} split {split} "
                         f"not in {tuple(TC_TILES[x.dtype])} x {TC_SPLITS}")
    if -(-m // bt) > MAX_GRID_Y:
        raise ValueError(f"M={m} needs more than {MAX_GRID_Y} row tiles")
    if m == 0 or n == 0:
        return y
    # TMA needs every row start 16-byte aligned; other operands are staged
    # by the kernel's producer warp element by element
    x_vec = (kx * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0
    w_vec = n % 4 == 0 and packed.data_ptr() % 16 == 0
    launch = cuda_lib.entry("ternary_matmul_tc")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
                     y.data_ptr(), m, kx, k16, n, _DTYPES[x.dtype], bt, bw,
                     split, int(x_vec), int(w_vec), stream)
    cuda_lib.check_status(err, "ternary_matmul_tc")
    launch_counts["ternary_matmul_tc"] += 1
    return y
