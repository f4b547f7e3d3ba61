"""GQA decode attention on the card, read straight from the KV cache.

:func:`decode_attention` computes one new token's attention, ``q [B, 1, H,
hd]`` against the first ``n_valid`` slots of a cache ``k, v [B, L, Hk,
hd]``, in fp32, the output in q's dtype, by launching
``csrc/decode_attention.cu``; a call the kernel does not take raises.
:func:`supports` says which calls it takes (:func:`takes` all but the
device): bf16 or fp16 q on CUDA, the cache in q's dtype, ``hd`` a multiple
of 32 up to 256, ``H % Hk == 0``, and the cache's strides multiples of 16
bytes over a contiguous last dim.  The grid is one CTA per (sequence, kv
head, group of :func:`group_size` query heads, split of the slots);
:func:`split_shape` adapts the split to the grid.  ``launch_counts``
counts launches.  The plain version is :func:`.ref.decode_attention_ref`.
Builds through :mod:`repro_torch.kernels.cuda_lib`.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import cuda_lib
from ..cuda_lib import I32 as _I, I64 as _LL, VP as _VP

TILE = 64                   # cache slots per tile of the kernel
GROUPS = (1, 2, 4, 8)       # query heads a CTA holds
MAX_HEAD_DIM = 256
MAX_SPLITS = 65535

launch_counts = {"decode_attention": 0}

_DTYPES = {torch.bfloat16: 0, torch.float16: 1}

_CSRC = Path(__file__).resolve().with_name("csrc")
cuda_lib.register(cuda_lib.CudaLibrary(
    "decode_attention", _CSRC, "decode_attention.cu", (),
    "decode_attention_launch",
    (_VP, _VP, _VP, _VP, _VP, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I, _I, _I,
     _I, ctypes.c_float, _I, _I, _I, _I, _VP)))


def _cache_aligned(t: torch.Tensor) -> bool:
    """16-byte rows for the kernel's copies: a contiguous last dim, every
    other stride a multiple of 8 elements, the start 16-byte aligned."""
    return (t.stride(3) == 1 and all(s % 8 == 0 for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel takes this call: q on CUDA and :func:`takes`."""
    return q.is_cuda and takes(q, k, v)


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """The kernel's terms apart from the device: q [B, 1, H, hd] bf16 or
    fp16, k and v [B, L, Hk, hd] of q's dtype on its device, hd a multiple
    of 32 up to 256, H a multiple of Hk, the cache's rows 16-byte aligned,
    and no gradient to record (the kernel has no backward)."""
    if q.dtype not in _DTYPES or q.dim() != 4:
        return False
    if any(t.dtype != q.dtype or t.device != q.device or t.dim() != 4
           for t in (k, v)):
        return False
    b, one, h, hd = q.shape
    if one != 1 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        return False
    if hd % 32 or hd > MAX_HEAD_DIM or k.shape[2] == 0 or h % k.shape[2]:
        return False
    if q.numel() == 0 or k.shape[1] == 0:
        return False
    if torch.is_grad_enabled() and q.requires_grad:
        return False
    return _cache_aligned(k) and _cache_aligned(v)


def group_size(n_rep: int) -> int:
    """Query heads a CTA holds: the smallest of :data:`GROUPS` that holds
    ``n_rep``, at most 8 (more heads take several CTAs)."""
    return next(g for g in GROUPS if g >= min(n_rep, GROUPS[-1]))


def split_shape(ctas: int, n_tiles: int, n_sm: int) -> tuple[int, int]:
    """(splits, tiles per split) of the slots' ``n_tiles`` tiles for a grid
    of ``ctas`` CTAs before the split: enough splits for two CTAs on each
    of the ``n_sm`` SMs, none empty.  A batch of 128 sequences x 8 kv heads
    fills the card with one; a single sequence splits its slots."""
    splits = max(1, min(n_tiles, -(-2 * n_sm // ctas), MAX_SPLITS))
    per = -(-n_tiles // splits)
    return -(-n_tiles // per), per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_valid: int, scale: float | None = None
                     ) -> torch.Tensor:
    """out [B, 1, H, hd] = softmax((q . k[:, :n_valid]) * scale) @
    v[:, :n_valid] per query head, query head h reading kv head h // (H /
    Hk), in fp32; out in q's dtype.  ``scale`` None is ``hd ** -0.5``.  A
    ``ValueError`` if ``n_valid`` lies outside the cache or the kernel
    does not take the call (:func:`supports`)."""
    if not 1 <= n_valid <= k.shape[1]:
        raise ValueError(f"decode_attention: n_valid={n_valid} outside 1.."
                         f"{k.shape[1]}")
    if not supports(q, k, v):
        raise ValueError(
            f"decode_attention: the kernel does not take q {q.dtype} "
            f"{tuple(q.shape)} on {q.device} with k {k.dtype} "
            f"{tuple(k.shape)} strides {k.stride()} on {k.device}, v "
            f"{v.dtype} {tuple(v.shape)} strides {v.stride()}")
    b, _, h, hd = q.shape
    if scale is None:
        scale = hd ** -0.5
    hk = k.shape[2]
    group = group_size(h // hk)
    ctas = b * hk * -(-(h // hk) // group)
    n_split, per = split_shape(ctas, -(-n_valid // TILE),
                               _sm_count(q.device.index))
    q = q.contiguous()
    out = torch.empty_like(q)
    part = None
    if n_split > 1:
        part = torch.empty(ctas * n_split * group * (hd + 2),
                           dtype=torch.float32, device=q.device)
    entry = cuda_lib.entry("decode_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), 0 if part is None else part.data_ptr(),
                    *k.stride()[:3], *v.stride()[:3], b, h, hk, hd,
                    n_valid, scale, _DTYPES[q.dtype], group, n_split,
                    per, stream)
    cuda_lib.check_status(err, "decode_attention")
    launch_counts["decode_attention"] += 1
    return out
