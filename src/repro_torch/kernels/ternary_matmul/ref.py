"""Plain PyTorch version + pack/unpack helpers for the packed-ternary matmul.

Balanced ternary weights w in {-1, 0, +1} are stored 16-per-int32 (2 bits
each, value+1 in {0,1,2}), packed along the K (reduction) axis:

    packed[k16, n] bits [2i, 2i+1] hold w[16*k16 + i, n] + 1

A per-output-channel fp32 scale recovers magnitude:  y = (x @ w) * scale.
16x fewer weight bytes than fp32, 8x fewer than bf16.
:func:`ternary_matmul_ref` is the kernel's plain version: the oracle of the
tests and the path for tensors on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PACK = 16  # ternary digits per int32
_U32 = (1 << 32) - 1


def _shifts(device) -> torch.Tensor:
    return (2 * torch.arange(PACK, device=device))[None, :, None]


def pack_ternary(w_ter: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 in {-1,0,1}  ->  [K/16, N] int32 (K % 16 == 0).

    The words are built as uint32 in int64 (each term and the sum wrapped
    mod 2^32), then reinterpreted as int32: digit 15 = 2 sets bit 31."""
    k, n = w_ter.shape
    if k % PACK:
        raise ValueError(f"K={k} not a multiple of {PACK}")
    u = (w_ter.to(torch.int64) + 1) & _U32                 # {0,1,2}
    u = u.reshape(k // PACK, PACK, n)
    word = ((u << _shifts(u.device)) & _U32).sum(dim=1) & _U32
    return torch.where(word > 0x7FFFFFFF, word - (1 << 32),
                       word).to(torch.int32)


def unpack_ternary(packed: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """[K/16, N] int32  ->  [K, N] dtype in {-1,0,1}.  ``(p >> 2i) & 3``
    reads bits 2i..2i+1 under the arithmetic shift too."""
    k16, n = packed.shape
    p = packed.to(torch.int32)[:, None, :]
    digits = (p >> _shifts(p.device).to(torch.int32)) & 3  # [K/16, 16, N]
    return (digits - 1).reshape(k16 * PACK, n).to(dtype)


def quantize_ternary(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AbsMean ternarization (BitNet-style): per-output-channel scale.

    Returns (w_ter int8 [K, N], scale fp32 [N]) with
    dequant(w) ~= w_ter * scale.
    """
    scale = torch.clamp_min(w.abs().mean(dim=0), 1e-8)     # [N]
    w_ter = torch.clamp(torch.round(w / scale[None, :]), -1,
                        1).to(torch.int8)
    return w_ter, scale.to(torch.float32)


def ternary_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Oracle: y[M, N] = (x[M, K] @ unpack(packed)[K', N]) * scale[N].

    K may be smaller than the packed K' (= ceil(K/16)*16): the pack step
    zero-quantizes the padding rows, so x is zero-padded to match."""
    w = unpack_ternary(packed, dtype=torch.float32)
    kp = w.shape[0]
    if x.shape[1] < kp:
        x = F.pad(x, (0, kp - x.shape[1]))
    y = x.to(torch.float32) @ w
    return (y * scale[None, :]).to(x.dtype)


def split_bf16x3(x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 x as three bf16 parts, x = hi + mid + lo, as the tensor-core
    kernel splits it: hi is x with the low 16 bits of its word cleared, mid
    the same of x - hi, lo = x - hi - mid.  Each difference is exact in
    fp32 and each part holds at most 8 significant bits, so the parts add
    back to x exactly for |x| >= 2^-110 (a zero gives (+-0, +0, +0)); an
    infinite x gives (x, 0, 0)."""
    x = x.to(torch.float32)

    def top(v):                          # the top half of v's word, exact
        return (v.view(torch.int32) & -65536).view(torch.float32)

    hi = top(x)
    r = torch.where(x == hi, torch.zeros_like(x), x - hi)
    mid = top(r)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), \
        (r - mid).to(torch.bfloat16)


def ternary_matmul_3pass(x: torch.Tensor, packed: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's fp32 product, plainly: the three bf16 parts
    of x (:func:`split_bf16x3`) each times the weights, exact, summed in
    fp32, times scale, rounded once to x's dtype."""
    w = unpack_ternary(packed, dtype=torch.float32)
    kp = w.shape[0]
    if x.shape[1] < kp:
        x = F.pad(x, (0, kp - x.shape[1]))
    acc = sum(part.to(torch.float32) @ w for part in split_bf16x3(x))
    return (acc * scale[None, :]).to(x.dtype)
