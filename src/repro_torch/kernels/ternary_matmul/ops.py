"""Public wrapper for the packed-ternary matmul, and the backend dispatcher."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import ternary_matmul as _ternary_matmul_kernel
from .ref import PACK, pack_ternary, quantize_ternary, ternary_matmul_ref

ZERO_WORD = 0x55555555     # 0b01 repeated = ternary 0 in all 16 digits


def ternary_matmul_op(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ unpack(packed)) * scale, the reference wrapper's padding
    semantics on any shape.

    x [M, K] float; packed [K'/16, N] int32; scale [N] fp32 -> y [M, N].
    K < K' (pack-time padding rows, zero weights) zero-pads x.  K > K' is
    accepted as the reference wrapper accepts it: its extra columns meet
    zero-weight padding words (so they count only through NaN or inf),
    where :func:`~.ref.ternary_matmul_ref` would refuse the shapes.
    """
    k = x.shape[1]
    k16, n = packed.shape
    if k > k16 * PACK:
        extra = -(-k // PACK) - k16
        packed = torch.cat([packed, torch.full(
            (extra, n), ZERO_WORD, dtype=torch.int32,
            device=packed.device)], dim=0)
    return _ternary_matmul_kernel(x, packed, scale)


def ternary_matmul(x: torch.Tensor, packed: torch.Tensor,
                   scale: torch.Tensor, impl: str = "pallas",
                   **kw) -> torch.Tensor:
    """Backend dispatcher: y = (x @ unpack(packed)) * scale.

    ``impl`` selects the backend — "pallas" or "packed" (the packed-weight
    CUDA kernel, :func:`ternary_matmul_op`; the plain version for CPU
    tensors), "ref" (the plain oracle), or "ap" (the associative-processor
    MAC program, :func:`~repro_torch.kernels.ternary_matmul.ap.
    ternary_matmul_ap`; extra kwargs like radix/width/k_tile/stats pass
    through).  The names are the reference's.
    """
    if impl in ("pallas", "packed"):
        return ternary_matmul_op(x, packed, scale, **kw)
    if impl == "ref":
        if kw:
            raise TypeError(f"impl='ref' takes no extra kwargs, got {kw}")
        return ternary_matmul_ref(x, packed, scale)
    if impl == "ap":
        from .ap import ternary_matmul_ap
        return ternary_matmul_ap(x, packed, scale, **kw)
    raise ValueError(f"unknown impl {impl!r}; use 'pallas', 'ref', or 'ap'")


def quantize_and_pack(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense fp weights [K, N] -> (packed int32 [K'/16, N], scale [N])."""
    k = w.shape[0]
    pad = (-k) % PACK
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
    w_ter, scale = quantize_ternary(w)
    if pad:                              # padded rows must quantize to 0
        w_ter[k:] = 0
    return pack_ternary(w_ter), scale


__all__ = ["ternary_matmul", "ternary_matmul_op", "quantize_and_pack",
           "pack_ternary", "quantize_ternary", "ternary_matmul_ref", "PACK"]
