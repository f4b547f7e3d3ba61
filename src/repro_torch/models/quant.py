"""Packed balanced-ternary serving weights (the paper technique).

Converts trained MLP projection weights to the 16-per-int32 packed form
(kernels/ternary_matmul layout) so the serving weights are 2-bit in device
memory: w [K, N] float -> {w_packed [K/16, N] int32, w_scale [N] fp32}.
:func:`unpack_matmul` is the plain version of the packed product (unpack
by shift/mask, then a dense matmul), as the reference's models use it; the
CUDA kernel (:mod:`repro_torch.kernels.ternary_matmul`) replaces
unpack + matmul with decoding in registers.

Stacked (scan-over-layers) params convert layer by layer.  Embedding /
attention tables are left in full precision.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ternary_matmul.ops import quantize_and_pack
from ..kernels.ternary_matmul.ref import PACK

MLP_KEYS = ("w1", "w3", "w2")


def _pack_one(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return quantize_and_pack(w.to(torch.float32))


def pack_mlp_params(mlp: dict) -> dict:
    """{w1, w3, w2} -> {w1_packed, w1_scale, ...} (handles stacked leaves)."""
    out = {}
    for key in MLP_KEYS:
        w = mlp[key]
        if w.dim() == 3:                     # stacked [n_sb, K, N]
            pairs = [_pack_one(wi) for wi in w]
            packed = torch.stack([p for p, _ in pairs])
            scale = torch.stack([s for _, s in pairs])
        else:
            packed, scale = _pack_one(w)
        out[f"{key}_packed"] = packed
        out[f"{key}_scale"] = scale
    return out


def unpack_matmul(x: torch.Tensor, packed: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ unpack(packed)) * scale in x's dtype; x K-dim may be < K'."""
    k16, n = packed.shape
    shifts = (2 * torch.arange(PACK, dtype=torch.int32,
                               device=packed.device))[None, :, None]
    digits = (packed.to(torch.int32)[:, None, :] >> shifts) & 3
    w = (digits.to(torch.int8) - 1).reshape(k16 * PACK, n).to(x.dtype)
    if x.shape[-1] < k16 * PACK:
        x = F.pad(x, (0, k16 * PACK - x.shape[-1]))
    return (x @ w) * scale.to(x.dtype)


def quantize_model_params(params: dict) -> dict:
    """Walk the param tree, replacing every 'mlp' subtree with packed form."""
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k == "mlp" and isinstance(v, dict) and "w1" in v:
                    out[k] = pack_mlp_params(v)
                else:
                    out[k] = walk(v)
            return out
        return node
    return walk(params)
