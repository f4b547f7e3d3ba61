"""The plain PyTorch version of the decode-attention kernel: its oracle on
the card."""
from __future__ import annotations

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         n_valid: int, scale: float | None = None
                         ) -> torch.Tensor:
    """q [B, 1, H, hd] against the first ``n_valid`` slots of k, v [B, L,
    Hk, hd] (H a multiple of Hk; query head h reads kv head h // (H / Hk)),
    scores scaled by ``scale`` (None: hd ** -0.5), in fp32; the output [B,
    1, H, hd] in q's dtype.  The kv heads are not repeated: each group of
    query heads reads its kv head's slots."""
    b, _, h, hd = q.shape
    hk = k.shape[2]
    qf = q.reshape(b, hk, h // hk, hd).to(torch.float32)
    kf = k[:, :n_valid].to(torch.float32)
    vf = v[:, :n_valid].to(torch.float32)
    s = torch.einsum("bgrd,btgd->bgrt", qf, kf) * (
        hd ** -0.5 if scale is None else scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrt,btgd->bgrd", p, vf)
    return o.reshape(b, 1, h, hd).to(q.dtype)
