"""Mamba2 (SSD — state-space duality) mixer, chunked, a loop over chunks.

Per head h with scalar decay a_t = exp(dt_t * A_h),

    h_t = a_t * h_{t-1} + dt_t * B_t (x) x_t          (state  [N, P])
    y_t = C_t . h_t + D_h * x_t

computed chunk-parallel: within a chunk of length L the quadratic
"attention-like" term is an einsum, and a Python loop over the S/L chunks
carries the inter-chunk state (one [B,H,N,P] tensor), in fp32.  Decode is
the O(1) single-step recurrence; each step adds the state and conv-state
bytes it reads and writes once to the registry counter
``ssm.state_bytes`` (from shapes, no device sync).

The depthwise conv carries a bias where the params hold ``conv_b``
(:func:`init_mamba` makes one under ``SSMCfg.conv_bias``: granite's).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..apc.metrics import get_registry
from ..configs.base import SSMCfg
from .common import dense_init, rms_norm, unread_dot

_F32 = torch.float32


def init_mamba(gen: torch.Generator, d_model: int, cfg: SSMCfg,
               dtype=torch.float32) -> dict:
    d_in = cfg.expand * d_model
    n_heads = d_in // cfg.head_dim
    conv_ch = d_in + 2 * cfg.n_groups * cfg.d_state
    proj_out_dim = 2 * d_in + 2 * cfg.n_groups * cfg.d_state + n_heads
    dev = gen.device
    p = {
        "in_proj": dense_init(gen, (d_model, proj_out_dim), 0, dtype),
        "conv_w": dense_init(gen, (cfg.conv_width, conv_ch), 0, dtype),
        "dt_bias": torch.zeros((n_heads,), dtype=dtype, device=dev),
        "a_log": torch.zeros((n_heads,), dtype=dtype, device=dev),
        "d_skip": torch.ones((n_heads,), dtype=dtype, device=dev),
        "norm": torch.ones((d_in,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (d_in, d_model), 0, dtype),
    }
    if cfg.conv_bias:
        p["conv_b"] = torch.zeros((conv_ch,), dtype=dtype, device=dev)
    return p


def _split_proj(proj, d_in, g, n, n_heads):
    z = proj[..., :d_in]
    xbc = proj[..., d_in: d_in + d_in + 2 * g * n]
    dt = proj[..., -n_heads:]
    return z, xbc, dt


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv, width w.shape[0]; x [B, S, C]; ``bias`` [C]
    added where given."""
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + pad[:, i: i + x.shape[1], :] * w[i][None, None, :]
    return out if bias is None else out + bias


def _ssd_chunked(x, dt, a_log, b_mat, c_mat, cfg: SSMCfg):
    """x [B,S,H,P]; dt [B,S,H]; b/c [B,S,G,N] -> y [B,S,H,P] (fp32)."""
    bsz, s, h, p = x.shape
    g = b_mat.shape[2]
    L = min(cfg.chunk, s)
    if s % L:
        raise ValueError(f"seq {s} not divisible by chunk {L}")
    rep = h // g

    A = -torch.exp(a_log.to(_F32))                     # [H], negative
    loga = dt.to(_F32) * A[None, None, :]              # [B,S,H] = log decay
    x, dt = x.to(_F32), dt.to(_F32)
    b_mat, c_mat = b_mat.to(_F32), c_mat.to(_F32)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    hstate = torch.zeros((bsz, h, b_mat.shape[3], p), dtype=_F32,
                         device=x.device)
    ys = []
    for c0 in range(0, s, L):
        xc, dtc, lac = x[:, c0:c0 + L], dt[:, c0:c0 + L], loga[:, c0:c0 + L]
        bc, cc = b_mat[:, c0:c0 + L], c_mat[:, c0:c0 + L]
        la = torch.cumsum(lac, dim=1)                  # [B,L,H] inclusive
        bh = torch.repeat_interleave(bc, rep, dim=2)   # [B,L,H,N]
        ch = torch.repeat_interleave(cc, rep, dim=2)
        # intra-chunk quadratic term
        cb = torch.einsum("bihn,bjhn->bhij", ch, bh)   # [B,H,L,L]
        decay = torch.exp(la[:, :, None, :] - la[:, None, :, :])  # [B,i,j,H]
        decay = decay.permute(0, 3, 1, 2)              # [B,H,i,j]
        w_ij = torch.where(mask[None, None], cb * decay, 0.0)
        w_ij = w_ij * dtc.transpose(1, 2)[:, :, None, :]         # dt_j
        y_intra = torch.einsum("bhij,bjhp->bihp", w_ij, xc)
        # contribution of carried state: decay from chunk start
        y_inter = torch.einsum("bihn,bhnp->bihp", ch, hstate) \
            * torch.exp(la)[..., None]
        # new chunk state
        tail = torch.exp(la[:, -1:, :] - la)           # [B,L,H] decay to end
        sc = torch.einsum("bjhn,bjh,bjh,bjhp->bhnp", bh, dtc, tail, xc)
        hstate = torch.exp(la[:, -1, :])[:, :, None, None] * hstate + sc
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)                        # [B,S,H,P]


def mamba_forward(p: dict, x: torch.Tensor, cfg: SSMCfg, d_model: int,
                  norm_eps: float, tail: bool = False) -> torch.Tensor:
    """Prefill path.  x [B, S, d] -> [B, S, d].  ``tail``: the output
    projection feeds only a super-block's output
    (:func:`~repro_torch.models.common.unread_dot`)."""
    d_in = cfg.expand * d_model
    g, n = cfg.n_groups, cfg.d_state
    n_heads = d_in // cfg.head_dim
    lead = x.shape[:2]
    proj = x @ p["in_proj"]
    z, xbc, dt = _split_proj(proj, d_in, g, n, n_heads)
    xbc = F.silu(_causal_conv(xbc, p["conv_w"], p.get("conv_b")))
    xs = xbc[..., :d_in]
    b_mat = xbc[..., d_in: d_in + g * n].reshape(*lead, g, n)
    c_mat = xbc[..., d_in + g * n:].reshape(*lead, g, n)
    dt = F.softplus(dt + p["dt_bias"])
    xh = xs.reshape(*lead, n_heads, cfg.head_dim)
    y = _ssd_chunked(xh, dt, p["a_log"], b_mat, c_mat, cfg)
    y = y + p["d_skip"].to(_F32)[None, None, :, None] * xh.to(_F32)
    y = y.reshape(*lead, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], norm_eps)
    with unread_dot(tail):
        return y @ p["out_proj"]


# ---------------------------------------------------------------------------
# Decode path (O(1) state update)
# ---------------------------------------------------------------------------

def init_mamba_cache(batch: int, d_model: int, cfg: SSMCfg,
                     dtype=torch.float32, device=None) -> dict:
    d_in = cfg.expand * d_model
    n_heads = d_in // cfg.head_dim
    conv_ch = d_in + 2 * cfg.n_groups * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, n_heads, cfg.d_state, cfg.head_dim),
                           dtype=_F32, device=device),
    }


def mamba_decode_step(p: dict, x: torch.Tensor, cache: dict, cfg: SSMCfg,
                      d_model: int, norm_eps: float):
    """x [B, 1, d] -> (y [B, 1, d], new cache).  Types promote as the
    reference's do: the fp32 conv cache takes the step to fp32 until the
    output cast."""
    d_in = cfg.expand * d_model
    g, n = cfg.n_groups, cfg.d_state
    n_heads = d_in // cfg.head_dim
    proj = x[:, 0] @ p["in_proj"]                      # [B, ...]
    z, xbc, dt = _split_proj(proj, d_in, g, n, n_heads)
    conv_dt = torch.promote_types(cache["conv"].dtype, xbc.dtype)
    conv_in = torch.cat([cache["conv"].to(conv_dt),
                         xbc[:, None, :].to(conv_dt)], dim=1)
    w = p["conv_w"]                                    # [W, C]
    mix_dt = torch.promote_types(conv_dt, w.dtype)
    xbc = torch.einsum("bwc,wc->bc", conv_in.to(mix_dt), w.to(mix_dt))
    if "conv_b" in p:
        xbc = xbc + p["conv_b"].to(mix_dt)
    xbc = F.silu(xbc)
    new_conv = conv_in[:, 1:, :]
    xs = xbc[:, :d_in]
    b_mat = xbc[:, d_in: d_in + g * n].reshape(-1, g, n)
    c_mat = xbc[:, d_in + g * n:].reshape(-1, g, n)
    dt = F.softplus(dt + p["dt_bias"]).to(_F32)       # [B,H]
    A = -torch.exp(p["a_log"].to(_F32))
    a = torch.exp(dt * A[None, :])                     # [B,H]
    rep = n_heads // g
    bh = torch.repeat_interleave(b_mat, rep, dim=1).to(_F32)    # [B,H,N]
    ch = torch.repeat_interleave(c_mat, rep, dim=1).to(_F32)
    xh = xs.reshape(-1, n_heads, cfg.head_dim).to(_F32)
    h_new = (a[..., None, None] * cache["ssm"]
             + torch.einsum("bh,bhn,bhp->bhnp", dt, bh, xh))
    y = torch.einsum("bhn,bhnp->bhp", ch, h_new)
    y = y + p["d_skip"].to(_F32)[None, :, None] * xh
    y = y.reshape(-1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], norm_eps)
    y = (y @ p["out_proj"])[:, None, :]
    get_registry().counter("ssm.state_bytes").inc(2 * sum(
        t.numel() * t.element_size() for t in cache.values()))
    return y, {"conv": new_conv, "ssm": h_new}
