"""Mixture-of-Experts with sort-based capacity dispatch, on one device.

router -> top-k -> flat (token, expert) pairs sorted by expert ->
position-in-expert via rank-within-segment -> capacity-dropped scatter into
an [E, C, d] buffer -> block-diagonal expert einsum -> weighted combine.

:func:`moe_ffn` is the single-device body of the reference's
``_local_moe_tp`` without its collectives.  On one chip the reference's
``"ep"`` mode falls to that body too (it needs more than one model shard).
Inside :func:`repro_torch.apc.layers.ap_serving` the experts run on the AP
instead (:func:`moe_ffn_ap`).
"""
from __future__ import annotations

import torch

from ..configs.base import MoECfg
from .common import act_fn, dense_init


def init_moe(gen: torch.Generator, d_model: int, cfg: MoECfg,
             dtype=torch.float32) -> dict:
    e, ff = cfg.n_experts, cfg.d_ff
    return {
        "router": dense_init(gen, (d_model, e), 0, torch.float32),
        "w1": dense_init(gen, (e, d_model, ff), 1, dtype),
        "w3": dense_init(gen, (e, d_model, ff), 1, dtype),
        "w2": dense_init(gen, (e, ff, d_model), 1, dtype),
    }


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: MoECfg):
    """x2d [T, d] -> (gates [T, k] fp32, experts [T, k] int32).

    ``torch.topk`` and ``jax.lax.top_k`` may order equal probabilities
    differently; with random float inputs ties do not arise."""
    logits = x2d.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk:
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, experts.to(torch.int32)


def _dispatch_indices(experts: torch.Tensor, n_experts: int,
                      capacity: int) -> torch.Tensor:
    """Sort-based dispatch bookkeeping.

    experts [T, k] -> slot [T*k]: the target buffer slot, or E*C if
    dropped.  Rank within expert on the sorted stream: pos_i = i -
    start_of_segment(expert_i)."""
    t, k = experts.shape
    flat = experts.reshape(-1).long()                   # [T*k]
    perm = torch.argsort(flat, stable=True)             # sorted by expert
    sorted_e = flat[perm]
    counts = torch.bincount(flat, minlength=n_experts)  # [E]
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=flat.device) - seg_start[sorted_e]
    keep = pos < capacity
    slot_sorted = torch.where(keep, sorted_e * capacity + pos,
                              n_experts * capacity)     # overflow -> dropped
    slot = torch.zeros((t * k,), dtype=torch.int32, device=flat.device)
    slot[perm] = slot_sorted.to(torch.int32)
    return slot


def _expert_ffn(buf: torch.Tensor, w1, w3, w2, act: str) -> torch.Tensor:
    """buf [E, C, d] -> [E, C, d_out]."""
    h = torch.bmm(buf, w1)
    u = torch.bmm(buf, w3)
    h = act_fn(act)(h) * u
    return torch.bmm(h, w2)


def moe_ffn_ap(p: dict, x: torch.Tensor, cfg: MoECfg, act: str,
               ctx) -> torch.Tensor:
    """AP-served MoE: router runs in float, then every routed expert's
    SwiGLU projections go through :func:`repro_torch.apc.layers.
    ap_moe_dispatch` as independent tiled-MAC subgraphs of one
    ProgramGraph — tiles of different experts interleave across the array
    bank.  Expert weights ternarize (absmean per-channel) via the
    context's per-stack cache.  No capacity drop: every routed pair is
    served."""
    from ..apc.layers import ap_moe_dispatch
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, experts = _route(x2d, p["router"], cfg)
    w1l = ctx.expert_linears("moe.w1", p["w1"], label="moe.w1.")
    w3l = ctx.expert_linears("moe.w3", p["w3"], label="moe.w3.")
    w2l = ctx.expert_linears("moe.w2", p["w2"], label="moe.w2.")
    y2d = ap_moe_dispatch(ctx, x2d, experts, gates, w1l, w3l, w2l,
                          act_fn(act))
    return y2d.reshape(b, s, d).to(x.dtype)


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoECfg, act: str
            ) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: route, dispatch at capacity
    ``max(8, int(T*k*cf/E))``, run the experts, combine (on the AP inside
    ``ap_serving``)."""
    from ..apc.layers import current_ap_context
    ctx = current_ap_context()
    if ctx is not None:                      # AP-backed serving path
        return moe_ffn_ap(p, x, cfg, act, ctx)
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, experts = _route(x2d, p["router"], cfg)
    e = cfg.n_experts
    capacity = max(8, int(t * cfg.top_k * cfg.capacity_factor / e))
    slot = _dispatch_indices(experts, e, capacity).long()
    # scatter tokens (duplicated per k) into the capacity buffer; every
    # dropped pair lands on the extra last row, which is discarded
    buf = torch.zeros((e * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = torch.repeat_interleave(x2d, cfg.top_k, dim=0)
    out_buf = _expert_ffn(buf[:-1].reshape(e, capacity, d),
                          p["w1"], p["w3"], p["w2"], act)
    out_flat = torch.cat([out_buf.reshape(e * capacity, d),
                          out_buf.new_zeros((1, d))], 0)
    yk = out_flat[slot]                          # [T*k, d], 0 if dropped
    yk = yk * gates.reshape(-1, 1).to(yk.dtype)
    return yk.reshape(t, cfg.top_k, d).sum(dim=1).reshape(b, s, d)
