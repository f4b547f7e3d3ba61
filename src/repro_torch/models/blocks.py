"""Decoder/encoder block assembly: pre-norm mixer + pre-norm FFN.

A block is parameterized by (mixer_kind, ffn_kind):
  mixer: "attn" (full causal) | "local" (sliding window) | "mamba"
  ffn:   "mlp" | "moe" | "none"
Encoder blocks use bidirectional attention; decoder blocks of enc-dec models
additionally carry a cross-attention sub-block.

Every function here is the one implementation of its layer: it runs one
rank's shards (``p``, placed by ``specs``) under a
:class:`~.collectives.Plan`.  With the defaults (:data:`~.collectives.
LOCAL`, :data:`~.collectives.WHOLE`) every collective of the plan is the
identity and the code is the single-device layer.  On a named mesh
:func:`repro_torch.models.model.forward` / ``decode_step`` run the whole
pass as one per-rank body under ``local_map`` (the analogue of the
reference's forward under ``shard_map``), every collective written out,
FSDP("data") x TP("model"):

  * every weight sharded over "data" is gathered before its use (its
    grads reduce-scattered), as FSDP does;
  * column-parallel products (wq/wk/wv, w1/w3, the logits) keep their
    "model" slice, row-parallel ones (wo, w2) sum their partial product
    over "model" (Megatron's TP); attention runs on this rank's heads;
    under the ternary route w2 is gathered whole, so each column's absmean
    scale covers all of d_ff, and each rank keeps its rows of the
    fake-quantized weight;
  * where heads do not divide "model" the attention weights are gathered
    whole and every model rank computes all heads; GQA kv heads that do
    not divide are gathered and each rank takes those its q heads read;
    under ``attn_batch_split`` each model rank attends over its slice of
    the batch instead (the reference's resharding of q, k and v);
  * the Mamba mixer runs with its weights whole: its input projection's
    output concatenates z, x, B, C and dt, so a column split over "model"
    would cut across them;
  * the MoE runs :func:`.moe.moe_local`;
  * a decode cache is placed as the reference's dry-run places it
    (:func:`.sharded.cache_specs`): where its positions are split (a batch
    the data axes do not divide, kv heads that "model" does not), each
    rank attends over its slice and the softmax is combined across the
    slices (flash-decoding); a split SSM state is gathered for the step.

Grads follow :mod:`.collectives`: an input replicated over an axis that
its use varies on takes its grads summed over that axis (a weight over
the data axes, whose tokens differ; the layer input over "model" before a
column-parallel product).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..apc import trace
from ..configs.base import ModelConfig
from . import attention as attn
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .collectives import (LOCAL, WHOLE, GatherOutput, GatherWeight, Plan,
                          all_reduce, axis_names, gather, on_model)
from .common import MODEL_AXIS, is_named_mesh, rms_norm, unread_dot

DENSE_ATTN_MAX = 512        # below this, skip blockwise machinery


def init_block(gen: torch.Generator, cfg: ModelConfig, mixer_kind: str,
               ffn_kind: str, cross: bool = False,
               dtype=torch.float32) -> dict:
    dev = gen.device
    p: dict = {"norm1": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
               "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
    if mixer_kind == "mamba":
        p["mamba"] = ssm_mod.init_mamba(gen, cfg.d_model, cfg.ssm, dtype)
    else:
        p["attn"] = attn.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            cfg.qk_norm, cfg.qkv_bias, dtype)
    if ffn_kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, cfg.d_model, cfg.moe, dtype)
        if cfg.moe.shared_d_ff:             # granite's shared expert
            p["mlp"] = mlp_mod.init_mlp(gen, cfg.d_model,
                                        cfg.moe.shared_d_ff, dtype)
    elif ffn_kind == "mlp":
        p["mlp"] = mlp_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    else:                                   # "none": mixer-only block (mamba2)
        p.pop("norm2")
    if cross:
        p["cross"] = attn.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            False, False, dtype)
        p["norm_cross"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    return p


def _rope_theta(cfg: ModelConfig, mixer_kind: str) -> float:
    if mixer_kind == "attn" and getattr(cfg, "rope_theta_global", 0.0):
        return cfg.rope_theta_global
    return cfg.rope_theta


def _attn_scale(cfg: ModelConfig) -> float | None:
    """The score scale: ``attention_multiplier`` where the configuration
    sets one, else None (the attention functions' ``hd ** -0.5``)."""
    return cfg.attention_multiplier or None


def _residual(x: torch.Tensor, y: torch.Tensor, cfg: ModelConfig):
    """x + y, the sub-block's output ``y`` first scaled by
    ``residual_multiplier`` where it is not 1."""
    if cfg.residual_multiplier != 1.0:
        y = y * cfg.residual_multiplier
    return x + y


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _attention(pa, sa, h, cfg: ModelConfig, plan: Plan, positions, theta,
               causal: bool, window: int, tail: bool, kv_src=None,
               use_rope: bool = True, dense: bool = False,
               scale: float | None = None):
    """Self-attention (cross-attention from ``kv_src``) on this rank's
    heads or batch slice; ``wo``'s partial product summed over "model"
    when the heads are split."""
    b, s, _ = h.shape
    heads = (not plan.batch_split and plan.split(sa["wq"])
             and cfg.n_heads % plan.tp == 0)
    kv_heads = heads and cfg.n_kv_heads % plan.tp == 0 and on_model(sa["wk"])
    bsplit = plan.batch_split and s > 1
    varying = heads or bsplit           # q, k, v differ over "model"
    src = h if kv_src is None else kv_src
    if varying:
        h = plan.sum_grad(h, (MODEL_AXIS,))
        src = h if kv_src is None else plan.sum_grad(src, (MODEL_AXIS,))
    # k/v: column-parallel where their columns are split over "model";
    # where the kv heads do not divide it, the columns are gathered after
    # the product (each rank then takes the heads its q heads read)
    kv_cols = varying and not bsplit and on_model(sa["wk"])
    pe = {}
    for name in ("wq", "bq"):
        if name in pa:
            pe[name] = plan.full(pa[name], sa[name], gather_model=not heads,
                                 model_reduce=bsplit)
    for name in ("wk", "wv", "bk", "bv"):
        if name in pa:
            pe[name] = plan.full(pa[name], sa[name],
                                 gather_model=not kv_cols,
                                 model_reduce=varying, model_varying=varying)
    for name in ("q_norm", "k_norm"):
        if name in pa:
            pe[name] = plan.full(pa[name], sa[name], model_varying=varying)
    hq = cfg.n_heads // (plan.tp if heads else 1)
    hk = cfg.n_kv_heads // (plan.tp if kv_heads else 1)
    hd, ks = cfg.head_dim_, src.shape[1]
    q = h @ pe["wq"]
    k = src @ pe["wk"]
    v = src @ pe["wv"]
    if "bq" in pe:
        q, k, v = q + pe["bq"], k + pe["bk"], v + pe["bv"]
    if kv_cols and not kv_heads:
        g = plan.group(MODEL_AXIS)
        k, v = (GatherWeight.apply(t, g, 2, True) for t in (k, v))
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, ks, hk, hd)
    v = v.reshape(b, ks, hk, hd)
    if "q_norm" in pe:
        q = rms_norm(q, pe["q_norm"], cfg.norm_eps)
        k = rms_norm(k, pe["k_norm"], cfg.norm_eps)
    if use_rope:
        q = attn.apply_rope(q, positions, theta)
        k = attn.apply_rope(k, positions, theta)
    if heads and not kv_heads:               # the kv this rank's q heads read
        n_rep = cfg.n_heads // cfg.n_kv_heads
        r = plan.rank(MODEL_AXIS)
        k = attn._repeat_kv(k, n_rep)[:, :, r * hq:(r + 1) * hq]
        v = attn._repeat_kv(v, n_rep)[:, :, r * hq:(r + 1) * hq]
    if bsplit:                               # this rank's slice of the batch
        q, k, v = (plan.mine(t, 0) for t in (q, k, v))
    if dense or s <= DENSE_ATTN_MAX:
        o = attn.attend_dense(q, k, v, causal=causal, window=window,
                              scale=scale)
    else:
        o = attn.attend_blockwise(q, k, v, causal=causal, window=window,
                                  scale=scale)
    if bsplit:
        o = GatherOutput.apply(o, plan.group(MODEL_AXIS), 0)
    wo = plan.full(pa["wo"], sa["wo"], gather_model=not heads)
    with unread_dot(tail):
        y = o.reshape(b, s, -1) @ wo
    return plan.psum_model(y) if heads else y


def _mlp(pm, sm, h, cfg: ModelConfig, plan: Plan, tail: bool):
    """SwiGLU (packed, AP-served, ternary or QAT: :func:`.mlp.mlp`), its
    d_ff split over "model" where ``sm`` splits it in both ``w1`` and
    ``w2`` (or the packed ``w1_packed`` and ``w2_packed``: each rank's
    down projection is then a partial sum, which ``w2_scale``, per output
    column, leaves exact); where only ``w1``'s is (``w2_packed``'s d_ff/16
    words do not divide "model"), every leaf is gathered whole.  On the
    AP inside ``ap_serving`` on a mesh, every rank runs the whole
    projection (:meth:`~.collectives.Plan.whole`)."""
    from ..apc.layers import current_ap_context
    packed = "w1_packed" in pm
    if plan.mesh is not None and packed \
            and current_ap_context() is not None:
        return plan.whole(lambda pw, x: mlp_mod.mlp(pw, x, cfg.act), pm,
                          sm, h)
    split = (plan.split(sm["w1_packed" if packed else "w1"])
             and plan.split(sm["w2_packed" if packed else "w2"]))
    if split:
        h = plan.sum_grad(h, (MODEL_AXIS,))
    ternary = cfg.ternary.enabled or cfg.ternary.qat
    whole_w2 = split and ternary and not packed
    pe = {k: plan.full(w, sm[k],
                       gather_model=not split or (whole_w2 and k == "w2"),
                       model_reduce=split) for k, w in pm.items()}
    y = mlp_mod.mlp(pe, h, cfg.act, ternary=ternary, qat=cfg.ternary.qat,
                    tail=tail,
                    w2_rows=(lambda w: plan.mine(w, 0)) if whole_w2 else None)
    return plan.psum_model(y) if split else y


def _mamba(pm, sm, h, cfg: ModelConfig, plan: Plan, tail: bool):
    pe = {k: plan.full(pm[k], sm[k], gather_model=True) for k in pm}
    return ssm_mod.mamba_forward(pe, h, cfg.ssm, cfg.d_model, cfg.norm_eps,
                                 tail=tail)


def _ffn(p, sp, h, cfg: ModelConfig, plan: Plan, ffn_kind: str,
         tail: bool = False, layer: int = 0):
    """The FFN sub-block; an MoE one as a ``model.moe`` span, its shared
    expert (the block's ``mlp``, granite's) added to the routed experts'
    output."""
    if ffn_kind != "moe":
        return _mlp(p["mlp"], sp["mlp"], h, cfg, plan, tail)
    with trace.span("model.moe", cat="model", layer=layer,
                    tokens=h.shape[0] * h.shape[1]):
        y = moe_mod.moe_local(p["moe"], sp["moe"], h, cfg.moe, cfg.act,
                              plan)
        if "mlp" in p:
            y = y + _mlp(p["mlp"], sp["mlp"], h, cfg, plan, tail)
        return y


def _no_named_mesh(mesh) -> None:
    """``mesh`` is None or a list of devices.  A named mesh runs a whole
    pass (:func:`repro_torch.models.model.forward` / ``decode_step``),
    whose per-rank body hands each block its ``plan`` and ``specs``."""
    if is_named_mesh(mesh):
        raise ValueError("a named mesh runs through models.model.forward / "
                         "decode_step, which pass plan= and specs=")


def block_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  mixer_kind: str, ffn_kind: str, positions,
                  causal: bool = True,
                  enc_out: torch.Tensor | None = None, *, mesh=None,
                  plan: Plan = LOCAL, specs=WHOLE,
                  tail: bool = False, layer: int = 0) -> torch.Tensor:
    """Pre-norm mixer (+ cross-attention) + pre-norm FFN on this rank's
    shards (``p`` placed by ``specs``; one device by default, ``mesh``
    None or a list).  ``tail``: this is the last layer of a super-block,
    so its last projection feeds only the block's output (remat "dots"
    recomputes it).  ``layer``: the block's index in the stack, for its
    spans."""
    _no_named_mesh(mesh)
    sp = specs
    h = rms_norm(x, plan.full(p["norm1"], sp["norm1"]), cfg.norm_eps)
    mixer_tail = tail and ffn_kind == "none"
    if mixer_kind == "mamba":
        with trace.span("model.mamba", cat="model", layer=layer,
                        tokens=h.shape[0] * h.shape[1], phase="prefill"):
            y = _mamba(p["mamba"], sp["mamba"], h, cfg, plan, mixer_tail)
        x = _residual(x, y, cfg)
    else:
        window = cfg.sliding_window if mixer_kind == "local" else 0
        x = _residual(x, _attention(
            p["attn"], sp["attn"], h, cfg, plan, positions,
            _rope_theta(cfg, mixer_kind), causal, window, mixer_tail,
            use_rope=cfg.use_rope, scale=_attn_scale(cfg)), cfg)
    if enc_out is not None and "cross" in p:
        h = rms_norm(x, plan.full(p["norm_cross"], sp["norm_cross"]),
                     cfg.norm_eps)
        x = x + _attention(p["cross"], sp["cross"], h, cfg, plan, positions,
                           cfg.rope_theta, False, 0, False, kv_src=enc_out,
                           use_rope=False, dense=True)
    if ffn_kind == "none":
        return x
    h = rms_norm(x, plan.full(p["norm2"], sp["norm2"]), cfg.norm_eps)
    return _residual(x, _ffn(p, sp, h, cfg, plan, ffn_kind, tail, layer),
                     cfg)


# ---------------------------------------------------------------------------
# Cache init / decode
# ---------------------------------------------------------------------------

def cache_length(cfg: ModelConfig, mixer_kind: str, seq_len: int) -> int:
    if mixer_kind == "local" and cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_block_cache(cfg: ModelConfig, mixer_kind: str, batch: int,
                     seq_len: int, cross_len: int = 0,
                     dtype=torch.bfloat16, device=None) -> dict:
    c: dict = {}
    if mixer_kind == "mamba":
        c["mamba"] = ssm_mod.init_mamba_cache(batch, cfg.d_model, cfg.ssm,
                                              device=device)
    else:
        c["kv"] = attn.init_kv_cache(
            batch, cfg.n_kv_heads, cfg.head_dim_,
            cache_length(cfg, mixer_kind, seq_len), dtype, device)
    if cross_len:
        c["cross_kv"] = attn.init_kv_cache(
            batch, cfg.n_kv_heads, cfg.head_dim_, cross_len, dtype, device)
    return c


def _shard_index(plan: Plan, axes) -> tuple[int, int]:
    """(this rank's index, the count) of the shards of a dim split over
    ``axes`` (the first axis the major one, as DTensor orders them)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * plan.sizes[a] + plan.rank(a)
        n *= plan.sizes[a]
    return idx, n


def _attend_seq_split(q, kv: dict, pos: int, ring: bool, offset: int,
                      length: int, plan: Plan, axes,
                      scale: float | None = None):
    """q [B, 1, H, hd] against this rank's slice of the cache positions
    (``offset`` on, of ``length``): the softmax's max, sum and weighted
    values combined over ``axes`` (flash-decoding), in fp32; scores
    scaled by ``scale`` (None: hd ** -0.5)."""
    k, v = kv["k"], kv["v"]
    n_rep = q.shape[2] // k.shape[2]
    k, v = attn._repeat_kv(k, n_rep), attn._repeat_kv(v, n_rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    sc = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                      k.to(torch.float32)) * scale
    valid = min(pos + 1, length) if ring else pos + 1
    idx = offset + torch.arange(k.shape[1], device=q.device)
    sc = sc.masked_fill(idx >= valid, attn.NEG_INF)
    m = sc.amax(-1, keepdim=True)
    for a in axes:
        m = all_reduce(m, plan.group(a), dist.ReduceOp.MAX)
    pr = torch.exp(sc - m)
    den = pr.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", pr, v.to(torch.float32))
    for a in axes:
        den = all_reduce(den, plan.group(a))
        acc = all_reduce(acc, plan.group(a))
    return (acc / den.permute(0, 2, 1, 3)).to(q.dtype)


def _decode_attention(pa, sa, h, kv: dict, kv_spec, cfg: ModelConfig,
                      plan: Plan, pos: int, theta, ring: bool,
                      write: bool = True, use_rope: bool = True):
    """One token's attention against this rank's cache shard, placed by
    ``kv_spec``: kv heads over "model" (this rank's q heads read them), or
    positions over the axes of dim 1 (each rank attends over its slice,
    the softmax combined over them), or whole.  The token's k/v are
    written in place first (by the rank that holds its slot) unless
    ``write`` is off: the cross-attention cache."""
    heads = MODEL_AXIS in axis_names(kv_spec[2])
    seq_axes = axis_names(kv_spec[1])
    b = h.shape[0]

    def mine(name, t, dim):
        """This rank's heads of a product whose weight is whole over
        "model" (the cross-attention's weights are replicated)."""
        return plan.mine(t, dim) if heads and not on_model(sa[name]) else t

    pe = {n: plan.full(pa[n], sa[n], gather_model=not heads)
          for n in ("wq", "bq", "q_norm", "wk", "wv", "bk", "bv", "k_norm")
          if n in pa}
    hd = cfg.head_dim_
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=h.device)
    q = h @ pe["wq"]
    if "bq" in pe:
        q = q + pe["bq"]
    q = mine("wq", q.reshape(b, 1, -1, hd), 2)
    if "q_norm" in pe:
        q = rms_norm(q, pe["q_norm"], cfg.norm_eps)
    if use_rope:
        q = attn.apply_rope(q, positions, theta)
    local_len = kv["k"].shape[1]
    idx, n = _shard_index(plan, seq_axes)
    length = local_len * n
    if write:
        k = h @ pe["wk"]
        v = h @ pe["wv"]
        if "bk" in pe:
            k, v = k + pe["bk"], v + pe["bv"]
        k = mine("wk", k.reshape(b, 1, -1, hd), 2)
        v = mine("wv", v.reshape(b, 1, -1, hd), 2)
        if "k_norm" in pe:
            k = rms_norm(k, pe["k_norm"], cfg.norm_eps)
        if use_rope:
            k = attn.apply_rope(k, positions, theta)
        slot = pos % length if ring else min(pos, length - 1)
        if slot // local_len == idx:         # this rank holds the slot
            kv["k"][:, slot % local_len] = k[:, 0].to(kv["k"].dtype)
            kv["v"][:, slot % local_len] = v[:, 0].to(kv["v"].dtype)
    scale = _attn_scale(cfg)
    if seq_axes:
        o = _attend_seq_split(q, kv, pos, ring, idx * local_len, length,
                              plan, seq_axes, scale=scale)
    else:
        o = attn.attend_decode(q, kv, pos, ring=ring, scale=scale)
    wo = mine("wo", plan.full(pa["wo"], sa["wo"], gather_model=not heads), 0)
    y = o.reshape(b, 1, -1) @ wo
    return plan.psum_model(y) if heads else y


def _mamba_decode(pm, sm, h, state: dict, st_spec, cfg: ModelConfig,
                  plan: Plan):
    """One Mamba step, the weights whole; a state split over "model" is
    gathered for the step and this rank's part written back."""
    pe = {k: plan.full(v, sm[k], gather_model=True) for k, v in pm.items()}
    split = {k: next((d for d, ax in enumerate(st_spec[k])
                      if MODEL_AXIS in axis_names(ax)), None)
             for k in state} if plan.tp > 1 else {k: None for k in state}
    full = {k: t if split[k] is None else
            gather(t, plan.group(MODEL_AXIS), split[k])
            for k, t in state.items()}
    o, new = ssm_mod.mamba_decode_step(pe, h, full, cfg.ssm, cfg.d_model,
                                       cfg.norm_eps)
    for k, val in new.items():
        if split[k] is not None:
            val = plan.mine(val, split[k])
        state[k].copy_(val)
    return o


def block_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                 mixer_kind: str, ffn_kind: str, pos: int, *, mesh=None,
                 plan: Plan = LOCAL, specs=WHOLE,
                 cache_specs=WHOLE, layer: int = 0) -> torch.Tensor:
    """One-token step.  x [B, 1, d]; ``pos`` an int.  Writes this token's
    state into ``cache`` (this rank's shard, placed by ``cache_specs``) in
    place.  ``layer``: the block's index in the stack, for its spans."""
    _no_named_mesh(mesh)
    sp, cs = specs, cache_specs
    h = rms_norm(x, plan.full(p["norm1"], sp["norm1"]), cfg.norm_eps)
    if mixer_kind == "mamba":
        with trace.span("model.mamba", cat="model", layer=layer,
                        tokens=h.shape[0], phase="decode"):
            y = _mamba_decode(p["mamba"], sp["mamba"], h, cache["mamba"],
                              cs["mamba"], cfg, plan)
        x = _residual(x, y, cfg)
    else:
        x = _residual(x, _decode_attention(
            p["attn"], sp["attn"], h, cache["kv"], cs["kv"]["k"], cfg, plan,
            pos, _rope_theta(cfg, mixer_kind), ring=mixer_kind == "local",
            use_rope=cfg.use_rope), cfg)
    if "cross_kv" in cache and "cross" in p:
        h = rms_norm(x, plan.full(p["norm_cross"], sp["norm_cross"]),
                     cfg.norm_eps)
        clen = cache["cross_kv"]["k"].shape[1] * _shard_index(
            plan, axis_names(cs["cross_kv"]["k"][1]))[1]
        x = x + _decode_attention(p["cross"], sp["cross"], h,
                                  cache["cross_kv"], cs["cross_kv"]["k"],
                                  cfg, plan, clen - 1, cfg.rope_theta,
                                  ring=False, write=False, use_rope=False)
    if ffn_kind == "none":
        return x
    h = rms_norm(x, plan.full(p["norm2"], sp["norm2"]), cfg.norm_eps)
    return _residual(x, _ffn(p, sp, h, cfg, plan, ffn_kind, layer=layer),
                     cfg)
