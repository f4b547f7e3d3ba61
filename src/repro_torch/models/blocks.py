"""Decoder/encoder block assembly: pre-norm mixer + pre-norm FFN.

A block is parameterized by (mixer_kind, ffn_kind):
  mixer: "attn" (full causal) | "local" (sliding window) | "mamba"
  ffn:   "mlp" | "moe" | "none"
Encoder blocks use bidirectional attention; decoder blocks of enc-dec models
additionally carry a cross-attention sub-block.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from . import attention as attn
from . import mlp as mlp_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .common import rms_norm

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


def _mixer_forward(p, x, cfg: ModelConfig, mixer_kind: str, positions,
                   causal: bool) -> torch.Tensor:
    if mixer_kind == "mamba":
        return ssm_mod.mamba_forward(p["mamba"], x, cfg.ssm, cfg.d_model,
                                     cfg.norm_eps)
    window = cfg.sliding_window if mixer_kind == "local" else 0
    q, k, v = attn.project_qkv(
        p["attn"], x, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
        positions, _rope_theta(cfg, mixer_kind), cfg.norm_eps,
        use_rope=cfg.use_rope)
    s = x.shape[1]
    if s <= DENSE_ATTN_MAX:
        o = attn.attend_dense(q, k, v, causal=causal, window=window)
    else:
        o = attn.attend_blockwise(q, k, v, causal=causal, window=window)
    return o.reshape(x.shape[0], s, -1) @ p["attn"]["wo"]


def _ffn_forward(p, x, cfg: ModelConfig, ffn_kind: str) -> torch.Tensor:
    if ffn_kind == "moe":
        return moe_mod.moe_ffn(p["moe"], x, cfg.moe, cfg.act)
    return mlp_mod.mlp(p["mlp"], x, cfg.act,
                       ternary=cfg.ternary.enabled or cfg.ternary.qat,
                       qat=cfg.ternary.qat)


def block_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  mixer_kind: str, ffn_kind: str, positions,
                  causal: bool = True,
                  enc_out: torch.Tensor | None = None) -> torch.Tensor:
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + _mixer_forward(p, h, cfg, mixer_kind, positions, causal)
    if enc_out is not None and "cross" in p:
        h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
        q, _, _ = attn.project_qkv(
            p["cross"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            positions, cfg.rope_theta, cfg.norm_eps, use_rope=False)
        ek = (enc_out @ p["cross"]["wk"]).reshape(
            *enc_out.shape[:2], cfg.n_kv_heads, cfg.head_dim_)
        ev = (enc_out @ p["cross"]["wv"]).reshape(
            *enc_out.shape[:2], cfg.n_kv_heads, cfg.head_dim_)
        o = attn.attend_dense(q, ek, ev, causal=False)
        x = x + o.reshape(*x.shape[:2], -1) @ p["cross"]["wo"]
    if ffn_kind == "none":
        return x
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + _ffn_forward(p, h, cfg, ffn_kind)


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


def block_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                 mixer_kind: str, ffn_kind: str, pos: int) -> torch.Tensor:
    """One-token step.  x [B, 1, d]; ``pos`` an int.  Writes this token's
    state into ``cache`` in place."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if mixer_kind == "mamba":
        o, new = ssm_mod.mamba_decode_step(
            p["mamba"], h, cache["mamba"], cfg.ssm, cfg.d_model, cfg.norm_eps)
        for key, val in new.items():
            cache["mamba"][key].copy_(val)
        x = x + o
    else:
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                               device=x.device)
        q, k, v = attn.project_qkv(
            p["attn"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            positions, _rope_theta(cfg, mixer_kind), cfg.norm_eps,
            use_rope=cfg.use_rope)
        ring = mixer_kind == "local"     # window caches are ring buffers
        attn.decode_update_cache(cache["kv"], k, v, pos, ring=ring)
        o = attn.attend_decode(q, cache["kv"], pos, ring=ring)
        x = x + o.reshape(x.shape[0], 1, -1) @ p["attn"]["wo"]
    if "cross_kv" in cache and "cross" in p:
        h = rms_norm(x, p["norm_cross"], cfg.norm_eps)
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                               device=x.device)
        q, _, _ = attn.project_qkv(
            p["cross"], h, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
            positions, cfg.rope_theta, cfg.norm_eps, use_rope=False)
        clen = cache["cross_kv"]["k"].shape[1]
        o = attn.attend_decode(q, cache["cross_kv"], clen - 1, ring=False)
        x = x + o.reshape(x.shape[0], 1, -1) @ p["cross"]["wo"]
    if ffn_kind != "none":
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + _ffn_forward(p, h, cfg, ffn_kind)
    return x
