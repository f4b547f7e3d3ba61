"""Attention: GQA with qk-norm / qkv-bias / sliding-window / cross-attn.

Three execution paths, as the reference's:
  * ``attend_blockwise`` — flash-style online softmax over KV blocks (a
    Python loop over q blocks and k blocks) so a long prefill never
    materializes an [S, S] score tensor.
  * ``attend_decode`` — one new token against a KV cache (ring buffer for
    sliding-window layers, linear buffer for global layers), in fp32: on
    the card, bf16 or fp16 queries read the cache as it lies through the
    decode-attention kernel; every other call takes the einsum path.
  * dense path for short sequences (S <= 512) where blocking is overhead.

Weights layout: wq [d, H*hd], wk/wv [d, Hk*hd], wo [H*hd, d].  The
reference has no Pallas kernel here, so every other path is plain torch.
"""
from __future__ import annotations

import torch

from ..apc.metrics import get_registry
from ..kernels.decode_attention import kernel as decode_kernel
from .common import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, qk_norm: bool,
                   qkv_bias: bool, dtype=torch.float32) -> dict:
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), 0, dtype),
        "wk": dense_init(gen, (d_model, n_kv_heads * head_dim), 0, dtype),
        "wv": dense_init(gen, (d_model, n_kv_heads * head_dim), 0, dtype),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), 0, dtype),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=dev)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), dtype=dtype,
                              device=dev)
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype, device=dev)
    return p


def project_qkv(p: dict, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                head_dim: int, positions: torch.Tensor, rope_theta: float,
                norm_eps: float, use_rope: bool = True):
    """x [B, S, d] -> q [B, S, H, hd], k/v [B, S, Hk, hd] (rope applied)."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv_heads, head_dim)
    v = v.reshape(b, s, n_kv_heads, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], norm_eps)
        k = rms_norm(k, p["k_norm"], norm_eps)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, hk, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, hk, n_rep, hd).reshape(
        b, s, hk * n_rep, hd)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


# ---------------------------------------------------------------------------
# Dense path (short sequences / smoke tests / cross-attention)
# ---------------------------------------------------------------------------

def attend_dense(q, k, v, causal: bool, window: int = 0,
                 q_offset: int = 0, scale: float | None = None
                 ) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,Hk,hd] -> [B,Sq,H,hd]; scores scaled by
    ``scale`` (None: hd ** -0.5)."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = _mask(qpos, kpos, causal, window)
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores.to(torch.float32), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) path for long prefill
# ---------------------------------------------------------------------------

def attend_blockwise(q, k, v, causal: bool = True, window: int = 0,
                     block_q: int = 1024, block_k: int = 1024,
                     scale: float | None = None) -> torch.Tensor:
    """Online-softmax attention; never materializes [Sq, Sk].  Scores
    scaled by ``scale`` (None: hd ** -0.5).

    Requires Sq % block_q == Sk % block_k == 0 (configs keep shapes aligned).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sq % block_q or sk % block_k:
        raise ValueError(f"attend_blockwise: Sq={sq} / Sk={sk} not "
                         f"multiples of blocks {block_q} / {block_k}")
    n_rep = h // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if scale is None:
        scale = hd ** -0.5
    dev = q.device
    outs = []
    for qi in range(sq // block_q):
        q_blk = q[:, qi * block_q:(qi + 1) * block_q]
        qpos = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((b, h, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, block_q, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(sk // block_k):
            k_blk = k[:, ki * block_k:(ki + 1) * block_k]
            v_blk = v[:, ki * block_k:(ki + 1) * block_k]
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk) * scale
            kpos = ki * block_k + torch.arange(block_k, device=dev)
            mask = _mask(qpos, kpos, causal, window)
            s = s.to(torch.float32).masked_fill(~mask[None, None], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, v_blk.to(torch.float32))
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))                   # [b,bq,h,hd]
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode path (KV cache)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, n_kv_heads: int, head_dim: int, length: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    shape = (batch, length, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_update_cache(cache: dict, k_new: torch.Tensor,
                        v_new: torch.Tensor, pos: int, ring: bool) -> dict:
    """Write one token's k/v at position ``pos`` (mod length if ring; a
    linear cache clamps to its last slot), in place; returns ``cache``."""
    length = cache["k"].shape[1]
    slot = pos % length if ring else min(pos, length - 1)
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    return cache


def attend_decode(q, cache: dict, pos: int, ring: bool,
                  scale: float | None = None) -> torch.Tensor:
    """q [B,1,H,hd] against the cache, in fp32; masks unwritten slots;
    scores scaled by ``scale`` (None: hd ** -0.5, as the kernel's own
    default).

    The cache's first ``min(pos + 1, length)`` slots are the written ones,
    ring or linear.  A call the decode-attention kernel takes
    (``kernels.decode_attention.supports``: bf16 or fp16 q on the card, the
    cache in its dtype) reads only those, each once for all of its kv
    head's query heads, and counts in the kernel's ``launch_counts``; every
    other call (fp32 queries, the AP route's among them, and the CPU) takes
    the einsum path, which expands the kv heads and masks the rest, and
    counts in the registry's ``attn.decode.einsum``."""
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    if decode_kernel.supports(q, k, v):
        return decode_kernel.decode_attention(q, k, v, min(pos + 1, length),
                                              scale=scale)
    get_registry().counter("attn.decode.einsum").inc()
    return _attend_decode_einsum(q, k, v, pos, ring, scale)


def _attend_decode_einsum(q, k, v, pos: int, ring: bool,
                          scale: float | None = None) -> torch.Tensor:
    """The einsum path: the kv heads repeated to q's, K and V in fp32 over
    every slot, the unwritten ones masked."""
    length = k.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    valid_len = min(pos + 1, length) if ring else pos + 1
    if valid_len < length:
        s[..., valid_len:] = NEG_INF
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)
