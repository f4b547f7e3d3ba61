"""The plain reference: a decoder-only GQA transformer (Qwen2 / Qwen3) with
balanced-ternary MLPs, in plain PyTorch and float32, no kernels and no
batching across requests: :func:`logits` computes whole sequences,
:func:`logits_stepwise` one position at a time through a cache (the AP
route, whose per-step integer grid the positions must keep).

It follows the published architecture (pre-norm RMSNorm blocks, GQA
attention with optional QKV bias and per-head q/k RMSNorm, rotary
embeddings on the two halves of each head, SwiGLU MLP, tied or untied
head) and the served configuration's stated choices:

- the MLP weights are ternarized per output channel by their absmean
  (BitNet b1.58), the scale rounded through the compute dtype;
- keys and values are held in the configuration's cache dtype;
- on the AP route every MLP projection's input is quantized to the
  signed integer grid ``|x| <= x_levels`` by the absolute maximum over the
  request's sequences at that position (one decode step's input), and the
  integer product is exact.

``precision`` computes every float product (projections, attention's
scores and values, the head) from operands rounded to a lower precision:
``"tf32"`` (10 mantissa bits) or ``"fp8"`` (e4m3 with a per-tensor scale)
- the controls that the comparison must fail.  Imports neither JAX nor
the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..weights import DTYPES


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    t = t.to(torch.float32)
    if precision == "fp32":
        return t
    if precision == "tf32":          # keep 10 mantissa bits, round to nearest
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "fp8":
        s = torch.clamp_min(t.abs().amax() / 448.0, 1e-30)
        return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    raise ValueError(f"precision {precision!r}")


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return _round(a, precision) @ _round(b, precision)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        w.to(torch.float32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, hd] at positions 0..S-1: the two halves rotated."""
    hd, s = x.shape[-1], x.shape[1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32,
                       device=x.device)[:, None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def ternarize(w: torch.Tensor, compute_dtype: torch.dtype
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """w [K, N] -> (w_ter in {-1, 0, 1} as fp32, scale [N] fp32): absmean
    per output channel; the scale as served, rounded through the compute
    dtype."""
    w = w.to(torch.float32)
    scale = torch.clamp_min(w.abs().mean(dim=0), 1e-8)
    w_ter = torch.clamp(torch.round(w / scale[None, :]), -1, 1)
    return w_ter, scale.to(compute_dtype).to(torch.float32)


def _quantize_by_position(x: torch.Tensor, levels: int):
    """x [B, S, K] -> (integers [B, S, K], scale [S]): each position's rows
    (one decode step of the request) on one grid, as the AP route
    quantizes a step's input."""
    s = torch.clamp_min(x.abs().amax(dim=(0, 2)) / levels, 1e-8)
    xi = torch.clamp(torch.round(x / s[None, :, None]), -levels, levels)
    return xi, s


def _ternary_proj(x, w_ter, scale, ap, precision):
    if ap is None:
        return _mm(x, w_ter, precision) * scale
    xi, s = _quantize_by_position(x, ap["x_levels"])
    acc = (xi.to(torch.float64) @ w_ter.to(torch.float64)).to(torch.float32)
    return acc * s[None, :, None] * scale


def _attention(p: dict, h: torch.Tensor, model: dict, kv_dtype, precision):
    b, s, _ = h.shape
    nh, nk = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // nh
    eps = model.get("norm_eps", 1e-6)
    q = _mm(h, p["wq"], precision)
    k = _mm(h, p["wk"], precision)
    v = _mm(h, p["wv"], precision)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (t.reshape(b, s, -1, hd) for t in (q, k, v))
    if "q_norm" in p:
        q, k = _rms(q, p["q_norm"], eps), _rms(k, p["k_norm"], eps)
    theta = model.get("rope_theta", 10000.0)
    q, k = _rope(q, theta), _rope(k, theta)
    k = k.to(kv_dtype).to(torch.float32)
    v = v.to(kv_dtype).to(torch.float32)
    rep = nh // nk
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", _round(q, precision),
                      _round(k, precision)) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", _round(pr, precision),
                     _round(v, precision))
    return _mm(o.reshape(b, s, nh * hd), p["wo"], precision)


def _mlp(p: dict, h: torch.Tensor, model: dict, compute_dtype, ap,
         precision):
    act = {"silu": F.silu}[model.get("act", "silu")]
    t1, s1 = ternarize(p["w1"], compute_dtype)
    t3, s3 = ternarize(p["w3"], compute_dtype)
    g = _ternary_proj(h, t1, s1, ap, precision)
    u = _ternary_proj(h, t3, s3, ap, precision)
    a = act(g) * u
    t2, s2 = ternarize(p["w2"], compute_dtype)
    return _ternary_proj(a, t2, s2, ap, precision)


def _decode_attention(p, h, cache, pos, model, kv_dtype, precision):
    """One position's attention, h [B, 1, d], against a cache of
    ``cache["k"].shape[1]`` slots (those past ``pos`` masked), after
    writing this position's keys and values in the cache's dtype."""
    b = h.shape[0]
    nh, nk = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // nh
    eps = model.get("norm_eps", 1e-6)
    theta = model.get("rope_theta", 10000.0)
    q = _mm(h, p["wq"], precision)
    k = _mm(h, p["wk"], precision)
    v = _mm(h, p["wv"], precision)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (t.reshape(b, 1, -1, hd) for t in (q, k, v))
    if "q_norm" in p:
        q, k = _rms(q, p["q_norm"], eps), _rms(k, p["k_norm"], eps)
    q, k = _rope_at(q, pos, theta), _rope_at(k, pos, theta)
    cache["k"][:, pos] = k[:, 0].to(kv_dtype)
    cache["v"][:, pos] = v[:, 0].to(kv_dtype)
    rep = nh // nk
    kk = cache["k"].repeat_interleave(rep, dim=2).to(torch.float32)
    vv = cache["v"].repeat_interleave(rep, dim=2).to(torch.float32)
    sc = torch.einsum("bqhd,bkhd->bhqk", _round(q, precision),
                      _round(kk, precision)) * hd ** -0.5
    sc[..., pos + 1:] = -1e30
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", _round(pr, precision),
                     _round(vv, precision))
    return _mm(o.reshape(b, 1, nh * hd), p["wo"], precision)


def _rope_at(x: torch.Tensor, pos: int, theta: float) -> torch.Tensor:
    """x [B, 1, H, hd] at position ``pos``."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.full((1, 1, 1), float(pos), dtype=torch.float32,
                     device=x.device) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@torch.no_grad()
def logits_stepwise(model: dict, serve: dict, layer_fn, top: dict,
                    tokens: torch.Tensor, first: int, cache_len: int,
                    precision: str = "fp32") -> torch.Tensor:
    """As :func:`logits`, one position at a time through a key/value cache
    of ``cache_len`` slots: the AP route quantizes each step's input over
    the request's rows at that position, so the reference takes the
    positions as the served decode does, and its fp32 products have the
    same shapes (a whole-sequence pass rounds them otherwise, and a
    rounding that crosses the integer grid moves a logit by far more than
    the rounding)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        compute = DTYPES[model.get("compute_dtype", "float32")]
        kv_dtype = DTYPES[serve.get("kv_cache_dtype", "bfloat16")]
        ap = serve if serve.get("route") == "ap" else None
        eps = model.get("norm_eps", 1e-6)
        b, s = tokens.shape
        nk = model["n_kv_heads"]
        hd = model.get("head_dim") or model["d_model"] // model["n_heads"]
        layers = [{k: v.to(torch.float32) for k, v in layer_fn(i).items()}
                  for i in range(model["n_layers"])]
        caches = [{n: torch.zeros((b, cache_len, nk, hd), dtype=kv_dtype,
                                  device=tokens.device) for n in "kv"}
                  for _ in layers]
        head = (top["embed"].T if model.get("tie_embeddings")
                else top["lm_head"]).to(torch.float32)
        out = []
        for pos in range(s):
            x = top["embed"][tokens[:, pos]].to(torch.float32)[:, None, :]
            for p, cache in zip(layers, caches):
                x = x + _decode_attention(p, _rms(x, p["norm1"], eps), cache,
                                          pos, model, kv_dtype, precision)
                x = x + _mlp(p, _rms(x, p["norm2"], eps), model, compute,
                             ap, precision)
            if pos >= first:
                out.append(_mm(_rms(x[:, 0], top["final_norm"], eps), head,
                               precision))
        return torch.stack(out, dim=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def logits(model: dict, serve: dict, layer_fn, top: dict,
           tokens: torch.Tensor, first: int,
           precision: str = "fp32") -> torch.Tensor:
    """Logits [B, S - first, V] at positions ``first .. S-1`` of
    ``tokens`` [B, S].  ``layer_fn(i)`` gives layer ``i``'s flat weights
    (the reference makes them one layer at a time), ``top`` the embedding,
    final norm and head; ``serve`` the configuration's serving choices
    (``route``, ``x_levels``, ``kv_cache_dtype``)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        compute = DTYPES[model.get("compute_dtype", "float32")]
        kv_dtype = DTYPES[serve.get("kv_cache_dtype", "bfloat16")]
        ap = serve if serve.get("route") == "ap" else None
        eps = model.get("norm_eps", 1e-6)
        x = top["embed"][tokens].to(torch.float32)
        for i in range(model["n_layers"]):
            p = {k: v.to(torch.float32) for k, v in layer_fn(i).items()}
            x = x + _attention(p, _rms(x, p["norm1"], eps), model, kv_dtype,
                               precision)
            x = x + _mlp(p, _rms(x, p["norm2"], eps), model, compute, ap,
                         precision)
            del p
        x = _rms(x[:, first:], top["final_norm"], eps)
        head = (top["embed"].T if model.get("tie_embeddings")
                else top["lm_head"])
        return _mm(x, head.to(torch.float32), precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
