"""The test suite's copy of the benchmark's plain reference of the hybrid
family (``portbench/reference/hybrid.py``; ``tests/test_torch_granite.py``
holds the two to the same logits), so that the tests depend on nothing
under ``portbench``.

The plain reference of the hybrid family (Granite 4.0-H): Mamba-2 mixers
and NoPE GQA attention in a repeating layer pattern, an MoE FFN of routed
experts and a shared expert in every layer, and Granite's four scalings;
in plain PyTorch and float32, no kernels, no cache and no batching across
requests.

For a model ``model`` (the configuration's ``model`` block) and weights
``layer_fn(i)`` / ``top`` (flat leaves, as ``portbench.families.hybrid``
makes them), it computes, as the published architecture defines it
(https://huggingface.co/ibm-granite/granite-4.0-h-small, GraniteMoeHybrid):

- the embedding times ``embedding_multiplier``;
- per layer, pre-norm RMSNorm sub-blocks whose outputs are scaled by
  ``residual_multiplier`` before the residual add;
- Mamba-2: the input projection split into z, x|B|C and dt; the causal
  depthwise conv of width ``conv_width`` with its bias, then SiLU; dt =
  softplus(dt + dt_bias), A = -exp(a_log); the recurrence as defined,
  stepped over positions, per head: h_t = exp(dt_t A) h_{t-1} + dt_t B_t
  x_t^T, y_t = C_t . h_t + D x_t; the gated RMSNorm of y * silu(z) over
  the whole inner width (one group) times ``norm``; the output
  projection;
- attention with no position embedding, causal, GQA, scores times
  ``attention_multiplier``; keys and values held in the configuration's
  cache dtype (as served);
- the MoE: the router's top-k logits and a softmax over those k (the
  published gating), a loop over the experts in which each expert's
  SwiGLU runs on the tokens routed to it (none dropped), weighted by its
  gate; plus the shared SwiGLU expert, ternarized per output channel by
  its absmean (BitNet b1.58) with the scale rounded through the compute
  dtype, as it is served packed;
- the final norm and the tied head, logits divided by ``logits_scaling``.

``precision`` computes every product of the projections, the router, the
experts, attention's scores and values and the head from operands rounded
to a lower precision: ``"tf32"`` (10 mantissa bits) or ``"fp8"`` (e4m3
with a per-tensor scale): the controls that the comparison must fail.  The
state recurrence stays in float32.  Imports nothing but PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def _ternarize(w: torch.Tensor, compute_dtype: torch.dtype
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """w [K, N] -> (w_ter in {-1, 0, 1}, scale [N]): absmean per output
    channel, the scale rounded through the compute dtype."""
    w = w.to(torch.float32)
    scale = torch.clamp_min(w.abs().mean(dim=0), 1e-8)
    w_ter = torch.clamp(torch.round(w / scale[None, :]), -1, 1)
    return w_ter, scale.to(compute_dtype).to(torch.float32)


def _swiglu(h, w1, w3, w2, precision):
    return _mm(F.silu(_mm(h, w1, precision)) * _mm(h, w3, precision), w2,
               precision)


def _mamba(p: dict, h: torch.Tensor, model: dict, precision: str):
    ssm = model["ssm"]
    b, s, d = h.shape
    d_in = ssm["expand"] * d
    p_hd, g, n = ssm["head_dim"], ssm["n_groups"], ssm["d_state"]
    heads = d_in // p_hd
    proj = _mm(h, p["in_proj"], precision)
    z = proj[..., :d_in]
    xbc = proj[..., d_in:2 * d_in + 2 * g * n]
    dt = proj[..., 2 * d_in + 2 * g * n:]
    # causal depthwise conv: out[t] = sum_i w[i] x[t - (W - 1) + i]
    w = p["conv_w"].to(torch.float32)
    width = w.shape[0]
    conv = torch.zeros_like(xbc)
    for i in range(width):
        lag = width - 1 - i
        conv[:, lag:] += w[i] * xbc[:, :s - lag]
    if "conv_b" in p:
        conv = conv + p["conv_b"].to(torch.float32)
    xbc = F.silu(conv)
    x = xbc[..., :d_in].reshape(b, s, heads, p_hd)
    rep = heads // g
    bm = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n) \
        .repeat_interleave(rep, dim=2)
    cm = xbc[..., d_in + g * n:].reshape(b, s, g, n) \
        .repeat_interleave(rep, dim=2)
    dt = F.softplus(dt + p["dt_bias"].to(torch.float32))        # [B, S, H]
    a = -torch.exp(p["a_log"].to(torch.float32))                # [H]
    dskip = p["d_skip"].to(torch.float32)
    state = torch.zeros((b, heads, n, p_hd), dtype=torch.float32,
                        device=h.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                         # [B, H]
        state = decay[..., None, None] * state + \
            (dt[:, t, :, None] * bm[:, t])[..., None] * x[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cm[:, t], state)
                  + dskip[:, None] * x[:, t])
    y = torch.stack(ys, dim=1).reshape(b, s, d_in)
    y = _rms(y * F.silu(z), p["norm"], model.get("norm_eps", 1e-6))
    return _mm(y, p["out_proj"], precision)


def _attention(p: dict, h: torch.Tensor, model: dict, kv_dtype, precision):
    b, s, _ = h.shape
    nh, nk = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // nh
    q = _mm(h, p["wq"], precision).reshape(b, s, nh, hd)
    k = _mm(h, p["wk"], precision).reshape(b, s, nk, hd)
    v = _mm(h, p["wv"], precision).reshape(b, s, nk, hd)
    k = k.to(kv_dtype).to(torch.float32).repeat_interleave(nh // nk, dim=2)
    v = v.to(kv_dtype).to(torch.float32).repeat_interleave(nh // nk, dim=2)
    scale = model.get("attention_multiplier") or hd ** -0.5
    sc = torch.einsum("bqhd,bkhd->bhqk", _round(q, precision),
                      _round(k, precision)) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    pr = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", _round(pr, precision),
                     _round(v, precision))
    return _mm(o.reshape(b, s, nh * hd), p["wo"], precision)


def _moe(p: dict, h: torch.Tensor, model: dict, compute_dtype, precision):
    moe = model["moe"]
    b, s, d = h.shape
    h2 = h.reshape(b * s, d)
    logits = _mm(h2, p["router"], precision)                    # [T, E]
    if moe.get("norm_topk", True):
        top, experts = torch.topk(logits, moe["top_k"], dim=-1)
        gates = torch.softmax(top, dim=-1)
    else:
        gates, experts = torch.topk(torch.softmax(logits, dim=-1),
                                    moe["top_k"], dim=-1)
    y = torch.zeros_like(h2)
    for e in range(moe["n_experts"]):
        hit = experts == e                                      # [T, k]
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        gate = (gates * hit).sum(dim=-1)[rows]
        y[rows] += gate[:, None] * _swiglu(h2[rows], p["w1"][e], p["w3"][e],
                                           p["w2"][e], precision)
    if "shared_w1" in p:
        (t1, s1), (t3, s3), (t2, s2) = (
            _ternarize(p[f"shared_{k}"], compute_dtype)
            for k in ("w1", "w3", "w2"))
        a = F.silu(_mm(h2, t1, precision) * s1) * (_mm(h2, t3, precision)
                                                   * s3)
        y = y + _mm(a, t2, precision) * s2
    return y.reshape(b, s, d)


@torch.no_grad()
def logits(model: dict, serve: dict, layer_fn, top: dict,
           tokens: torch.Tensor, first: int,
           precision: str = "fp32") -> torch.Tensor:
    """Logits [B, S - first, V] at positions ``first .. S-1`` of
    ``tokens`` [B, S].  ``layer_fn(i)`` gives layer ``i``'s flat weights
    (made one layer at a time), ``top`` the embedding and final norm;
    ``serve`` the configuration's serving choices (``kv_cache_dtype``)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        if model.get("use_rope", True):
            raise ValueError("the hybrid reference's attention has no "
                             "position embedding (use_rope false)")
        compute = _DTYPES[model.get("compute_dtype", "float32")]
        kv_dtype = _DTYPES[serve.get("kv_cache_dtype", "bfloat16")]
        eps = model.get("norm_eps", 1e-6)
        rm = model.get("residual_multiplier", 1.0)
        pattern = model["layer_pattern"]
        x = top["embed"][tokens].to(torch.float32) * model.get(
            "embedding_multiplier", 1.0)
        for i in range(model["n_layers"]):
            p = layer_fn(i)
            h = _rms(x, p["norm1"], eps)
            if pattern[i % len(pattern)] == "mamba":
                x = x + rm * _mamba(p, h, model, precision)
            else:
                x = x + rm * _attention(p, h, model, kv_dtype, precision)
            x = x + rm * _moe(p, _rms(x, p["norm2"], eps), model, compute,
                              precision)
            del p
        x = _rms(x[:, first:], top["final_norm"], eps)
        head = (top["embed"].T if model.get("tie_embeddings")
                else top["lm_head"])
        return _mm(x, head, precision) / model.get("logits_scaling", 1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def logits_stepwise(model: dict, serve: dict, layer_fn, top: dict,
                    tokens: torch.Tensor, first: int, cache_len: int,
                    precision: str = "fp32") -> torch.Tensor:
    """As :func:`logits`: the family serves on the float route only, where
    no step quantizes its input over the request's rows, so the positions
    taken one at a time through a cache of ``cache_len`` slots give what
    the whole pass gives (the Mamba recurrence is stepped either way)."""
    if tokens.shape[1] > cache_len:
        raise ValueError(f"{tokens.shape[1]} positions, cache of "
                         f"{cache_len}")
    return logits(model, serve, layer_fn, top, tokens, first,
                  precision=precision)
