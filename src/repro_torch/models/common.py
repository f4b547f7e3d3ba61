"""Shared model primitives: norms, RoPE, inits.

Parameters are plain nested dicts of tensors, in the reference's tree, so
weights carry across by a plain tree walk (:func:`repro_torch.convert.
params_from_arrays`).  The reference's path-based partition rules shard
over a TPU mesh; they go with ``launch/`` (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Params = dict


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Initializers: the reference's distributions, drawn from an explicit
# torch.Generator (the values differ from JAX's; tests carry weights across)
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    fan_in = shape[in_axis] if isinstance(in_axis, int) else 1
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return (_normal(gen, shape) * std).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    return (_normal(gen, shape) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in fp32, returned in x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dt)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh form (torch's default is erf),
    step by step as the reference computes it, each step rounded to x's
    dtype with the constants in it: bit-identical to it in bf16 on the
    CPU, where ``F.gelu(approximate="tanh")`` rounds once and differs in
    the last bit of 45 % of the values."""
    c = float(torch.tensor(0.044715, dtype=x.dtype))
    k = float(torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype))
    return x * (0.5 * (1 + torch.tanh(k * (x + c * (x * x * x)))))


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, hd]; positions [..., S] (broadcastable).  Rotates the
    two halves of hd, not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    angles = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)         # [..., S, 1, hd/2]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
