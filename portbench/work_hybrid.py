"""Frozen counts of the work of one model step of the hybrid family
(Granite 4.0-H: Mamba-2 and attention mixers, an MoE FFN with a shared
expert in every layer), from the configuration's shapes alone, priced at
the peaks of :mod:`portbench.work` (989 TFLOP/s bf16, 3.35 TB/s).

Nothing here reads the program.  A step is ``(position, batch)``: ``batch``
sequences each feed one token at ``position``.
"""
from __future__ import annotations

from portbench.work import BF16_FLOPS, HBM_BYTES_PER_S, PACK

_BYTES = {"bfloat16": 2, "float32": 4}
SSM_STATE_BYTES = 4             # the Mamba and conv state are fp32
KV_BYTES = 2                    # the KV cache is bf16


def _mixers(model: dict) -> list[str]:
    pattern = model["layer_pattern"]
    return [pattern[i % len(pattern)] for i in range(model["n_layers"])]


def _mamba_dims(model: dict) -> tuple[int, int, int, int, int, int]:
    """(d_in, heads, state per head N x P, conv channels, conv width,
    input-projection width)."""
    s, d = model["ssm"], model["d_model"]
    d_in = s["expand"] * d
    heads = d_in // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    return (d_in, heads, s["d_state"] * s["head_dim"], d_in + 2 * gn,
            s["conv_width"], 2 * d_in + 2 * gn + heads)


def _attn_weights(model: dict) -> int:
    d, h, hk = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    return 2 * d * h * hd + 2 * d * hk * hd


def token_flops(model: dict, context: int) -> int:
    """Model FLOPs of one token attending over ``context`` positions: every
    projection at 2 FLOPs a weight (the shared expert's ternary ones
    counted dense); the Mamba state update at 3 an element (decay, the
    input's outer product, the add) and its read-out at 2; attention's
    scores and values at 4 x heads x head_dim a position; the router, the
    ``top_k`` routed experts a token and the shared expert; the head.
    Norms, the conv and the embedding lookup are left out."""
    d = model["d_model"]
    h = model["n_heads"]
    hd = model.get("head_dim") or d // h
    m = model["moe"]
    total = 2 * d * model["vocab"]
    for kind in _mixers(model):
        if kind == "mamba":
            d_in, heads, state, _, _, proj = _mamba_dims(model)
            total += 2 * d * proj + 2 * d_in * d + 5 * heads * state
        else:
            total += 2 * _attn_weights(model) + 4 * h * hd * context
        total += 2 * d * m["n_experts"] + m["top_k"] * 6 * d * m["d_ff"] \
            + 6 * d * m.get("shared_d_ff", 0)
    return total


def steps_flops(model: dict, steps) -> int:
    """Sum of :func:`token_flops` over ``steps``, ``(position, batch)``
    pairs."""
    return sum(b * token_flops(model, pos + 1) for pos, b in steps)


def step_bytes(model: dict, pos: int, batch: int) -> int:
    """The bytes one step cannot avoid moving: every weight read once (the
    tied embedding as the head; of the routed experts, ``min(n_experts,
    batch x top_k)``, as many as the step can reach; the shared expert as
    packed 2-bit words and fp32 scales), each Mamba layer's state and conv
    state read and written once, and each attention layer's written keys
    and values read once."""
    d = model["d_model"]
    w = _BYTES[model.get("param_dtype", "float32")]
    m = model["moe"]
    e, f, fs = m["n_experts"], m["d_ff"], m.get("shared_d_ff", 0)
    hk, h = model["n_kv_heads"], model["n_heads"]
    hd = model.get("head_dim") or d // h
    total = (model["vocab"] * d + d) * w
    experts = min(e, batch * m["top_k"])
    shared = 2 * (-(-d // PACK)) * fs * 4 + (-(-fs // PACK)) * d * 4 + \
        (2 * fs + d) * 4 if fs else 0
    for kind in _mixers(model):
        total += 2 * d * w                                  # the two norms
        if kind == "mamba":
            d_in, heads, state, conv_ch, width, proj = _mamba_dims(model)
            total += (d * proj + width * conv_ch + conv_ch + 3 * heads
                      + d_in + d_in * d) * w
            total += 2 * batch * (heads * state + (width - 1) * conv_ch) \
                * SSM_STATE_BYTES
        else:
            total += _attn_weights(model) * w
            total += 2 * batch * (pos + 1) * hk * hd * KV_BYTES
        total += (d * e + experts * 3 * d * f) * w + shared
    return total


def step_seconds(model: dict, pos: int, batch: int) -> float:
    """The least time of one step: its bytes at the HBM rate or its FLOPs
    at the bf16 rate, whichever is longer."""
    return max(step_bytes(model, pos, batch) / HBM_BYTES_PER_S,
               batch * token_flops(model, pos + 1) / BF16_FLOPS)
