"""The hybrid family (Granite 4.0-H): Mamba-2 and NoPE attention mixers in
a repeating layer pattern, an MoE FFN with a shared expert in every layer,
and Granite's four scalings.  Layer ``i`` lives at ``stack/pos_{i %
period}`` row ``i // period`` of the program's tree, as the port lays out
a layer pattern; the shared expert is the block's ``mlp`` (so the harness
packs it ternary), the routed experts stay in the served dtype.

Weights: one leaf of one layer from one ``torch.Generator`` on the device,
seeded from ``(seed, leaf, layer)``, in one ``normal_`` call in the
served dtype (as ``portbench.weights`` makes the dense family's), so the
program's stacked tree and the reference's layer-by-layer copy are the
same numbers.  The reference is :mod:`portbench.reference.hybrid`.  Of the
program this module imports only ``repro_torch.configs``, inside
:func:`model_config`.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.hybrid import logits, logits_stepwise

__all__ = ["model_config", "program_tree", "top_params", "layer_params",
           "keeps_layer_weights", "logits", "logits_stepwise",
           "ap_graphs_per_step"]

# a stable number per leaf, so a leaf's draws never depend on which other
# leaves a configuration has
_TAGS = {"embed": 101, "final_norm": 102, "norm1": 110, "norm2": 111,
         "in_proj": 120, "conv_w": 121, "conv_b": 122, "dt_bias": 123,
         "a_log": 124, "d_skip": 125, "norm": 126, "out_proj": 127,
         "wq": 130, "wk": 131, "wv": 132, "wo": 133, "router": 140,
         "w1": 141, "w3": 142, "w2": 143, "shared_w1": 150,
         "shared_w3": 151, "shared_w2": 152}


def model_config(model: dict):
    """The port's ``GraniteConfig`` from the file's ``model``: its ``moe``
    and ``ssm`` blocks as Granite's subclasses, the patterns as tuples."""
    from repro_torch.configs.granite_4_0_h_small import (GraniteConfig,
                                                          GraniteMoECfg,
                                                          GraniteSSMCfg)
    kw = dict(model)
    kw["moe"] = GraniteMoECfg(**kw["moe"])
    kw["ssm"] = GraniteSSMCfg(**kw["ssm"])
    for key in ("layer_pattern", "ffn_pattern"):
        kw[key] = tuple(kw[key])
    return GraniteConfig(**kw)


def _generator(seed: int, tag: str, layer: int, device) -> torch.Generator:
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), _TAGS[tag],
                                 layer + 1])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return g


def _fill(out: torch.Tensor, seed: int, tag: str, layer: int, mean: float,
          std: float) -> torch.Tensor:
    return out.normal_(mean, std,
                       generator=_generator(seed, tag, layer, out.device))


def layer_shapes(model: dict, layer: int) -> dict:
    """``{leaf: (shape, mean, std, path)}`` of layer ``layer``; ``path`` is
    where the leaf lives in the program's tree under its stack position.
    The draws are the configuration file's ``assumed``."""
    d = model["d_model"]
    pattern = model["layer_pattern"]
    out = {"norm1": ((d,), 1.0, 0.05, ("norm1",)),
           "norm2": ((d,), 1.0, 0.05, ("norm2",))}
    if pattern[layer % len(pattern)] == "mamba":
        s = model["ssm"]
        d_in = s["expand"] * d
        heads = d_in // s["head_dim"]
        gn = s["n_groups"] * s["d_state"]
        conv_ch = d_in + 2 * gn
        out.update(
            in_proj=((d, 2 * d_in + 2 * gn + heads), 0.0, d ** -0.5),
            conv_w=((s["conv_width"], conv_ch), 0.0,
                    s["conv_width"] ** -0.5),
            dt_bias=((heads,), -4.0, 1.0), a_log=((heads,), 1.0, 0.5),
            d_skip=((heads,), 1.0, 0.05), norm=((d_in,), 1.0, 0.05),
            out_proj=((d_in, d), 0.0, d_in ** -0.5))
        if s.get("conv_bias"):
            out["conv_b"] = ((conv_ch,), 0.0, 0.02)
        group = "mamba"
    else:
        h, hk = model["n_heads"], model["n_kv_heads"]
        hd = model.get("head_dim") or d // h
        out.update(wq=((d, h * hd), 0.0, d ** -0.5),
                   wk=((d, hk * hd), 0.0, d ** -0.5),
                   wv=((d, hk * hd), 0.0, d ** -0.5),
                   wo=((h * hd, d), 0.0, (h * hd) ** -0.5))
        group = "attn"
    for name in list(out)[2:]:
        out[name] = (*out[name], (group, name))
    m = model["moe"]
    e, f = m["n_experts"], m["d_ff"]
    out.update(router=((d, e), 0.0, d ** -0.5, ("moe", "router")),
               w1=((e, d, f), 0.0, d ** -0.5, ("moe", "w1")),
               w3=((e, d, f), 0.0, d ** -0.5, ("moe", "w3")),
               w2=((e, f, d), 0.0, f ** -0.5, ("moe", "w2")))
    fs = m.get("shared_d_ff", 0)
    if fs:
        out.update(shared_w1=((d, fs), 0.0, d ** -0.5, ("mlp", "w1")),
                   shared_w3=((d, fs), 0.0, d ** -0.5, ("mlp", "w3")),
                   shared_w2=((fs, d), 0.0, fs ** -0.5, ("mlp", "w2")))
    return out


def top_shapes(model: dict) -> dict:
    """The tied embedding and the final norm.  The embedding's std is
    0.16 / sqrt(d_model) (0.0025 at 4096): with the head tied and the
    input times ``embedding_multiplier``, a token's own row would outweigh
    the layers' work in its logits unless 12 x std x sqrt(d_model) stays
    near the residual stream's spread (about 1); at 0.02 every greedy
    token repeated its input, and the check could not see the layers."""
    if not model.get("tie_embeddings"):
        raise ValueError("the hybrid family's head is the tied embedding")
    d = model["d_model"]
    return {"embed": ((model["vocab"], d), 0.0, 0.16 * d ** -0.5),
            "final_norm": ((d,), 1.0, 0.05)}


def layer_params(model: dict, seed: int, layer: int, device,
                 dtype: torch.dtype) -> dict:
    """One layer's leaves, flat ``{leaf: tensor}``."""
    return {name: _fill(torch.empty(shape, dtype=dtype, device=device),
                        seed, name, layer, mean, std)
            for name, (shape, mean, std, _) in
            layer_shapes(model, layer).items()}


def top_params(model: dict, seed: int, device, dtype: torch.dtype) -> dict:
    return {name: _fill(torch.empty(shape, dtype=dtype, device=device),
                        seed, name, -1, mean, std)
            for name, (shape, mean, std) in top_shapes(model).items()}


def program_tree(model: dict, seed: int, device,
                 dtype: torch.dtype) -> dict:
    """The same weights in the program's tree: position ``p`` of the
    pattern under ``stack/pos_p``, each leaf stacked over the periods and
    filled layer by layer in place."""
    n, period = model["n_layers"], len(model["layer_pattern"])
    if n % period:
        raise ValueError(f"{n} layers are not whole periods of {period}")
    stack = {}
    for p in range(period):
        pos: dict = {}
        for name, (shape, mean, std, path) in layer_shapes(model, p).items():
            buf = torch.empty((n // period, *shape), dtype=dtype,
                              device=device)
            for sb in range(n // period):
                _fill(buf[sb], seed, name, sb * period + p, mean, std)
            node = pos
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = buf
        stack[f"pos_{p}"] = pos
    top = top_params(model, seed, device, dtype)
    return {"embed": {"table": top["embed"]},
            "final_norm": top["final_norm"], "stack": stack}


def keeps_layer_weights(model: dict) -> bool:
    """Whether the check keeps every layer's weights once made (a smoke
    size), or makes them again for each pass (the published widths)."""
    per_layer = sum(int(np.prod(shape)) for shape, *_ in
                    layer_shapes(model, 0).values())
    return model["n_layers"] * per_layer < 2 ** 28


def ap_graphs_per_step(model: dict) -> int:
    """The family serves on the float route only: no AP graph count."""
    raise NotImplementedError("the hybrid family has no AP route")
