"""Seeded weights of a configuration, made on the device.

One leaf of one layer comes from one ``torch.Generator`` on the device,
seeded from ``(seed, leaf, layer)``, in one ``normal_`` call in the type the
weights are served in.  So the program's stacked tree and the plain
reference's layer-by-layer copy are the same numbers: the reference makes
its own weights again from the seed, one layer at a time, and takes none
of the program's.  Imports neither the program nor JAX.
"""
from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# leaf tags: a stable number per leaf, so a leaf's draws never depend on
# which other leaves a configuration has
_TAGS = {"embed": 1, "final_norm": 2, "lm_head": 3, "norm1": 10,
         "norm2": 11, "wq": 20, "wk": 21, "wv": 22, "wo": 23, "bq": 24,
         "bk": 25, "bv": 26, "q_norm": 27, "k_norm": 28, "w1": 30,
         "w3": 31, "w2": 32}


def _generator(seed: int, tag: str, layer: int, device) -> torch.Generator:
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), _TAGS[tag],
                                 layer + 1])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return g


def _fill(out: torch.Tensor, seed: int, tag: str, layer: int,
          mean: float, std: float) -> torch.Tensor:
    return out.normal_(mean, std,
                       generator=_generator(seed, tag, layer, out.device))


def layer_shapes(model: dict) -> dict:
    """``{leaf: (shape, mean, std, group)}`` of one decoder layer; ``group``
    is the subtree of the program's tree the leaf lives in."""
    d, f = model["d_model"], model["d_ff"]
    h, hk = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // h
    out = {"norm1": ((d,), 1.0, 0.05, None), "norm2": ((d,), 1.0, 0.05, None),
           "wq": ((d, h * hd), 0.0, d ** -0.5, "attn"),
           "wk": ((d, hk * hd), 0.0, d ** -0.5, "attn"),
           "wv": ((d, hk * hd), 0.0, d ** -0.5, "attn"),
           "wo": ((h * hd, d), 0.0, (h * hd) ** -0.5, "attn")}
    if model.get("qkv_bias"):
        out.update(bq=((h * hd,), 0.0, 0.02, "attn"),
                   bk=((hk * hd,), 0.0, 0.02, "attn"),
                   bv=((hk * hd,), 0.0, 0.02, "attn"))
    if model.get("qk_norm"):
        out.update(q_norm=((hd,), 1.0, 0.05, "attn"),
                   k_norm=((hd,), 1.0, 0.05, "attn"))
    out.update(w1=((d, f), 0.0, d ** -0.5, "mlp"),
               w3=((d, f), 0.0, d ** -0.5, "mlp"),
               w2=((f, d), 0.0, f ** -0.5, "mlp"))
    return out


def top_shapes(model: dict) -> dict:
    d, v = model["d_model"], model["vocab"]
    out = {"embed": ((v, d), 0.0, 0.02), "final_norm": ((d,), 1.0, 0.05)}
    if not model.get("tie_embeddings"):
        out["lm_head"] = ((d, v), 0.0, d ** -0.5)
    return out


def layer_params(model: dict, seed: int, layer: int, device,
                 dtype: torch.dtype) -> dict:
    """One layer's leaves, flat ``{leaf: tensor}``."""
    return {name: _fill(torch.empty(shape, dtype=dtype, device=device),
                        seed, name, layer, mean, std)
            for name, (shape, mean, std, _) in layer_shapes(model).items()}


def top_params(model: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """The embedding table, the final norm and (untied) the head, flat."""
    return {name: _fill(torch.empty(shape, dtype=dtype, device=device),
                        seed, name, -1, mean, std)
            for name, (shape, mean, std) in top_shapes(model).items()}


def program_tree(model: dict, seed: int, device,
                 dtype: torch.dtype) -> dict:
    """The same weights in the program's tree: the layers stacked under
    ``stack/pos_0`` (one period of one attention + MLP layer), each stacked
    leaf filled layer by layer in place."""
    n = model["n_layers"]
    pos: dict = {"attn": {}, "mlp": {}}
    for name, (shape, mean, std, group) in layer_shapes(model).items():
        buf = torch.empty((n, *shape), dtype=dtype, device=device)
        for i in range(n):
            _fill(buf[i], seed, name, i, mean, std)
        (pos if group is None else pos[group])[name] = buf
    top = top_params(model, seed, device, dtype)
    tree = {"embed": {"table": top["embed"]},
            "final_norm": top["final_norm"], "stack": {"pos_0": pos}}
    if "lm_head" in top:
        tree["lm_head"] = {"w": top["lm_head"]}
    return tree
