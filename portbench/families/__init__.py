"""Model families: everything the harness knows of one architecture.

A configuration's family is its model's ``family`` (the port's
``ModelConfig.family``; ``dense`` when it names none); the harness loads
``portbench/families/<family>.py`` and asks it for:

- ``model_config(model) -> ModelConfig``: the port's configuration from
  the file's ``model`` (most families take :func:`model_config` below);
- ``program_tree(model, seed, device, dtype)``: the seeded weights in the
  program's tree;
- ``top_params(model, seed, device, dtype)`` and ``layer_params(model,
  seed, layer, device, dtype)``: the same weights, flat, for the check;
- ``keeps_layer_weights(model) -> bool``: whether the check keeps each
  layer's weights once made, or makes them again for every pass;
- ``logits`` and ``logits_stepwise``: the plain reference (the signatures
  of :mod:`portbench.reference.model`);
- ``ap_graphs_per_step(model) -> int``: the AP graphs one step of a
  request runs on the AP route.

So a new architecture comes to the benchmark as new files: its family, its
configuration, its workloads and its metric readers.  The reference and
the weights a family brings import neither JAX nor the program: of the
port, a family imports only ``repro_torch.configs``, for
:func:`model_config`.
"""
from __future__ import annotations


def model_config(model: dict):
    """The port's ``ModelConfig`` from a configuration's ``model``: the
    nested ``moe``, ``ssm`` and ``ternary`` blocks as their dataclasses,
    list-valued ``layer_pattern`` and ``ffn_pattern`` as tuples."""
    from repro_torch.configs.base import MoECfg, ModelConfig, SSMCfg, \
        TernaryCfg
    kw = dict(model)
    for key, cls in (("moe", MoECfg), ("ssm", SSMCfg),
                     ("ternary", TernaryCfg)):
        if isinstance(kw.get(key), dict):
            kw[key] = cls(**kw[key])
    for key in ("layer_pattern", "ffn_pattern"):
        if isinstance(kw.get(key), list):
            kw[key] = tuple(kw[key])
    return ModelConfig(**kw)
