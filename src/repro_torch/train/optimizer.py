"""AdamW with warmup+cosine schedule (self-contained, no optimizer library).

The port of :mod:`repro.train.optimizer`, as plain functions on tensor
trees (nested dicts).  Leaves are taken in the reference's order, sorted
dict keys at every level, as ``jax.tree.flatten`` orders a dict.  ``m``,
``v``, the clip, the schedule and the bias corrections are fp32; ``step``
is an int32 scalar tensor on the parameters' device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    """The leaves of a nested dict, sorted keys at every level."""
    out: list[torch.Tensor] = []
    for key in sorted(tree):
        val = tree[key]
        out.extend(tree_leaves(val) if isinstance(val, dict) else [val])
    return out


def tree_unflatten(like: dict, leaves) -> dict:
    """A tree shaped as ``like`` holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}
    return build(like)


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` (and of ``rest``, same shape)."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def schedule(cfg: AdamWCfg, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine
    from ``lr`` down to ``0.1 * lr`` at ``total_steps``; fp32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm,
                                0.1 + 0.9 * cos)


def init_opt_state(params: dict) -> dict:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of per-leaf fp32 sums of squares."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def adamw_update(cfg: AdamWCfg, grads: dict, opt_state: dict,
                 params: dict) -> tuple[dict, dict, dict]:
    """-> (new_params, new_opt_state, metrics {grad_norm, lr}).

    Decay goes to every leaf with ``ndim >= 2``, as in the reference: the
    stacked layers' norm scales (``[n_sb, d]``) are decayed too."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = schedule(cfg, step)
    step_f = step.to(torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step_f)
    bc2 = 1 - torch.pow(b2, step_f)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * clip
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:                      # decay matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = [upd(g, m, v, p) for g, m, v, p in zip(
        tree_leaves(grads), tree_leaves(opt_state["m"]),
        tree_leaves(opt_state["v"]), tree_leaves(params))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
