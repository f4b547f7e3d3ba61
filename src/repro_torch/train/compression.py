"""TernGrad-style ternary gradient compression for the data-parallel
all-reduce.

The port of :mod:`repro.train.compression`.  Gradients are ternarized to
{-1, 0, +1} x scale before crossing the interconnect (int8 on the wire,
4x fewer bytes than bf16, 16x fewer than fp32).

Protocol (scale-sharing TernGrad, all-reduce compatible):
  1. s   = max over replicas of max|g|            (tiny scalar reduce)
  2. t_r = stochastic_ternarize(g_r / s)          (int8 on the wire)
  3. T   = sum_r t_r;  g_avg = s * T / n_replicas

A mesh is a list of devices (``"cpu"``, ``"cuda:0"``, the same device
more than once); each entry is one data-parallel replica that holds its
own state and takes its equal slice of the batch.  The scale's max and the
int32 sum of codes are formed on the first replica's device, and every
replica applies the same averaged grads.  Dense/SSM archs only, as in the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .optimizer import AdamWCfg, adamw_update, tree_leaves, tree_map, \
    tree_unflatten
from .train_step import make_loss_fn, value_and_grad


def ternarize(g: torch.Tensor, scale: torch.Tensor, u: torch.Tensor
              ) -> torch.Tensor:
    """Stochastic ternarization with uniform draws ``u`` (g's shape):
    E[t * s] = g.  Returns int8 in {-1, 0, 1}."""
    r = g.to(torch.float32) / torch.clamp(scale, min=1e-30)
    p = torch.abs(r)                         # in [0, 1]
    return (torch.sign(r) * (u < p)).to(torch.int8)


def uniform_draws(grads: dict, step: int) -> list[torch.Tensor]:
    """One uniform [0, 1) fp32 tensor per leaf of ``grads`` (flatten
    order), from a generator on the first leaf's device seeded from
    ``(17, step)``: the same draws for every replica, as the reference's
    key is not folded per device."""
    leaves = tree_leaves(grads)
    dev = leaves[0].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(np.random.SeedSequence([17, int(step)])
                        .generate_state(1)[0]))
    return [torch.rand(x.shape, generator=gen, device=dev,
                       dtype=torch.float32) for x in leaves]


def ternary_allreduce(replica_grads: list[dict],
                      draws: list[torch.Tensor]) -> dict:
    """Average the replicas' gradient trees in ternary wire format; the
    result (fp32) lies on the first replica's device."""
    n = len(replica_grads)
    flat = [tree_leaves(g) for g in replica_grads]
    dev0 = flat[0][0].device
    out = []
    for i, u in enumerate(draws):
        leaves = [f[i] for f in flat]
        s = torch.stack([torch.max(torch.abs(x.to(torch.float32))).to(dev0)
                         for x in leaves]).max()          # shared scale
        total = sum(ternarize(x, s.to(x.device), u.to(x.device))
                    .to(dev0, torch.int32) for x in leaves)
        out.append((s * total.to(torch.float32) / n).to(torch.float32))
    return tree_unflatten(replica_grads[0], out)


def wire_bytes(grads: dict, dtype_bytes: float = 1.0) -> float:
    """Wire payload of one compressed all-reduce (int8=1.0, 2-bit
    packed=0.25)."""
    return sum(x.numel() for x in tree_leaves(grads)) * dtype_bytes


def replicate(state: dict, mesh) -> list[dict]:
    """``state`` on every replica of ``mesh``, one tree per entry (a tensor
    already on that device is shared until the first step replaces it)."""
    return [tree_map(lambda t: t.to(dev), state) for dev in mesh]


def make_compressed_dp_step(cfg: ModelConfig, mesh, opt_cfg: AdamWCfg):
    """Pure-DP train step with ternary gradient all-reduce.

    Returns step(replicas, batch) -> (replicas, metrics): ``replicas`` is
    one state per mesh entry (:func:`replicate`), the batch is split into
    equal slices in mesh order, each replica takes the grads of the loss on
    its slice, the grads cross in ternary form, and every replica applies
    AdamW to its own state with the averaged grads.  ``loss`` is the mean
    of the replicas' losses before compression; ``grad_norm`` and ``lr``
    are the first replica's."""
    if any(f == "moe" for f in cfg.ffn_pattern):
        raise ValueError("compressed DP step supports dense/SSM archs only")
    mesh = [torch.device(d) for d in mesh]
    n = len(mesh)
    loss_fn = make_loss_fn(cfg)

    def step(replicas: list[dict], batch: dict):
        losses, grads = [], []
        for r, (dev, state) in enumerate(zip(mesh, replicas)):
            shard = {}
            for k, v in batch.items():
                b = v.shape[0] // n
                shard[k] = v[r * b:(r + 1) * b].to(dev)
            loss_r, g_r = value_and_grad(loss_fn, state["params"], shard)
            losses.append(loss_r.to(mesh[0]))
            grads.append(g_r)
        loss = sum(losses) / n
        draws = uniform_draws(grads[0], int(replicas[0]["opt"]["step"]))
        avg = ternary_allreduce(grads, draws)
        outs = [adamw_update(opt_cfg, tree_map(lambda g: g.to(dev), avg),
                             state["opt"], state["params"])
                for dev, state in zip(mesh, replicas)]
        metrics = outs[0][2]
        metrics["loss"] = loss
        return [{"params": p, "opt": opt} for p, opt, _ in outs], metrics

    return step
