"""Train step: loss, grads (with microbatch accumulation), optimizer update.

The port of :mod:`repro.train.train_step`.  Master weights stay in
``param_dtype`` (fp32); the loss casts them for compute inside the
differentiated function, as the reference does per call, with
:func:`~repro_torch.models.model.cast_params`, so the grads come back in
the master weights' dtype.  No mesh: one device, the state's.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import model as M
from .optimizer import (AdamWCfg, adamw_update, init_opt_state, tree_leaves,
                        tree_map, tree_unflatten)

Batch = dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  n_front: int = 0) -> torch.Tensor:
    """Mean next-token CE.  logits [B, S, V], targets [B, S_tok];
    frontend positions (first n_front) carry no loss.  fp32."""
    if n_front:
        logits = logits[:, n_front:, :]
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(),
                                dim=-1)[..., 0]
    return torch.mean(lse - gold)


def make_loss_fn(cfg: ModelConfig):
    """-> loss_fn(params, batch): the master weights cast for compute, the
    forward pass, the cross entropy."""
    n_front = cfg.n_frontend_tokens if cfg.frontend else 0

    def loss_fn(params: dict, batch: Batch) -> torch.Tensor:
        logits = M.forward(cfg, M.cast_params(cfg, params), batch)
        return cross_entropy(logits, batch["targets"], n_front)

    return loss_fn


def value_and_grad(loss_fn, params: dict, batch: Batch
                   ) -> tuple[torch.Tensor, dict]:
    """(loss, grads): grads of ``loss_fn`` with respect to every leaf of
    ``params`` (all floating), a tree of the same shape and dtypes.
    ``params`` itself is not modified."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(params, grads)


def init_train_state(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random params from ``seed`` (``init_params``) and zeroed AdamW
    state, on ``device`` (``None`` = ``cuda:0``)."""
    params = M.init_params(cfg, seed=seed, device=device)
    return {"params": params, "opt": init_opt_state(params)}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWCfg,
                    microbatches: int = 1):
    """Returns step(state, batch) -> (state, metrics {loss, grad_norm, lr}).

    microbatches > 1 accumulates fp32 grads over equal slices of the batch
    in turn (the per-shape memory lever) and divides by their count."""
    loss_fn = make_loss_fn(cfg)

    def step(state: dict, batch: Batch):
        params = state["params"]
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                mb = {}
                for k, v in batch.items():
                    bsz = v.shape[0] // microbatches
                    mb[k] = v[i * bsz:(i + 1) * bsz]
                loss_i, g_i = value_and_grad(loss_fn, params, mb)
                grads = tree_map(torch.add, grads, g_i)
                loss = loss + loss_i
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, grads, state["opt"], params)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return step
