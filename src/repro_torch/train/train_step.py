"""Train step: loss, grads (with microbatch accumulation), optimizer update.

The port of :mod:`repro.train.train_step`.  Master weights stay in
``param_dtype`` (fp32); the loss casts them for compute inside the
differentiated function, as the reference does per call, with
:func:`~repro_torch.models.model.cast_params`, so the grads come back in
the master weights' dtype.

``mesh=`` takes ``None`` or a list of devices (one device, the state's) or
a named :class:`~torch.distributed.device_mesh.DeviceMesh`: then params,
``m`` and ``v`` are DTensors placed by ``partition_spec_tree(...,
mesh=mesh)`` (:func:`shard_train_state`), the batch is sharded over the
data axes (:func:`shard_batch`), and AdamW runs on the DTensors, as the
reference's launcher places its state (``src/repro/launch/train.py``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..models import model as M
from ..models.collectives import Psum, all_reduce
from ..models.common import (MODEL_AXIS, batch_spec, is_named_mesh,
                             mesh_data_axes, mesh_sizes, partition_spec_tree,
                             placements, shard_tree)
from .optimizer import (AdamWCfg, adamw_update, init_opt_state, tree_leaves,
                        tree_map, tree_unflatten)

Batch = dict[str, torch.Tensor]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  n_front: int = 0, mesh=None) -> torch.Tensor:
    """Mean next-token CE.  logits [B, S, V], targets [B, S_tok];
    frontend positions (first n_front) carry no loss.  fp32.  On a named
    mesh: vocab-parallel (:func:`_sharded_cross_entropy`)."""
    if n_front:
        logits = logits[:, n_front:, :]
    if is_named_mesh(mesh):
        return _sharded_cross_entropy(logits, targets, mesh)
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(),
                                dim=-1)[..., 0]
    return torch.mean(lse - gold)


def _sharded_cross_entropy(logits, targets, mesh) -> torch.Tensor:
    """The CE of DTensor logits [B, S, V] (vocab over "model" where it
    divides) under ``local_map``: each model shard's max, sum of exp and
    gold logit, summed over "model"; the token sum over the data axes; a
    replicated scalar.  A gather of the gold logit across a sharded vocab
    has no DTensor rule, and the vocab-parallel form never gathers the
    logits (GSPMD's, in the reference)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    b, s, _ = logits.shape
    da = mesh_data_axes(mesh)
    if b % math.prod(mesh_sizes(mesh)[a] for a in da):
        da = None
    l_pl = placements((da, None, MODEL_AXIS), mesh, logits.shape)
    t_pl = placements((da, None), mesh, targets.shape)
    vocab_split = Shard(2) in l_pl and mesh_sizes(mesh)[MODEL_AXIS] > 1
    model = mesh.get_group(MODEL_AXIS)

    split = [a for a in da or () if mesh_sizes(mesh)[a] > 1]

    def body(lg, tg):
        lg = lg.to(torch.float32)
        if vocab_split:
            m = all_reduce(lg.detach().amax(-1, keepdim=True), model,
                           dist.ReduceOp.MAX)
            se = Psum.apply(torch.exp(lg - m).sum(-1), model)
            v_l = lg.shape[-1]
            local = tg.long() - dist.get_rank(model) * v_l
            ok = (local >= 0) & (local < v_l)
            gold = torch.take_along_dim(
                lg, local.clamp(0, v_l - 1)[..., None], dim=-1)[..., 0] * ok
            per = torch.log(se) + m[..., 0] - Psum.apply(gold, model)
        else:                                # the plain formula
            per = torch.logsumexp(lg, dim=-1) - torch.take_along_dim(
                lg, tg[..., None].long(), dim=-1)[..., 0]
        if not split:
            return torch.mean(per)
        total = per.sum()
        for a in split:
            total = Psum.apply(total, mesh.get_group(a))
        return total / (b * s)

    fn = local_map(body, out_placements=[Replicate()] * mesh.ndim,
                   in_placements=(l_pl, t_pl), redistribute_inputs=True,
                   device_mesh=mesh)
    return fn(logits, targets)


def make_loss_fn(cfg: ModelConfig, mesh=None):
    """-> loss_fn(params, batch): the master weights cast for compute, the
    forward pass, the cross entropy."""
    n_front = cfg.n_frontend_tokens if cfg.frontend else 0

    def loss_fn(params: dict, batch: Batch) -> torch.Tensor:
        logits = M.forward(cfg, M.cast_params(cfg, params), batch,
                           mesh=mesh)
        return cross_entropy(logits, batch["targets"], n_front, mesh)

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


def state_specs(state: dict, mesh=None) -> dict:
    """The specs of a train state: params, ``m`` and ``v`` by the partition
    rules (axes that do not divide dropped on ``mesh``), ``step``
    replicated."""
    return {"params": partition_spec_tree(state["params"], mesh=mesh),
            "opt": {"m": partition_spec_tree(state["opt"]["m"], mesh=mesh),
                    "v": partition_spec_tree(state["opt"]["v"], mesh=mesh),
                    "step": ()}}


def shard_train_state(state: dict, mesh) -> dict:
    """``state`` (tensors on the mesh's device, or ``meta``) as DTensors on
    the named ``mesh``, placed by :func:`state_specs`."""
    return shard_tree(state, state_specs(state, mesh), mesh)


def shard_batch(batch: Batch, mesh) -> Batch:
    """Every batch tensor as a DTensor sharded on dim 0 over the data axes
    (replicated where they do not divide the batch)."""
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(v, mesh, placements(batch_spec(mesh), mesh,
                                                     v.shape))
            for k, v in batch.items()}


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWCfg,
                    microbatches: int = 1, *, mesh=None):
    """Returns step(state, batch) -> (state, metrics {loss, grad_norm, lr}).

    microbatches > 1 accumulates fp32 grads over equal slices of the batch
    in turn (the per-shape memory lever) and divides by their count.  On a
    named ``mesh`` a state or batch of plain tensors (every rank holding
    the same) is sharded first; the returned state is DTensors."""
    loss_fn = make_loss_fn(cfg, mesh)
    named = is_named_mesh(mesh)

    def step(state: dict, batch: Batch):
        if named:
            if not _is_dtensor(tree_leaves(state["params"])[0]):
                state = shard_train_state(state, mesh)
            if not _is_dtensor(next(iter(batch.values()))):
                batch = shard_batch(batch, mesh)
        params = state["params"]
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            # the sums start from the first microbatch's (fp32) values, so
            # that on a mesh they are DTensors like the values they add
            loss = grads = None
            for i in range(microbatches):
                mb = {}
                for k, v in batch.items():
                    bsz = v.shape[0] // microbatches
                    mb[k] = v[i * bsz:(i + 1) * bsz]
                loss_i, g_i = value_and_grad(loss_fn, params, mb)
                if grads is None:
                    loss = loss_i.to(torch.float32)
                    grads = tree_map(lambda g: g.to(torch.float32), g_i)
                else:
                    loss = loss + loss_i
                    grads = tree_map(torch.add, grads, g_i)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
        if named:
            # each grad in its param's placement (a Partial grad reduced),
            # so that the update keeps the state's placements
            grads = tree_map(lambda g, p: g.redistribute(
                p.device_mesh, p.placements), grads, params)
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, grads, state["opt"], params)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return step
