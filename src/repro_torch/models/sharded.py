"""Placement plumbing for the model on a named mesh.

On a :class:`~torch.distributed.device_mesh.DeviceMesh` the params (and a
decode cache) are DTensors placed by the partition rules.
:func:`repro_torch.models.model.forward` and ``decode_step`` run their one
per-rank body (:mod:`.blocks`, under a :class:`~.collectives.Plan`) under
``local_map`` through :func:`run_local`: every leaf keeps its placement,
and the specs the body reads come from the placements (:func:`specs_of`).
Here also the placements of a batch (:func:`place_batch`) and of a decode
cache (:func:`cache_specs`).  DTensor's own propagation runs outside the
body only (AdamW, the loss): on a mesh of three axes its rule search for
one einsum takes minutes.
"""
from __future__ import annotations

import math

from ..configs.base import ModelConfig
from .collectives import axis_names, batch_axes, on_model
from .common import MODEL_AXIS, mesh_data_axes, mesh_sizes, placements


def spec_of(t, mesh) -> tuple:
    """The spec of a DTensor's placements (a plain tensor: replicated)."""
    from torch.distributed.tensor import Shard
    spec: list = [None] * t.ndim
    for name, pl in zip(mesh.mesh_dim_names, getattr(t, "placements", ())):
        if isinstance(pl, Shard):
            d = pl.dim
            spec[d] = name if spec[d] is None else axis_names(spec[d]) + (
                name,)
    return tuple(spec)


def _flat(tree: dict) -> list:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _flat(v) if isinstance(v, dict) else [v]
    return out


def _unflat(like: dict, leaves) -> dict:
    it = iter(leaves)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}
    return build(like)


def specs_of(tree: dict, mesh) -> dict:
    """The spec of every leaf of ``tree`` (DTensors) from its placements."""
    return _unflat(tree, [spec_of(t, mesh) for t in _flat(tree)])


def run_local(mesh, body, out_spec, trees, specs):
    """``body(*local_trees)`` under ``local_map``: every leaf keeps its
    placement (no redistribution), the result is placed by ``out_spec``."""
    from torch.distributed.tensor.experimental import local_map
    leaves = [t for tree in trees for t in _flat(tree)]
    in_pl = tuple(placements(s, mesh) for sp in specs for s in _flat(sp))
    sizes = [len(_flat(tree)) for tree in trees]

    def flat_body(*args):
        out, i = [], 0
        for tree, n in zip(trees, sizes):
            out.append(_unflat(tree, args[i:i + n]))
            i += n
        return body(*out)

    fn = local_map(flat_body, out_placements=list(placements(out_spec,
                                                             mesh)),
                   in_placements=in_pl, redistribute_inputs=True,
                   device_mesh=mesh)
    return fn(*leaves)


def vocab_spec(cfg: ModelConfig, specs) -> tuple:
    """The logits' vocab dim: over "model" where the head's is."""
    sw = specs["embed"]["table"] if cfg.tie_embeddings \
        else specs["lm_head"]["w"]
    return (MODEL_AXIS,) if on_model(sw) else (None,)


def batch_specs(batch: dict, mesh) -> dict:
    """Batch tensors: dim 0 over the data axes (where they divide it)."""
    return {k: (batch_axes(mesh, v.shape[0]),) + (None,) * (v.ndim - 1)
            for k, v in batch.items()}


def place_batch(batch: dict, mesh) -> tuple[dict, dict]:
    """(``batch`` as DTensors, its specs): a plain tensor is taken as each
    rank's full copy and split locally by :func:`batch_specs`."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    b_specs = batch_specs(batch, mesh)
    return {k: v if isinstance(v, DTensor) else distribute_tensor(
        v, mesh, placements(b_specs[k], mesh), src_data_rank=None)
        for k, v in batch.items()}, b_specs


def cache_specs(cfg: ModelConfig, cache: dict, mesh) -> dict:
    """Specs of a decode cache (shaped as ``cache``), the reference's
    decode-cache shardings (``src/repro/launch/dryrun.py``): the batch over
    the data axes where they divide it, else the positions (sequence-
    parallel decode, long_500k); kv heads over "model" where they divide,
    else the positions over "model" if they are not split yet; the Mamba
    state's heads and the conv state's channels over "model"."""
    sizes = mesh_sizes(mesh)
    da = mesh_data_axes(mesh)
    dp, tp = math.prod(sizes[a] for a in da), sizes[MODEL_AXIS]

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in node.items()}
        stacked = "stack" in path
        dims = node.shape[1:] if stacked else node.shape
        axes: list = [None] * len(dims)
        batch_ok = dims[0] >= dp and dims[0] % dp == 0
        if "kv" in path and len(dims) == 4:
            if batch_ok:
                axes[0] = da
            elif dims[1] % dp == 0:
                axes[1] = da
            if dims[2] % tp == 0:
                axes[2] = MODEL_AXIS
            elif axes[1] is None and dims[1] % tp == 0:
                axes[1] = MODEL_AXIS
        elif "ssm" in path and len(dims) == 4:
            if batch_ok:
                axes[0] = da
            if dims[1] % tp == 0:
                axes[1] = MODEL_AXIS
        elif "conv" in path and len(dims) == 3:
            if batch_ok:
                axes[0] = da
            if dims[2] % tp == 0:
                axes[2] = MODEL_AXIS
        return ((None,) if stacked else ()) + tuple(axes)

    return walk(cache, "")
