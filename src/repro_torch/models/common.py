"""Shared model primitives: norms, RoPE, inits, partition rules.

Parameters are plain nested dicts of tensors, in the reference's tree, so
weights carry across by a plain tree walk (:func:`repro_torch.convert.
params_from_arrays`).  Sharding is path-based, as in the reference:
:func:`partition_spec_tree` walks the tree and gives each leaf a spec from
its path and shape, FSDP("data") x TP("model") with the "pod" axis folded
into data-parallel batch sharding.  A spec is a plain tuple with one entry
per tensor dim: ``None``, an axis name, or a tuple of names.  On a named
mesh (a :class:`~torch.distributed.device_mesh.DeviceMesh`)
:func:`placements` turns a spec into DTensor placements and
:func:`shard_tree` places a tree.  A list of devices is the data-only mesh
of the runtime (:mod:`repro_torch.launch.mesh`).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re

import torch
import torch.nn.functional as F

Params = dict

DATA_AXES = ("pod", "data")        # batch / FSDP dims (pod folds into DP)
MODEL_AXIS = "model"               # TP dim


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Initializers: the reference's distributions, drawn from an explicit
# torch.Generator (the values differ from JAX's; tests carry weights across)
# ---------------------------------------------------------------------------

def _normal(gen, shape) -> torch.Tensor:
    """Standard normal draws from ``gen``; on ``meta`` (no generator
    exists there, :class:`MetaGen`) the shape alone."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), device="meta", dtype=torch.float32)
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


class MetaGen:
    """The stand-in for a ``torch.Generator`` on the ``meta`` device: the
    inits build the tree from shapes alone (the dry-run)."""
    device = torch.device("meta")


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


# remat "dots": a product inside this context feeds only the super-block's
# output, which the backward pass never reads, so it is recomputed rather
# than saved (models.model.remat_wrap)
_UNREAD_DOT = contextvars.ContextVar("unread_dot", default=False)


@contextlib.contextmanager
def unread_dot(on: bool = True):
    """Marks the products inside as unread by the backward pass (the
    block's last projection in the last layer of a super-block)."""
    token = _UNREAD_DOT.set(on)
    try:
        yield
    finally:
        _UNREAD_DOT.reset(token)


def dot_unread() -> bool:
    return _UNREAD_DOT.get()


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


# ---------------------------------------------------------------------------
# Path-based partition rules (FSDP x TP)
# ---------------------------------------------------------------------------

# Each rule: (regex over "/"-joined param path, axes for the leading dims).
# Stacked params carry a leading super-block axis -> spec gets a None
# prepended (detected via the path containing "stack").
_RULES: list[tuple[str, tuple | None]] = [
    # embeddings / lm head: vocab over model (vocab-parallel logits)
    (r"embed/table$",            ("model", "data")),
    (r"lm_head/w$",              ("data", "model")),   # [d, V]
    # attention projections
    (r"attn.*/wq$",              ("data", "model")),   # [d, H*hd]
    (r"attn.*/wk$",              ("data", "model")),
    (r"attn.*/wv$",              ("data", "model")),
    (r"attn.*/wo$",              ("model", "data")),   # [H*hd, d]
    (r"attn.*/bq$",              ("model",)),
    (r"attn.*/bk$",              ("model",)),
    (r"attn.*/bv$",              ("model",)),
    (r"attn.*/(q_norm|k_norm)$", (None,)),
    # dense mlp (+ packed ternary serving forms)
    (r"mlp/w1$",                 ("data", "model")),
    (r"mlp/w3$",                 ("data", "model")),
    (r"mlp/w2$",                 ("model", "data")),
    (r"mlp/w[13]_packed$",       ("data", "model")),
    (r"mlp/w2_packed$",          ("model", "data")),
    (r"mlp/w[13]_scale$",        ("model",)),
    (r"mlp/w2_scale$",           ("data",)),
    # moe: experts replicated (tp variant) / sharded (ep); ff over model
    (r"moe/router$",             ("data", None)),
    (r"moe/w1$",                 (None, "data", "model")),
    (r"moe/w3$",                 (None, "data", "model")),
    (r"moe/w2$",                 (None, "model", "data")),
    # mamba2
    (r"mamba/in_proj$",          ("data", "model")),
    (r"mamba/out_proj$",         ("model", "data")),
    (r"mamba/conv_w$",           (None, "model")),
    (r"mamba/(a_log|d_skip)$",   ("model",)),
    (r"mamba/dt_bias$",          ("model",)),
    (r"mamba/norm$",             ("model",)),
    # norms and small vectors: replicated
    (r".*",                      None),
]


def spec_for_path(path: str, ndim: int, ep: bool = False) -> tuple:
    """The spec of the leaf at ``path`` with ``ndim`` dims."""
    for pattern, axes in _RULES:
        if re.search(pattern, path):
            if axes is None:
                spec_axes: list = [None] * ndim
            else:
                spec_axes = list(axes) + [None] * (ndim - len(axes))
                spec_axes = spec_axes[:ndim]
            if ep and "moe/w" in path:
                # expert-parallel variant: shard experts over model,
                # keep ff unsharded (each expert whole on its shard)
                spec_axes = ["model"] + [None] * (ndim - 1)
            if "stack" in path:
                # leading layer-stack axis is never sharded
                spec_axes = [None] + spec_axes[: ndim - 1]
            return tuple(spec_axes)
    return ()


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``, any object whose ``.shape``
    maps names to sizes, or a list of devices (one "data" axis)."""
    if mesh is None:
        return {}
    if isinstance(mesh, (list, tuple)):
        return {"data": len(mesh)}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def divisible_spec(spec: tuple, shape, sizes: dict[str, int]) -> tuple:
    """``spec`` with every entry whose axes do not divide its dim dropped
    (replicated)."""
    out = []
    for dim, ax in zip(shape, spec):
        names = ax if isinstance(ax, tuple) else (ax,) if ax else ()
        total = math.prod(sizes.get(nm, 1) for nm in names)
        out.append(ax if ax is not None and dim % total == 0 else None)
    return tuple(out)


def partition_spec_tree(params: Params, ep: bool = False, mesh=None) -> dict:
    """Specs per path rules, a tree shaped as ``params`` (leaves: tensors
    or anything with ``.shape``); with ``mesh`` given, axes that do not
    divide the corresponding dim evenly are dropped (replicated) — e.g.
    mamba2's vocab=50280 is not divisible by model=16, so its table stays
    unsharded on that dim."""
    sizes = mesh_sizes(mesh)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}{k}/") for k, v in node.items()}
        shape = tuple(node.shape)
        spec = spec_for_path(path[:-1], len(shape), ep=ep)
        return divisible_spec(spec, shape, sizes) if sizes else spec

    return walk(params, "")


def is_named_mesh(mesh) -> bool:
    """A ``DeviceMesh`` with named axes (not ``None``, not a list)."""
    return getattr(mesh, "mesh_dim_names", None) is not None


def mesh_data_axes(mesh) -> tuple[str, ...]:
    """Batch/DP axes present in this mesh; ("data",) for a list of
    devices."""
    return tuple(a for a in DATA_AXES if a in mesh_sizes(mesh))


def batch_spec(mesh) -> tuple:
    return (mesh_data_axes(mesh),)


def activation_spec(mesh) -> tuple:
    return (mesh_data_axes(mesh), None, None)


def placements(spec: tuple, mesh, shape=None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim named at tensor dim ``d``, ``Replicate()`` elsewhere.  With
    ``shape``, axes that do not divide their dim are dropped first."""
    from torch.distributed.tensor import Replicate, Shard
    if shape is not None:
        spec = divisible_spec(tuple(spec) + (None,) * (len(shape) - len(spec)),
                          shape, mesh_sizes(mesh))
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_tree(tree: dict, specs: dict, mesh, src_data_rank=0) -> dict:
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` placed by its
    spec (``specs`` shaped as ``tree``): rank ``src_data_rank``'s values,
    or, with ``None``, each rank's own tree sliced locally without
    communication (as a ``meta`` leaf always is).  A leaf that is a
    DTensor already is taken as placed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, DTensor):
            return node
        return distribute_tensor(node, mesh, placements(spec, mesh),
                                 src_data_rank=src_data_rank)

    return walk(tree, specs)
