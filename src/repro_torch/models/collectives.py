"""Collectives over one axis of a named mesh, with the backward passes of
the reference's ``shard_map`` transposes (autograd-aware).

Inside a ``local_map`` body the tensors are one rank's shards, and an
input the body treats as replicated over an axis may be used in a way that
varies over it (the MoE router under data-sharded tokens); its grads must
then be summed over that axis (:class:`SumGrad`), as JAX's transpose of
the implicit broadcast does.  :class:`Psum` is the forward sum whose
result is replicated (grads pass through), :class:`GatherWeight` the FSDP
all_gather (grads reduce-scattered), :class:`GatherOutput` the gather of a
replicated result (grads sliced).  :func:`all_to_all` goes through
``torch.distributed.nn.functional``.

:class:`Plan` is one pass's view of the mesh, the one object the model's
per-rank body asks where it would gather, sum or split; without a named
mesh (:data:`LOCAL`) every one of its collectives is the identity, so the
same body is the model's single-device pass.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .common import MODEL_AXIS, is_named_mesh, mesh_data_axes, mesh_sizes


def all_reduce(t: torch.Tensor, group,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=op, group=group)
    return t


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum over ``group``, keep this rank's slice along ``dim``."""
    n = dist.get_world_size(group)
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((t.shape[0] // n, *t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=group)
    return out.movedim(0, dim)


def gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim)


def my_slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size).contiguous()


class SumGrad(torch.autograd.Function):
    """Identity forward; grads summed over ``group`` (an input replicated
    over an axis that its use varies on)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class Psum(torch.autograd.Function):
    """Sum over ``group`` forward (a replicated result); grads pass."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherWeight(torch.autograd.Function):
    """Tiled all_gather along ``dim`` (FSDP); grads reduce-scattered (each
    rank's grads summed, its own slice kept) when ``reduce`` is set, else
    sliced (every rank already holds the whole grad)."""

    @staticmethod
    def forward(ctx, t, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return my_slice(g, ctx.group, ctx.dim), None, None, None


class GatherOutput(GatherWeight):
    """Tiled all_gather of a replicated output; grads sliced."""

    @staticmethod
    def forward(ctx, t, group, dim):
        return GatherWeight.forward(ctx, t, group, dim, False)

    @staticmethod
    def backward(ctx, g):
        return GatherWeight.backward(ctx, g)[:3]


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """[tp, ...] -> [tp, ...]: block i goes to rank i (non-tiled)."""
    import torch.distributed.nn.functional as dnn
    t = t.contiguous()
    return dnn.all_to_all_single(torch.empty_like(t), t, group=group)


# ---------------------------------------------------------------------------
# One pass's view of the mesh
# ---------------------------------------------------------------------------

class _Whole:
    """The specs of a tree held whole on one device: every entry is
    itself, and as a spec it names no axis."""

    def __getitem__(self, key):
        return self

    def __iter__(self):
        return iter(())

    def __len__(self):
        return 0


WHOLE = _Whole()


def axis_names(ax) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    return ax if isinstance(ax, tuple) else (ax,) if ax else ()


def on_model(spec) -> bool:
    return any(MODEL_AXIS in axis_names(ax) for ax in spec)


def batch_axes(mesh, batch: int):
    """The data axes when their product divides ``batch``, else None."""
    da = mesh_data_axes(mesh)
    sizes = mesh_sizes(mesh)
    return da if batch % math.prod(sizes[a] for a in da) == 0 else None


class Plan:
    """One pass on ``mesh`` (a named ``DeviceMesh``; anything else runs on
    one device): the data axes the batch of ``batch`` rows is split over
    (``da``, None where they do not divide it), whether attention splits
    the batch over "model" (``batch_split``, from ``attn_batch_split``),
    and the gathers and grad sums a local weight needs before its use.
    Without a mesh every method is the identity."""

    def __init__(self, mesh=None, batch: int = 0,
                 attn_batch_split: bool = False):
        self.mesh = mesh if is_named_mesh(mesh) else None
        self.sizes = mesh_sizes(self.mesh)
        self.tp = self.sizes.get(MODEL_AXIS, 1)
        self.da = batch_axes(self.mesh, batch) if self.mesh else None
        dp = math.prod(self.sizes[a] for a in self.da or ())
        self.batch_split = (attn_batch_split and self.tp > 1
                            and batch % (dp * self.tp) == 0)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        return dist.get_rank(self.group(axis)) if self.mesh else 0

    def split(self, spec) -> bool:
        """A leaf placed by ``spec`` is split over a "model" of size > 1."""
        return self.tp > 1 and on_model(spec)

    def sum_grad(self, t, axes):
        for a in axes:
            if self.sizes.get(a, 1) > 1:
                t = SumGrad.apply(t, self.group(a))
        return t

    def full(self, w, spec, gather_model: bool = False,
             model_reduce: bool = False, model_varying: bool = False):
        """``w`` (this rank's shard, placed by ``spec``) ready for use on
        this rank's tokens: gathered over "data" (and over "model" with
        ``gather_model``: grads reduce-scattered when ``model_reduce``,
        the use varying over "model", else sliced); grads summed over
        every data axis of the batch it is replicated over, and over
        "model" with ``model_varying``."""
        if self.mesh is None:
            return w
        held = {n for ax in spec for n in axis_names(ax)}
        w = self.sum_grad(w, [a for a in self.da or () if a not in held])
        for d, ax in enumerate(spec):
            if "data" in axis_names(ax) and self.sizes.get("data", 1) > 1:
                w = GatherWeight.apply(w, self.group("data"), d,
                                       "data" in (self.da or ()))
            if MODEL_AXIS in axis_names(ax) and gather_model and self.tp > 1:
                w = GatherWeight.apply(w, self.group(MODEL_AXIS), d,
                                       model_reduce)
        if model_varying and MODEL_AXIS not in held:
            w = self.sum_grad(w, (MODEL_AXIS,))
        return w

    def mine(self, t, dim: int):
        """This "model" rank's slice of ``t`` along ``dim``."""
        return my_slice(t, self.group(MODEL_AXIS), dim) if self.tp > 1 \
            else t

    def psum_model(self, t):
        return Psum.apply(t, self.group(MODEL_AXIS)) if self.tp > 1 else t

    def whole(self, fn, p: dict, specs, x):
        """``fn(p_whole, x_whole)`` as one device computes it, then this
        rank's rows: ``x`` (batch first) gathered whole over the batch's
        data axes, every weight of ``p`` whole over "data" and "model".
        Every rank runs the same ``fn`` on the same operands (the AP route,
        whose projections take one activation scale over all of x, as the
        reference's host-orchestrated AP path computes them on global
        arrays).  Inference only: no grads flow."""
        if self.mesh is None:
            return fn(p, x)
        axes = self.da or ()
        for a in reversed(axes):     # the minor axis first: pod stays major
            if self.sizes[a] > 1:
                x = gather(x, self.group(a), 0)
        pw = {k: self.full(w, specs[k], gather_model=True)
              for k, w in p.items()}
        y = fn(pw, x)
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * self.sizes[a] + self.rank(a), n * self.sizes[a]
        rows = y.shape[0] // n
        return y.narrow(0, idx * rows, rows)


LOCAL = Plan()
