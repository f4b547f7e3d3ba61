"""Dense SwiGLU MLP + the ternary-quantized linear path (paper technique).

The ternary path (TernaryCfg.enabled / qat) fake-quantizes balanced-ternary
weights with a per-channel absmean scale (straight-through in training).
Packed serving weights (``w1_packed`` ..., :mod:`.quant`) run through the
packed-ternary CUDA kernels on CUDA tensors
(:func:`~repro_torch.kernels.ternary_matmul.ops.ternary_matmul_op`: the
tensor cores from 16 rows, the CUDA cores below) and through the plain
:func:`.quant.unpack_matmul` on CPU tensors.  Inside
:func:`repro_torch.apc.layers.ap_serving` the packed branch runs on the AP
instead (:func:`mlp_ap`: MAC programs over the array pool).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

from ..kernels.ternary_matmul.ops import ternary_matmul_op
from ..kernels.ternary_matmul.ref import quantize_ternary
from .common import act_fn, dense_init, unread_dot
from .quant import unpack_matmul

_PLAIN_PACKED = contextvars.ContextVar("plain_packed_mlp", default=False)


@contextlib.contextmanager
def plain_packed_mlp():
    """Inside, the packed branch runs :func:`.quant.unpack_matmul` on any
    device: the plain route that tests and ``chip_smoke.py`` hold the
    kernel route against on the card."""
    token = _PLAIN_PACKED.set(True)
    try:
        yield
    finally:
        _PLAIN_PACKED.reset(token)


def packed_matmul(x: torch.Tensor, packed: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """y = (x @ unpack(packed)) * scale over x's last axis: the CUDA kernel
    for a CUDA x, else (or under :func:`plain_packed_mlp`) the plain
    version.  A failed launch raises."""
    if not x.is_cuda or _PLAIN_PACKED.get():
        return unpack_matmul(x, packed, scale)
    lead = x.shape[:-1]
    y = ternary_matmul_op(x.reshape(-1, x.shape[-1]), packed, scale)
    return y.reshape(*lead, y.shape[-1])


def ternary_linear(x: torch.Tensor, w: torch.Tensor, qat: bool,
                   rows=None) -> torch.Tensor:
    """y = x @ ternarize(w), STE in training (qat) or fake-quant inference.
    ``rows``: x holds a slice of w's rows (row-parallel over "model"), w
    is whole, so each column's absmean covers all of them; ``rows(w_q)``
    keeps x's slice of the fake-quantized weight."""
    w_ter, scale = quantize_ternary(w.to(torch.float32))
    w_q = (w_ter.to(torch.float32) * scale[None, :]).to(w.dtype)
    if qat:
        # straight-through: forward w_q, gradient flows to w
        w_q = w + (w_q - w).detach()
    return x @ (w_q if rows is None else rows(w_q))


def linear(x: torch.Tensor, w: torch.Tensor, ternary: bool = False,
           qat: bool = False, rows=None) -> torch.Tensor:
    if ternary:
        return ternary_linear(x, w, qat, rows)
    return x @ w


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.float32) -> dict:
    return {
        "w1": dense_init(gen, (d_model, d_ff), 0, dtype),   # gate
        "w3": dense_init(gen, (d_model, d_ff), 0, dtype),   # up
        "w2": dense_init(gen, (d_ff, d_model), 0, dtype),   # down
    }


def mlp_ap(p: dict, x: torch.Tensor, act: str, ctx) -> torch.Tensor:
    """AP-served SwiGLU on packed ternary weights: gate and up projections
    are INDEPENDENT tiled-MAC subgraphs of one ProgramGraph (the runtime
    interleaves their tiles across the array bank); the down projection
    runs in a second graph after the float combine.  Activations quantize
    to ``ctx.x_levels`` integers per projection — the AP arithmetic on the
    quantized grid is exact, and every compare/write cycle lands in
    ``ctx.stats`` for the per-request Table XI report."""
    from ..apc.graph import ProgramGraph
    lead, d = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, d)
    lin1 = ctx.linear("w1", p["w1_packed"], p["w1_scale"], label="mlp.w1")
    lin3 = ctx.linear("w3", p["w3_packed"], p["w3_scale"], label="mlp.w3")
    lin2 = ctx.linear("w2", p["w2_packed"], p["w2_scale"], label="mlp.w2")
    x_int, s_x = ctx.quantize(x2d)
    g1 = ProgramGraph()
    c1 = lin1.add_call(g1, x_int, max_cols=ctx.max_cols, max_q=ctx.x_levels)
    c3 = lin3.add_call(g1, x_int, max_cols=ctx.max_cols, max_q=ctx.x_levels)
    res1 = ctx.run_graph(g1)
    h = act_fn(act)(c1.decode(res1, s_x)) * c3.decode(res1, s_x)
    h_int, s_h = ctx.quantize(h)
    g2 = ProgramGraph()
    c2 = lin2.add_call(g2, h_int, max_cols=ctx.max_cols, max_q=ctx.x_levels)
    res2 = ctx.run_graph(g2)
    y = c2.decode(res2, s_h)
    return y.reshape(*lead, y.shape[-1]).to(x.dtype)


def mlp(p: dict, x: torch.Tensor, act: str = "silu", ternary: bool = False,
        qat: bool = False, tail: bool = False, w2_rows=None) -> torch.Tensor:
    """SwiGLU; ``tail``: the down projection feeds only a super-block's
    output (:func:`~repro_torch.models.common.unread_dot`); ``w2_rows``:
    ``w2`` is whole while the hidden is this rank's slice of d_ff (the
    ternary route on a split "model", :func:`ternary_linear`'s ``rows``)."""
    if "w1_packed" in p:                     # packed ternary serving weights
        from ..apc.layers import current_ap_context
        ctx = current_ap_context()
        if ctx is not None:                  # AP-backed serving path
            return mlp_ap(p, x, act, ctx)
        h = act_fn(act)(packed_matmul(x, p["w1_packed"], p["w1_scale"])) \
            * packed_matmul(x, p["w3_packed"], p["w3_scale"])
        return packed_matmul(h, p["w2_packed"], p["w2_scale"])
    h = act_fn(act)(linear(x, p["w1"], ternary, qat)) \
        * linear(x, p["w3"], ternary, qat)
    with unread_dot(tail):
        return linear(h, p["w2"], ternary, qat, w2_rows)
