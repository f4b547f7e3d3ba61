"""Mixture-of-Experts with sort-based capacity dispatch.

router -> top-k -> flat (token, expert) pairs sorted by expert ->
position-in-expert via rank-within-segment -> capacity-dropped scatter into
an [E, C, d] buffer -> block-diagonal expert einsum -> weighted combine.

Two parallelism modes on a named mesh (MoECfg.parallelism), the
reference's bodies under ``local_map`` (its ``shard_map``), collectives over
``mesh.get_group(axis)``:

  "tp": expert weights FSDP-sharded on d_model over "data" (gathered) and
      TP-sharded on d_ff over "model" (the down-projection summed over
      "model"); dispatch is local to each data shard.
  "ep": experts sharded over "model"; each model shard dispatches its 1/tp
      slice of the tokens, two all_to_alls carry them to their expert's
      owner and back, an all_gather restores the model-replicated output.
      Taken only when ``n_experts % tp == 0``, ``tp > 1`` and the tokens
      divide by tp, as in the reference; else "tp".

Without a named mesh (``None`` or a list of devices) :func:`moe_ffn` runs
the TP body on one device, without collectives.  Inside
:func:`repro_torch.apc.layers.ap_serving` the experts run on the AP
instead (:func:`moe_ffn_ap`).

A dropless configuration (``MoECfg.dropless``, granite's) takes the
capacity route at a capacity of the token count: a token's k experts are
distinct, so no expert receives more pairs than there are tokens.  Each
call adds its routed pairs (tokens x k) to the registry counter
``moe.routed_pairs`` and the rows its expert products compute, padding
included, to ``moe.expert_rows`` (both from shapes, no device sync).

The collectives (:mod:`.collectives`) backpropagate as the reference's
transposes: the router's grads are summed over the data axes, the
experts' x's over "model", a weight gathered over "data" takes its grads
reduce-scattered.
"""
from __future__ import annotations

import torch

from ..apc.metrics import get_registry
from ..configs.base import MoECfg
from .collectives import LOCAL, WHOLE, GatherOutput, Plan, all_to_all
from .common import (MODEL_AXIS, act_fn, dense_init, is_named_mesh,
                     mesh_sizes, placements)


def init_moe(gen: torch.Generator, d_model: int, cfg: MoECfg,
             dtype=torch.float32) -> dict:
    e, ff = cfg.n_experts, cfg.d_ff
    return {
        "router": dense_init(gen, (d_model, e), 0, torch.float32),
        "w1": dense_init(gen, (e, d_model, ff), 1, dtype),
        "w3": dense_init(gen, (e, d_model, ff), 1, dtype),
        "w2": dense_init(gen, (e, ff, d_model), 1, dtype),
    }


def _route(x2d: torch.Tensor, router: torch.Tensor, cfg: MoECfg):
    """x2d [T, d] -> (gates [T, k] fp32, experts [T, k] int32).

    ``torch.topk`` and ``jax.lax.top_k`` may order equal probabilities
    differently; with random float inputs ties do not arise."""
    logits = x2d.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk:
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, experts.to(torch.int32)


def _dispatch_indices(experts: torch.Tensor, n_experts: int,
                      capacity: int) -> torch.Tensor:
    """Sort-based dispatch bookkeeping.

    experts [T, k] -> slot [T*k]: the target buffer slot, or E*C if
    dropped.  Rank within expert on the sorted stream: pos_i = i -
    start_of_segment(expert_i)."""
    t, k = experts.shape
    flat = experts.reshape(-1).long()                   # [T*k]
    perm = torch.argsort(flat, stable=True)             # sorted by expert
    sorted_e = flat[perm]
    counts = torch.zeros(n_experts, dtype=flat.dtype,   # [E] (a bincount
                         device=flat.device).index_add_(  # that runs on
        0, flat, torch.ones_like(flat))                     # meta too)
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=flat.device) - seg_start[sorted_e]
    keep = pos < capacity
    slot_sorted = torch.where(keep, sorted_e * capacity + pos,
                              n_experts * capacity)     # overflow -> dropped
    slot = torch.zeros((t * k,), dtype=torch.int32, device=flat.device)
    slot[perm] = slot_sorted.to(torch.int32)
    return slot


def _expert_ffn(buf: torch.Tensor, w1, w3, w2, act: str) -> torch.Tensor:
    """buf [E, C, d] -> [E, C, d_out]."""
    h = torch.bmm(buf, w1)
    u = torch.bmm(buf, w3)
    h = act_fn(act)(h) * u
    return torch.bmm(h, w2)


# ---------------------------------------------------------------------------
# The bodies
# ---------------------------------------------------------------------------

def _capacity(t: int, cfg: MoECfg) -> int:
    """Pairs an expert takes from ``t`` tokens: all of them where the
    configuration is dropless, else the reference's capacity."""
    if cfg.dropless:
        return t
    return max(8, int(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts))


def _count(pairs: int, rows: int) -> None:
    reg = get_registry()
    reg.counter("moe.routed_pairs").inc(pairs)
    reg.counter("moe.expert_rows").inc(rows)


def _moe_tp_core(x, router, w1, w3, w2, *, cfg: MoECfg, act: str,
                 plan: Plan = LOCAL, tp_split: bool = False):
    """Dispatch on this data shard's tokens; w1/w3 [E, d, ff_l], w2
    [E, ff_l, d] whole on d; ``tp_split``: ff split over "model" (the
    experts' x takes its grads summed over "model", their output is
    summed over it)."""
    x_exp = plan.sum_grad(x, (MODEL_AXIS,)) if tp_split else x
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, experts = _route(x2d, router, cfg)
    e = cfg.n_experts
    capacity = _capacity(t, cfg)
    _count(t * cfg.top_k, e * capacity)
    slot = _dispatch_indices(experts, e, capacity).long()
    # scatter tokens (duplicated per k) into the capacity buffer; every
    # dropped pair lands on the extra last row, which is discarded
    buf = x.new_zeros((e * capacity + 1, d))
    buf[slot] = torch.repeat_interleave(x_exp.reshape(t, d), cfg.top_k,
                                        dim=0)
    out_buf = _expert_ffn(buf[:-1].reshape(e, capacity, d), w1, w3, w2, act)
    if tp_split:
        out_buf = plan.psum_model(out_buf)
    out_flat = torch.cat([out_buf.reshape(e * capacity, d),
                          out_buf.new_zeros((1, d))], 0)
    yk = out_flat[slot]                          # [T*k, d], 0 if dropped
    yk = yk * gates.reshape(-1, 1).to(yk.dtype)
    return yk.reshape(t, cfg.top_k, d).sum(dim=1).reshape(b, s, d)


def _moe_ep_core(x, router, w1, w3, w2, *, cfg: MoECfg, act: str,
                 plan: Plan):
    """Expert-parallel dispatch; w1/w3 [E/tp, d, ff], w2 [E/tp, ff, d]
    (this rank's experts, whole).

    x enters replicated over "model" (it is sharded over the data axes
    only), so the tokens are first SPLIT across the model axis — each model
    shard dispatches its own 1/tp slice.  Then: local sort-based dispatch,
    all_to_all over "model", whole-expert FFN, all_to_all back, combine,
    and a final all_gather restores model-replication of the output."""
    group = plan.group(MODEL_AXIS)
    tp_size = plan.tp
    x = plan.sum_grad(x, (MODEL_AXIS,))
    b, s, d = x.shape
    t = b * s // tp_size                         # tokens per model shard
    x2d = plan.mine(x.reshape(b * s, d), 0)
    gates, experts = _route(x2d, router, cfg)
    e = cfg.n_experts
    e_local = e // tp_size
    # capacity per (destination shard, local expert) buffer
    capacity = _capacity(t, cfg)
    _count(t * cfg.top_k, e * capacity)
    slot = _dispatch_indices(experts, e, capacity).long()  # global experts
    buf = x.new_zeros((e * capacity + 1, d))
    buf[slot] = torch.repeat_interleave(x2d, cfg.top_k, dim=0)
    send = buf[:-1].reshape(tp_size, e_local * capacity, d)
    recv = all_to_all(send, group)               # [tp, E_l*C, d]
    recv = recv.reshape(tp_size, e_local, capacity, d) \
        .transpose(0, 1).reshape(e_local, tp_size * capacity, d)
    out = _expert_ffn(recv, w1, w3, w2, act)     # whole local experts
    out = out.reshape(e_local, tp_size, capacity, d) \
        .transpose(0, 1).reshape(tp_size, e_local * capacity, d)
    back = all_to_all(out, group)
    out_flat = torch.cat([back.reshape(e * capacity, d),
                          back.new_zeros((1, d))], 0)
    yk = out_flat[slot] * gates.reshape(-1, 1).to(x.dtype)
    y2d = yk.reshape(t, cfg.top_k, d).sum(dim=1)  # [t, d] (my slice)
    return GatherOutput.apply(y2d, group, 0).reshape(b, s, d)


def use_ep(cfg: MoECfg, mesh, tokens: int) -> bool:
    """The reference's condition for the "ep" body."""
    tp_size = mesh_sizes(mesh).get(MODEL_AXIS, 1)
    return (cfg.parallelism == "ep" and cfg.n_experts % tp_size == 0
            and tp_size > 1 and tokens % tp_size == 0)


def moe_local(p: dict, specs, x: torch.Tensor, cfg: MoECfg, act: str,
              plan: Plan = LOCAL) -> torch.Tensor:
    """The layer on this rank's shards (``p`` placed by ``specs``): on the
    AP inside ``ap_serving`` (on a mesh every rank runs the whole layer
    and keeps its rows, :meth:`~.collectives.Plan.whole`); else "ep" where :func:`use_ep` allows it
    (each model rank routes its own tokens, the experts gathered whole and
    this rank's kept), else "tp" (the experts gathered over "data", ff
    split over "model" where ``specs`` splits it).  Without a mesh
    (:data:`~.collectives.LOCAL`, :data:`~.collectives.WHOLE`) the whole
    layer on one device."""
    from ..apc.layers import current_ap_context
    ctx = current_ap_context()
    if ctx is not None:                      # AP-backed serving path
        return plan.whole(lambda pw, xw: moe_ffn_ap(pw, xw, cfg, act, ctx),
                          p, specs, x)
    ep = use_ep(cfg, plan.mesh, x.shape[0] * x.shape[1])
    router = plan.full(p["router"], specs["router"], model_varying=ep)
    if ep:
        ws = [plan.mine(plan.full(p[k], specs[k], gather_model=True,
                                  model_reduce=True), 0)
              for k in ("w1", "w3", "w2")]
        return _moe_ep_core(x, router, *ws, cfg=cfg, act=act, plan=plan)
    ws = [plan.full(p[k], specs[k]) for k in ("w1", "w3", "w2")]
    return _moe_tp_core(x, router, *ws, cfg=cfg, act=act, plan=plan,
                        tp_split=plan.split(specs["w1"]))


def moe_ffn_ap(p: dict, x: torch.Tensor, cfg: MoECfg, act: str,
               ctx) -> torch.Tensor:
    """AP-served MoE: router runs in float, then every routed expert's
    SwiGLU projections go through :func:`repro_torch.apc.layers.
    ap_moe_dispatch` as independent tiled-MAC subgraphs of one
    ProgramGraph — tiles of different experts interleave across the array
    bank.  Expert weights ternarize (absmean per-channel) via the
    context's per-stack cache.  No capacity drop: every routed pair is
    served."""
    from ..apc.layers import ap_moe_dispatch
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    gates, experts = _route(x2d, p["router"], cfg)
    _count(b * s * cfg.top_k, b * s * cfg.top_k)
    w1l = ctx.expert_linears("moe.w1", p["w1"], label="moe.w1.")
    w3l = ctx.expert_linears("moe.w3", p["w3"], label="moe.w3.")
    w2l = ctx.expert_linears("moe.w2", p["w2"], label="moe.w2.")
    y2d = ap_moe_dispatch(ctx, x2d, experts, gates, w1l, w3l, w2l,
                          act_fn(act))
    return y2d.reshape(b, s, d).to(x.dtype)


# the reference's in-specs of its MoE shard_map, by whether "ep" is taken
REF_SPECS = {
    False: {"router": (), "w1": (None, "data", MODEL_AXIS),
            "w3": (None, "data", MODEL_AXIS), "w2": (None, MODEL_AXIS, "data")},
    True: {"router": (), "w1": (MODEL_AXIS,), "w3": (MODEL_AXIS,),
           "w2": (MODEL_AXIS,)},
}


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoECfg, act: str, *,
            mesh=None) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: route, dispatch at capacity
    ``max(8, int(T*k*cf/E))``, or T where dropless (T: the tokens of one
    data shard under "tp", of one (data x model) slice under "ep"), run
    the experts, combine; on the AP inside ``ap_serving``.  On a named mesh
    :func:`moe_local` runs under ``local_map``: ``x`` over the data axes
    (where they divide its batch), each DTensor weight as placed; a plain
    weight (the same on every rank) takes the reference's ``shard_map``
    in-spec (:data:`REF_SPECS`), sliced locally."""
    if not is_named_mesh(mesh):
        return moe_local(p, WHOLE, x, cfg, act)
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    from .sharded import spec_of
    names = ("router", "w1", "w3", "w2")
    plan = Plan(mesh, x.shape[0])
    ref = REF_SPECS[use_ep(cfg, plan.mesh, x.shape[0] * x.shape[1])]
    ws = [p[k] if isinstance(p[k], DTensor) else distribute_tensor(
        p[k], mesh, placements(ref[k], mesh, p[k].shape), src_data_rank=None)
        for k in names]
    specs = dict(zip(names, (spec_of(w, mesh) for w in ws)))
    x_spec = (plan.da, None, None)

    def body(x, *ws):
        return moe_local(dict(zip(names, ws)), specs, x, cfg, act, plan)
    fn = local_map(body, out_placements=list(placements(x_spec, mesh)),
                   in_placements=(placements(x_spec, mesh),
                                  *(placements(specs[k], mesh)
                                    for k in names)),
                   redistribute_inputs=True, device_mesh=mesh)
    if not isinstance(x, DTensor):
        x = distribute_tensor(x, mesh, placements((), mesh),
                              src_data_rank=None)
    return fn(x, *ws)
