"""Top-level LM: embedding -> layer stack -> head, + the serve paths.

The parameter tree is the reference's: the layer stack lives under
``stack/pos_i`` (one entry per position of the config's layer pattern,
each leaf with a leading axis of ``n_sb`` super-blocks), layers that do not
fill a whole super-block under ``rest_j``, an encoder under ``enc_stack`` /
``enc_norm``.  Here the stack is a Python loop over that leading axis,
each super-block (one repetition of the layer pattern) under the
activation-checkpoint policy ``cfg.remat`` (:func:`remat_wrap`) while
autograd records.

One body computes every pass, :func:`_forward_local` / :func:`_decode_local`
over the layers of :mod:`.blocks`, on one rank's shards under a
:class:`~.collectives.Plan`.  ``mesh=`` (keyword) takes ``None`` or a list
of devices (one device's math: the plan's collectives are identities), or
a named :class:`~torch.distributed.device_mesh.DeviceMesh`: then the
params and the batch are DTensors
(:func:`~repro_torch.models.common.shard_tree`), the body runs under one
``local_map`` (:func:`.sharded.run_local`) and :func:`_constrain` places
the logits where the reference constrains them.

The reference casts every block's float leaves and the embedding table to
the compute dtype inside each call, where XLA fuses the casts.  Eagerly on
the card that would re-read every fp32 weight at every step, so the port
casts once: :func:`cast_params` after loading, and :func:`forward` /
:func:`decode_step` take the cast tree (and refuse another).  Callers run
them under ``torch.inference_mode()``; training differentiates
``forward(cfg, cast_params(cfg, params), batch)`` through the cast
(:mod:`repro_torch.train.train_step`).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeCell
from ..device import resolve_device
from . import blocks as blk
from . import sharded
from .collectives import LOCAL, WHOLE, Plan
from .common import (MODEL_AXIS, MetaGen, dot_unread, dtype_of, embed_init,
                     dense_init, is_named_mesh, mesh_data_axes, placements,
                     rms_norm)

Params = dict


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------

def _layer_plan(cfg: ModelConfig) -> tuple[int, list[tuple[str, str]], int]:
    """(n_superblocks, pattern [(mixer, ffn)] , n_rest_layers)."""
    period = cfg.pattern_period
    pattern = [(cfg.mixer_at(i), cfg.ffn_at(i)) for i in range(period)]
    n_sb = cfg.n_layers // period
    n_rest = cfg.n_layers - n_sb * period
    return n_sb, pattern, n_rest


# "dots": the products without batch dimensions (the projections, x @ w on
# [B, S, d] folds to one mm) are saved, the rest is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """Save a product without batch dimensions unless the backward pass
    never reads it (:func:`~repro_torch.models.common.unread_dot`: the
    product that feeds only the super-block's output), recompute the
    rest: the residuals ``checkpoint_dots_with_no_batch_dims`` keeps."""
    if func in _DOTS and not dot_unread():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, cfg: ModelConfig):
    """``fn`` (a super-block body, ``x`` first) under ``cfg.remat``:
    ``"none"`` the function itself; ``"full"`` saves nothing and recomputes
    the body in the backward pass; ``"dots"`` saves the ``aten.mm`` /
    ``aten.addmm`` products that the backward reads (:func:`dots_policy`)
    and recomputes the batched products and the elementwise ops, as
    ``checkpoint_dots_with_no_batch_dims`` does.  The three give the same
    grads.  Where autograd does not record (``x`` needs no grad, or under
    ``inference_mode``) every policy runs ``fn`` as is."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, dots_policy)}
    else:
        raise ValueError(f"remat={cfg.remat!r}: not none, dots or full")

    def wrapped(x, *args):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return fn(x, *args)
        return checkpoint(fn, x, *args, use_reentrant=False, **kw)
    return wrapped


def _tree_map(fn, tree: dict, path: str = "") -> dict:
    """``fn(leaf, path)`` over a nested dict, '/'-joined paths."""
    return {k: _tree_map(fn, v, f"{path}{k}/") if isinstance(v, dict)
            else fn(v, f"{path}{k}") for k, v in tree.items()}


def _stack(trees: list[dict]) -> dict:
    """Identical trees -> one tree whose leaves carry a leading axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def _unstack(tree: dict, n: int) -> list[dict]:
    """The inverse of :func:`_stack`, as views (writes reach the stack)."""
    out: list[dict] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


# ---------------------------------------------------------------------------
# Init and the one cast
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random weights from ``seed`` in the reference's tree, in
    ``cfg.param_dtype`` on ``device`` (``None`` = ``cuda:0``; ``"meta"``
    builds the tree from shapes alone)."""
    dev = resolve_device(device)
    if dev.type == "meta":                  # shapes only (the dry-run)
        gen = MetaGen()
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    n_sb, pattern, n_rest = _layer_plan(cfg)
    cross = cfg.enc_layers > 0
    params: Params = {
        "embed": {"table": embed_init(gen, (cfg.vocab, cfg.d_model), dtype)},
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(
            gen, (cfg.d_model, cfg.vocab), 0, dtype)}

    def make_stacked(kinds: tuple[str, str], n: int, use_cross: bool):
        return _stack([blk.init_block(gen, cfg, kinds[0], kinds[1],
                                      cross=use_cross, dtype=dtype)
                       for _ in range(n)])

    if n_sb > 0:
        params["stack"] = {f"pos_{i}": make_stacked(kinds, n_sb, cross)
                           for i, kinds in enumerate(pattern)}
    for j in range(n_rest):
        kinds = pattern[j % len(pattern)]
        params[f"rest_{j}"] = blk.init_block(gen, cfg, kinds[0], kinds[1],
                                             cross=cross, dtype=dtype)
    if cfg.enc_layers:
        params["enc_stack"] = {"pos_0": make_stacked(
            ("attn", "mlp"), cfg.enc_layers, False)}
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                        device=dev)
    return params


def _cast_dtype(leaf: torch.Tensor, path: str, cdt: torch.dtype):
    """What :func:`cast_params` makes of a floating leaf: the compute dtype,
    except the packed MLP's ``*_scale``, which is rounded through it and
    kept fp32 for the kernel.  None for integer leaves (kept as they are)."""
    if not leaf.is_floating_point():
        return None
    return torch.float32 if path.endswith("_scale") else cdt


def cast_params(cfg: ModelConfig, params: Params) -> Params:
    """Every floating leaf in the compute dtype, as the reference's per-call
    casts leave them (packed ``*_scale`` rounded to it and held in fp32);
    integer leaves (packed words) untouched, in ``rest_j`` layers too."""
    cdt = dtype_of(cfg.compute_dtype)

    def cast(leaf, path):
        want = _cast_dtype(leaf, path, cdt)
        if want is None:
            return leaf
        return leaf.to(cdt).to(want)
    return _tree_map(cast, params)


def _check_cast(cfg: ModelConfig, params: Params) -> None:
    cdt = dtype_of(cfg.compute_dtype)

    def check(leaf, path):
        want = _cast_dtype(leaf, path, cdt)
        if want is not None and leaf.dtype != want:
            raise ValueError(f"param {path} is {leaf.dtype}, not {want}: "
                             f"pass the tree through cast_params(cfg, ...)")
    _tree_map(check, params)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _constrain(x: torch.Tensor, mesh, *rest) -> torch.Tensor:
    """x redistributed to P(data_axes, *rest) on a named mesh; the identity
    for ``None``, a list of devices, or a plain tensor.  data_axes adapts to
    the mesh: ("pod","data") multi-pod, ("data",) single-pod; an axis that
    does not divide its dim is dropped."""
    if not is_named_mesh(mesh):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements((mesh_data_axes(mesh), *rest), mesh, x.shape)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def _embed(params: Params, specs, tokens, plan: Plan):
    """The table's rows for ``tokens``: vocab-parallel where the rows are
    split over "model" (each shard looks up the tokens of its rows, the
    sum over "model" completes them)."""
    spec = specs["embed"]["table"]
    tab = plan.full(params["embed"]["table"], spec)
    if not plan.split(spec):
        return tab[tokens]
    v_l = tab.shape[0]
    local = tokens.long() - plan.rank(MODEL_AXIS) * v_l
    ok = (local >= 0) & (local < v_l)
    rows = tab[local.clamp(0, v_l - 1)] * ok[..., None].to(tab.dtype)
    return plan.psum_model(rows)


def _embed_scaled(cfg: ModelConfig, params: Params, specs, tokens,
                  plan: Plan):
    x = _embed(params, specs, tokens, plan)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype_of(
            cfg.compute_dtype), device=x.device)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


def _logits(cfg: ModelConfig, params: Params, specs, x, plan: Plan):
    """This rank's vocab slice of the logits (all of them where the vocab
    is whole over "model")."""
    if cfg.tie_embeddings:
        w, sw = params["embed"]["table"], specs["embed"]["table"]
    else:
        w, sw = params["lm_head"]["w"], specs["lm_head"]["w"]
    w = plan.full(w, sw)
    if plan.split(sw):
        x = plan.sum_grad(x, (MODEL_AXIS,))
    logits = x @ (w.T if cfg.tie_embeddings else w)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    return logits


def _unstack_spec(tree):
    """The specs of one super-block: the stack's leading axis dropped."""
    if isinstance(tree, dict):
        return {k: _unstack_spec(v) for k, v in tree.items()}
    return tree[1:]


def _run_stack(cfg: ModelConfig, params: Params, specs, x, positions,
               plan: Plan, causal: bool, enc_out=None,
               prefix: str = "") -> torch.Tensor:
    """The (prefix-named) stacked blocks, then the remainder blocks."""
    n_sb, pattern, n_rest = _layer_plan(cfg)
    if prefix == "enc_":
        n_sb, pattern, n_rest = cfg.enc_layers, [("attn", "mlp")], 0
    last = len(pattern) - 1
    stack_key = prefix + "stack"
    has_stack = stack_key in params and n_sb > 0
    sb_specs = [_unstack_spec(specs[stack_key][f"pos_{i}"])
                for i in range(len(pattern))] if has_stack else []

    def sb_body(x, sb_params, first):
        for i, (mk, fk) in enumerate(pattern):
            x = blk.block_forward(sb_params[i], x, cfg, mk, fk, positions,
                                  causal=causal, enc_out=enc_out, plan=plan,
                                  specs=sb_specs[i], tail=i == last,
                                  layer=first + i)
        return x

    body = remat_wrap(sb_body, cfg)
    if has_stack:
        per_pos = [_unstack(params[stack_key][f"pos_{i}"], n_sb)
                   for i in range(len(pattern))]
        for sb in range(n_sb):
            x = body(x, [p[sb] for p in per_pos], sb * len(pattern))
    for j in range(n_rest):
        mk, fk = pattern[j % len(pattern)]
        x = blk.block_forward(params[f"rest_{j}"], x, cfg, mk, fk,
                              positions, causal=causal, enc_out=enc_out,
                              plan=plan, specs=specs[f"rest_{j}"],
                              layer=n_sb * len(pattern) + j)
    return x


def _forward_local(cfg: ModelConfig, params: Params, specs, batch: dict,
                   plan: Plan) -> torch.Tensor:
    """The forward pass on this rank's shards (one device: the whole)."""
    cdt = dtype_of(cfg.compute_dtype)
    x = _embed_scaled(cfg, params, specs, batch["tokens"], plan)
    if "embeds" in batch:                        # vlm/audio frontend stub
        x = torch.cat([batch["embeds"].to(cdt), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    enc_out = None
    if cfg.enc_layers:
        enc_in = batch.get("enc_embeds")
        if enc_in is None:
            enc_in = _embed(params, specs, batch["enc_tokens"], plan)
        e_pos = torch.arange(enc_in.shape[1], device=x.device)[None, :] \
            .expand(*enc_in.shape[:2])
        enc_out = _run_stack(cfg, params, specs, enc_in.to(cdt), e_pos,
                             plan, causal=False, prefix="enc_")
        enc_out = rms_norm(enc_out, plan.full(params["enc_norm"],
                                              specs["enc_norm"]),
                           cfg.norm_eps)
    x = _run_stack(cfg, params, specs, x, positions, plan, causal=True,
                   enc_out=enc_out)
    x = rms_norm(x, plan.full(params["final_norm"], specs["final_norm"]),
                 cfg.norm_eps)
    return _logits(cfg, params, specs, x, plan)


def forward(cfg: ModelConfig, params: Params, batch: dict, *,
            mesh=None) -> torch.Tensor:
    """batch: tokens [B, S_tok], optional embeds [B, n_front, d], optional
    enc_tokens/enc_embeds for enc-dec.  ``params`` from
    :func:`cast_params`.  Returns logits [B, S, V] in the compute dtype; on
    a named mesh a DTensor, batch over the data axes and vocab over
    "model" (a batch of plain tensors is taken as each rank's full
    copy)."""
    _check_cast(cfg, params)
    if not is_named_mesh(mesh):
        return _forward_local(cfg, params, WHOLE, batch, LOCAL)
    batch, b_specs = sharded.place_batch(batch, mesh)
    plan = Plan(mesh, batch["tokens"].shape[0], cfg.attn_batch_split)
    specs = sharded.specs_of(params, mesh)
    out_spec = (plan.da, None) + sharded.vocab_spec(cfg, specs)
    logits = sharded.run_local(
        mesh, lambda p, bt: _forward_local(cfg, p, specs, bt, plan),
        out_spec, (params, batch), (specs, b_specs))
    return _constrain(logits, mesh, None, "model")


# ---------------------------------------------------------------------------
# Serving: cache init + decode step
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               cross_len: int = 0, dtype=torch.bfloat16,
               device=None) -> dict:
    """Zeroed decode state for ``batch`` sequences of up to ``seq_len``
    tokens, on ``device`` (``None`` = ``cuda:0``).  KV entries are ``dtype``
    (bf16 by default, under fp32 compute too, as in the reference); mamba
    state is fp32."""
    dev = resolve_device(device)
    n_sb, pattern, n_rest = _layer_plan(cfg)
    cross_len = cross_len if cfg.enc_layers else 0

    cache: dict = {}
    if n_sb > 0:
        cache["stack"] = {f"pos_{i}": _stack([blk.init_block_cache(
            cfg, mk, batch, seq_len, cross_len, dtype, dev)
            for _ in range(n_sb)]) for i, (mk, _) in enumerate(pattern)}
    for j in range(n_rest):
        mk, _ = pattern[j % len(pattern)]
        cache[f"rest_{j}"] = blk.init_block_cache(cfg, mk, batch, seq_len,
                                                  cross_len, dtype, dev)
    return cache


def _decode_local(cfg: ModelConfig, params: Params, specs, cache: dict,
                  c_specs, tokens, pos: int, plan: Plan) -> torch.Tensor:
    """One decode step on this rank's shards; the cache written in
    place."""
    n_sb, pattern, n_rest = _layer_plan(cfg)
    x = _embed_scaled(cfg, params, specs, tokens, plan)[:, None, :]
    if n_sb > 0:
        per_pos = [(_unstack(params["stack"][f"pos_{i}"], n_sb),
                    _unstack(cache["stack"][f"pos_{i}"], n_sb),
                    _unstack_spec(specs["stack"][f"pos_{i}"]),
                    _unstack_spec(c_specs["stack"][f"pos_{i}"]))
                   for i in range(len(pattern))]
        for sb in range(n_sb):
            for i, (mk, fk) in enumerate(pattern):
                p_i, c_i, s_i, cs_i = per_pos[i]
                x = blk.block_decode(p_i[sb], x, c_i[sb], cfg, mk, fk, pos,
                                     plan=plan, specs=s_i, cache_specs=cs_i,
                                     layer=sb * len(pattern) + i)
    for j in range(n_rest):
        mk, fk = pattern[j % len(pattern)]
        x = blk.block_decode(params[f"rest_{j}"], x, cache[f"rest_{j}"],
                             cfg, mk, fk, pos, plan=plan,
                             specs=specs[f"rest_{j}"],
                             cache_specs=c_specs[f"rest_{j}"],
                             layer=n_sb * len(pattern) + j)
    x = rms_norm(x, plan.full(params["final_norm"], specs["final_norm"]),
                 cfg.norm_eps)
    return _logits(cfg, params, specs, x[:, 0], plan)


def decode_step(cfg: ModelConfig, params: Params, cache: dict,
                tokens: torch.Tensor, pos: int, *, mesh=None
                ) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens [B] int, ``pos`` an int -> (logits [B, V],
    cache).  ``params`` from :func:`cast_params`; ``cache`` (from
    :func:`init_cache`; on a named mesh DTensors placed by
    :func:`.sharded.cache_specs`) is updated in place and returned."""
    _check_cast(cfg, params)
    pos = int(pos)
    if not is_named_mesh(mesh):
        return _decode_local(cfg, params, WHOLE, cache, WHOLE, tokens, pos,
                             LOCAL), cache
    t, t_specs = sharded.place_batch({"tokens": tokens}, mesh)
    # one token: no batch split (the reference splits sequences > 1)
    plan = Plan(mesh, tokens.shape[0])
    specs = sharded.specs_of(params, mesh)
    c_specs = sharded.specs_of(cache, mesh)
    out_spec = (plan.da,) + sharded.vocab_spec(cfg, specs)
    logits = sharded.run_local(mesh, lambda p, c, bt: _decode_local(
        cfg, p, specs, c, c_specs, bt["tokens"], pos, plan), out_spec,
        (params, cache, t), (specs, c_specs, t_specs))
    return _constrain(logits, mesh, "model"), cache


# ---------------------------------------------------------------------------
# Input specs (meta stand-ins for the dry-run)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, cell: ShapeCell,
                cache_dtype=torch.bfloat16) -> dict:
    """``meta`` tensors for every model input of the given shape cell, in
    the reference's shapes and dtypes (``pos`` a 0-d int32)."""
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32
    cdt = dtype_of(cfg.compute_dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind in ("train", "prefill"):
        n_front = cfg.n_frontend_tokens if cfg.frontend else 0
        spec = {"tokens": meta((b, s - n_front), i32)}
        if cfg.frontend:
            spec["embeds"] = meta((b, n_front, cfg.d_model), cdt)
        if cfg.enc_layers:
            spec["enc_embeds"] = meta((b, min(s, 4096), cfg.d_model), cdt)
        if cell.kind == "train":
            spec["targets"] = meta((b, s - n_front), i32)
        return spec
    # decode: one token against a seq_len cache
    cross_len = min(s, 4096) if cfg.enc_layers else 0
    return {"tokens": meta((b,), i32), "pos": meta((), i32),
            "cache": init_cache(cfg, b, s, cross_len, cache_dtype,
                                device="meta")}
