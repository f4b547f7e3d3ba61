"""The port's training step and optimizer against the reference's, on the
CPU at smoke size.

Both packages start from the reference's state (``init_train_state``,
carried across by ``convert.train_state_from_arrays``) and take the same
batch (``repro_torch.data.TokenSource``, bit-identical to the
reference's).  The reference runs its jitted step, as its own tests do.

Tolerances, fp32 compute: loss and ``grad_norm`` within 1e-5 relative;
every grad leaf within 1e-4 of the leaf's largest |g|; the optimizer
within 1e-6 on the same grads; params after a step within 1e-4, leaving
out the elements whose reference grad is under 1e-4 of the leaf's largest
|g| (but not 0): there the first AdamW update is about lr times the
grad's sign, and the sign of a grad at rounding level is noise.  bf16 compute: the loss
within 5e-2 (the reference tests' bf16 tolerance).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import TernaryCfg as RefTernaryCfg
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_ts
from repro_torch import configs
from repro_torch.configs.base import TernaryCfg
from repro_torch.convert import params_from_arrays, train_state_from_arrays
from repro_torch.data import DataCfg, TokenSource
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

STEP_ARCHS = ("qwen3-0.6b", "yi-34b", "mamba2-2.7b", "gemma3-27b",
              "qwen3-moe-30b-a3b")
BATCH, SEQ = 2, 48          # SEQ > gemma3 smoke's sliding window of 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=20)
LOSS_RTOL, GRAD_TOL, PARAM_TOL, OPT_TOL, BF16_TOL = 1e-5, 1e-4, 1e-4, \
    1e-6, 5e-2


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(
        a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating)
        else a), tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _configs(arch, qat=False, **kw):
    """(reference config, port config), equal fields; ``qat`` turns on
    the straight-through ternary training of the MLPs."""
    return (get_smoke_config(arch).with_(ternary=RefTernaryCfg(qat=qat),
                                         **kw),
            configs.get_smoke_config(arch).with_(ternary=TernaryCfg(qat=qat),
                                                 **kw))


def _batch(vocab, batch=BATCH, seq=SEQ, step=0):
    """The same batch for both packages: (reference, port)."""
    arrays = TokenSource(DataCfg(vocab=vocab, global_batch=batch,
                                 seq_len=seq, seed=5)).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _leaves(tree) -> list[np.ndarray]:
    """Either package's tree in flatten order (sorted keys, as
    ``jax.tree.leaves`` orders a dict), as fp32 numpy."""
    return [_f32(x) for x in opt.tree_leaves(tree)]


def _grads_close(got, want):
    for g, w in zip(_leaves(got), _leaves(want), strict=True):
        scale = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, (
            np.abs(g - w).max(), scale)


def _params_close(got, want, want_grads) -> tuple[int, int]:
    """Params within PARAM_TOL where the reference grad is 0 or at least
    GRAD_TOL of its leaf's largest |g|; -> (left out, compared)."""
    out = total = 0
    for p, w, g in zip(_leaves(got), _leaves(want), _leaves(want_grads),
                       strict=True):
        keep = (g == 0) | (np.abs(g) >= GRAD_TOL * float(np.abs(g).max()))
        np.testing.assert_allclose(p[keep], w[keep], atol=PARAM_TOL,
                                   rtol=0)
        out += int((~keep).sum())
        total += keep.size
    return out, total


@functools.lru_cache(maxsize=None)
def _ref_step_fn(ref_cfg, microbatches=1):
    """The reference's jitted step, returning its grads beside it."""
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("pod", "data", "model"))
    loss_fn = ref_ts.make_loss_fn(ref_cfg, mesh)
    step = ref_ts.make_train_step(ref_cfg, mesh, ref_opt.AdamWCfg(**OPT),
                                  microbatches=microbatches)

    def fn(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state["params"], batch)
        new, metrics = step(state, batch)
        return loss, grads, new, metrics

    jitted = jax.jit(fn)

    def run(state, batch):
        with mesh:
            return jitted(state, batch)
    return run


@functools.lru_cache(maxsize=None)
def _ref_state(ref_cfg, seed=0):
    return ref_ts.init_train_state(ref_cfg, jax.random.PRNGKey(seed))


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 60, 100, 150])
def test_schedule_matches_reference(step):
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    got = opt.schedule(opt.AdamWCfg(**cfg), torch.tensor(step))
    want = ref_opt.schedule(ref_opt.AdamWCfg(**cfg), jnp.int32(step))
    np.testing.assert_allclose(float(got), float(want), rtol=OPT_TOL)


def test_schedule_warmup_and_decay():
    cfg = opt.AdamWCfg(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(opt.schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(opt.schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(opt.schedule(cfg, torch.tensor(100))) < 0.2


def test_adamw_reduces_loss_on_quadratic():
    cfg = opt.AdamWCfg(lr=0.1, warmup_steps=1, total_steps=100,
                       weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init_opt_state(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}          # d/dw of w^2
        params, state, _ = opt.adamw_update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.5
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 60


def test_adamw_update_matches_reference():
    """Three updates of the qwen3 smoke tree on seeded grads, grad_norm
    above the clip; every param, m and v within 1e-6.  Decay reaches the
    stacked norm scales ([n_sb, d] leaves, ndim 2) and not final_norm, in
    both packages (ROADMAP queue 3)."""
    ref_cfg, _ = _configs("qwen3-0.6b")
    cfg_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    ref_p = ref_ts.init_train_state(ref_cfg, jax.random.PRNGKey(3))["params"]
    mine = params_from_arrays(_np(ref_p), device="cpu")
    ref_state, my_state = ref_opt.init_opt_state(ref_p), \
        opt.init_opt_state(mine)
    ref_update = jax.jit(functools.partial(ref_opt.adamw_update,
                                           ref_opt.AdamWCfg(**cfg_kw)))
    rng = np.random.default_rng(0)
    for _ in range(3):
        g_np = jax.tree.map(lambda a: rng.normal(
            0, 2, a.shape).astype(np.float32), _np(ref_p))
        ref_p, ref_state, ref_m = ref_update(
            jax.tree.map(jnp.asarray, g_np), ref_state, ref_p)
        mine, my_state, my_m = opt.adamw_update(
            opt.AdamWCfg(**cfg_kw), params_from_arrays(g_np, "cpu"),
            my_state, mine)
        assert float(ref_m["grad_norm"]) > 1.0
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(my_m[k]), float(ref_m[k]),
                                       rtol=OPT_TOL)
        for tree, want in ((mine, ref_p), (my_state["m"], ref_state["m"]),
                           (my_state["v"], ref_state["v"])):
            for a, b in zip(_leaves(tree), _leaves(want), strict=True):
                np.testing.assert_allclose(a, b, atol=OPT_TOL, rtol=OPT_TOL)
        assert int(my_state["step"]) == int(ref_state["step"])


def test_weight_decay_reaches_stacked_norms_as_in_reference():
    """Zero grads: only decay moves a leaf.  Every leaf with ndim >= 2
    decays, the stacked norm scales ([n_sb, d]) among them; the unstacked
    final_norm does not (ROADMAP queue 3), in both packages."""
    ref_cfg, _ = _configs("qwen3-0.6b")
    cfg_kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    ref_p = ref_ts.init_train_state(ref_cfg, jax.random.PRNGKey(3))["params"]
    zeros = jax.tree.map(jnp.zeros_like, ref_p)
    ref_new, _, _ = jax.jit(functools.partial(
        ref_opt.adamw_update, ref_opt.AdamWCfg(**cfg_kw)))(
            zeros, ref_opt.init_opt_state(ref_p), ref_p)
    mine = params_from_arrays(_np(ref_p), device="cpu")
    my_new, _, _ = opt.adamw_update(
        opt.AdamWCfg(**cfg_kw), opt.tree_map(torch.zeros_like, mine),
        opt.init_opt_state(mine), mine)
    for new in (_np(ref_new), opt.tree_map(_f32, my_new)):
        np.testing.assert_allclose(new["stack"]["pos_0"]["norm1"],
                                   1 - 1e-2 * 0.1, rtol=OPT_TOL)
        np.testing.assert_array_equal(new["final_norm"], 1.0)


# ---------------------------------------------------------------------------
# One train step against the reference
# ---------------------------------------------------------------------------

def _one_step(arch, dtype, qat=False):
    """One step of each package from the reference's state on one batch:
    (loss, grads, new state, metrics) of each."""
    ref_cfg, cfg = _configs(arch, qat=qat, compute_dtype=dtype,
                            remat="none")
    ref_state = _ref_state(ref_cfg)
    ref_b, my_b = _batch(cfg.vocab)
    loss, grads, new, metrics = _ref_step_fn(ref_cfg)(ref_state, ref_b)
    mine = train_state_from_arrays(_np(ref_state), device="cpu")
    my_loss, my_grads = ts.value_and_grad(ts.make_loss_fn(cfg),
                                          mine["params"], my_b)
    my_new, my_metrics = ts.make_train_step(cfg, opt.AdamWCfg(**OPT))(
        mine, my_b)
    return (loss, grads, new, metrics), (my_loss, my_grads, my_new,
                                         my_metrics)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_reference_fp32(arch):
    (loss, grads, new, metrics), (my_loss, my_grads, my_new, my_metrics) = \
        _one_step(arch, "float32")
    for a, b in ((my_loss, loss), (my_metrics["loss"], metrics["loss"]),
                 (my_metrics["grad_norm"], metrics["grad_norm"])):
        np.testing.assert_allclose(float(a), float(b), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(my_metrics["lr"]), float(metrics["lr"]),
                               rtol=OPT_TOL)
    assert all(g.dtype == torch.float32 for g in opt.tree_leaves(my_grads))
    _grads_close(my_grads, grads)
    left_out, compared = _params_close(my_new["params"], new["params"],
                                       grads)
    print(f"{arch}: params compared {compared}, left out {left_out} "
          f"(reference grad under {GRAD_TOL} of the leaf's max)")
    assert left_out < 0.02 * compared
    assert int(my_new["opt"]["step"]) == int(new["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_loss_matches_reference_bf16(arch):
    ref_cfg, cfg = _configs(arch, compute_dtype="bfloat16", remat="none")
    ref_b, my_b = _batch(cfg.vocab)
    ref_state = _ref_state(ref_cfg)
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("pod", "data", "model"))
    with mesh:
        want = jax.jit(ref_ts.make_loss_fn(ref_cfg, mesh))(
            ref_state["params"], ref_b)
    mine = train_state_from_arrays(_np(ref_state), device="cpu")
    got, grads = ts.value_and_grad(ts.make_loss_fn(cfg), mine["params"],
                                   my_b)
    assert abs(float(got) - float(want)) <= BF16_TOL
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in opt.tree_leaves(grads))


def test_microbatches_match_full_batch_and_reference():
    """2 microbatches of 2 against 1 batch of 4 (the port), and against
    the reference's microbatched step."""
    ref_cfg, cfg = _configs("qwen3-0.6b", compute_dtype="float32",
                            remat="none")
    ref_b, my_b = _batch(cfg.vocab, batch=4, seq=16)
    ref_state = _ref_state(ref_cfg)
    _, grads, new, metrics = _ref_step_fn(ref_cfg, 2)(ref_state, ref_b)
    mine = train_state_from_arrays(_np(ref_state), device="cpu")
    one, m1 = ts.make_train_step(cfg, opt.AdamWCfg(**OPT))(mine, my_b)
    two, m2 = ts.make_train_step(cfg, opt.AdamWCfg(**OPT),
                                 microbatches=2)(mine, my_b)
    for m in (m1, m2):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(metrics[k]),
                                       rtol=LOSS_RTOL)
    _params_close(two["params"], one["params"], grads)
    _params_close(two["params"], new["params"], grads)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b",
                                  "qwen3-moe-30b-a3b",
                                  "seamless-m4t-medium"])
def test_remat_policies_give_identical_grads(arch):
    """remat none / dots / full: bit-identical loss and grads (the CPU
    recomputes the same ops in the same order)."""
    cfg = configs.get_smoke_config(arch).with_(compute_dtype="float32")
    state = ts.init_train_state(cfg, seed=1, device="cpu")
    _, batch = _batch(cfg.vocab)
    if cfg.enc_layers:
        batch["enc_embeds"] = torch.from_numpy(np.random.default_rng(2)
                                               .normal(size=(BATCH, 16,
                                                             cfg.d_model))
                                               .astype(np.float32))
    got = {}
    for remat in ("none", "dots", "full"):
        loss, grads = ts.value_and_grad(
            ts.make_loss_fn(cfg.with_(remat=remat)), state["params"], batch)
        got[remat] = [loss] + opt.tree_leaves(grads)
    for remat in ("dots", "full"):
        assert all(torch.equal(a, b) for a, b in zip(got["none"],
                                                     got[remat]))


def test_remat_rejects_unknown_policy():
    cfg = configs.get_smoke_config("qwen3-0.6b").with_(remat="some")
    state = ts.init_train_state(cfg, device="cpu")
    _, batch = _batch(cfg.vocab, seq=8)
    with pytest.raises(ValueError, match="remat"):
        ts.value_and_grad(ts.make_loss_fn(cfg), state["params"], batch)


def test_qat_ste_grads_match_reference():
    """Quantization-aware training: the straight-through estimator's
    grads (forward on ternarized weights, grads to the fp32 weights)."""
    (loss, grads, _, metrics), (my_loss, my_grads, _, my_metrics) = \
        _one_step("qwen3-0.6b", "float32", qat=True)
    np.testing.assert_allclose(float(my_loss), float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(my_metrics["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=LOSS_RTOL)
    _grads_close(my_grads, grads)


def test_cross_entropy_skips_frontend_positions():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 4)).astype(np.int32)
    got = ts.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(targets), n_front=3)
    want = ref_ts.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                n_front=3)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_cast_keeps_grads_in_master_dtype():
    """bf16 compute differentiates through cast_params: the grads come
    back fp32, one per master leaf, and the master tree is untouched."""
    cfg = configs.get_smoke_config("qwen3-0.6b")
    assert cfg.compute_dtype == "bfloat16"
    state = ts.init_train_state(cfg, device="cpu")
    before = [p.clone() for p in opt.tree_leaves(state["params"])]
    _, batch = _batch(cfg.vocab, seq=8)
    _, grads = ts.value_and_grad(ts.make_loss_fn(cfg), state["params"],
                                 batch)
    for g, p in zip(opt.tree_leaves(grads), before, strict=True):
        assert g.dtype == torch.float32 and g.shape == p.shape
    assert all(torch.equal(a, b) and not a.requires_grad for a, b in zip(
        opt.tree_leaves(state["params"]), before))
