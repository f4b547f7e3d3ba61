"""The port's model stack against the reference's, at smoke size on the CPU.

Weights come from the reference's ``init_params`` and are carried across
by ``convert.params_from_arrays`` (bf16 leaves through fp32); inputs are
made with numpy from a seed and given to both.  Tolerances (allclose, atol
= rtol): 1e-4 with ``compute_dtype="float32"``, 5e-2 in bf16, the
reference's kernel tests' own.  The reference runs eagerly, as its own
tests run it (the port follows its ops one by one, and in bf16 agrees with
the eager run more closely than XLA's fused ``jax.jit`` of the same model
does), except the MoE architectures: their eager ``shard_map`` takes 10-25
s a call, so they run under ``jax.jit``.

bf16 has one exception, :func:`_close_bf16`: where the reference's own bf16
run lies further than 5e-2 from its fp32 run on the same weights, the
model's bf16 rounding noise exceeds the tolerance and no port can meet it
without reproducing every rounding of XLA's CPU backend (jamba, forward
and decode: a one-ulp difference flips a near-tie of the MoE router).
There the port's bf16 run must be no further from the reference's fp32
run than 1.5 times the reference's own bf16 run is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_smoke_config
from repro.models import attention as ref_attn
from repro.models import model as ref_M
from repro.models import moe as ref_moe
from repro.models import quant as ref_quant
from repro_torch import configs
from repro_torch.convert import params_from_arrays
from repro_torch.kernels.ternary_matmul import kernel as tk
from repro_torch.models import attention, common, mlp, model, moe, quant

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
BATCH, SEQ, CACHE_LEN, DECODE_POS = 2, 48, 64, 5


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(
        a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating)
        else a), tree)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(mine, want, tol):
    np.testing.assert_allclose(_f32(mine), _f32(want), atol=tol, rtol=tol)


def _configs(arch, dtype, **kw):
    """(reference config, port config), equal fields."""
    ref = get_smoke_config(arch).with_(compute_dtype=dtype, **kw)
    mine = configs.get_smoke_config(arch).with_(compute_dtype=dtype, **kw)
    return ref, mine


def _params(ref_cfg, cfg, packed=False, seed=0):
    """The reference's weights and the port's, cast for compute."""
    ref_p = ref_M.init_params(ref_cfg, jax.random.PRNGKey(seed))
    mine = params_from_arrays(_np_tree(ref_p), device="cpu")
    if packed:
        ref_p = ref_quant.quantize_model_params(ref_p)
        mine = quant.quantize_model_params(mine)
    return ref_p, model.cast_params(cfg, mine)


def _batch(cfg, rng):
    """Matching inputs: numpy -> (reference batch, port batch)."""
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    arrays = {"tokens": rng.integers(0, cfg.vocab,
                                     (BATCH, SEQ - n_front)).astype(np.int32)}
    if cfg.frontend == "vision":
        arrays["embeds"] = rng.normal(
            0, 1, (BATCH, n_front, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        arrays["enc_embeds"] = rng.normal(
            0, 1, (BATCH, 16, cfg.d_model)).astype(np.float32)
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    mine = {k: torch.from_numpy(v) for k, v in arrays.items()}
    return ref, mine


def _ref_call(ref_cfg, fn):
    """``fn`` eagerly, or under ``jax.jit`` for an MoE architecture."""
    return jax.jit(fn) if "moe" in ref_cfg.ffn_pattern else fn


def _ref_forward(ref_cfg, ref_p, ref_b, mesh):
    with mesh:
        return _ref_call(ref_cfg, lambda p, b: ref_M.forward(
            ref_cfg, p, b, mesh))(ref_p, ref_b)


def _ref_decode(ref_cfg, ref_p, ref_cache, toks, mesh):
    with mesh:
        return _ref_call(ref_cfg, lambda p, c, t: ref_M.decode_step(
            ref_cfg, p, c, t, jnp.int32(DECODE_POS), mesh))(
                ref_p, ref_cache, toks)


def _run_forward(ref_cfg, cfg, ref_p, mine, smoke_mesh, seed=0):
    ref_b, my_b = _batch(cfg, np.random.default_rng(seed))
    want = _ref_forward(ref_cfg, ref_p, ref_b, smoke_mesh)
    with torch.inference_mode():
        got = model.forward(cfg, mine, my_b)
    assert got.shape == want.shape and got.dtype == common.dtype_of(
        cfg.compute_dtype)
    return got, want


def _run_decode(ref_cfg, cfg, ref_p, mine, smoke_mesh):
    """One step at DECODE_POS on a fresh cache: logits and the cache after."""
    cross = 16 if cfg.enc_layers else 0
    toks = np.arange(1, BATCH + 1, dtype=np.int32)
    ref_cache = ref_M.init_cache(ref_cfg, BATCH, CACHE_LEN, cross_len=cross)
    want, want_cache = _ref_decode(ref_cfg, ref_p, ref_cache,
                                   jnp.asarray(toks), smoke_mesh)
    cache = model.init_cache(cfg, BATCH, CACHE_LEN, cross_len=cross,
                             device="cpu")
    with torch.inference_mode():
        got, got_cache = model.decode_step(cfg, mine, cache,
                                           torch.from_numpy(toks), DECODE_POS)
    assert got_cache is cache
    return got, want, got_cache, want_cache


def _close_bf16(got, want, want32, tol=TOL["bfloat16"]) -> bool:
    """bf16 against the reference: within ``tol``; or, only where the
    reference's own bf16 run ``want`` is further than ``tol`` from its fp32
    run ``want32`` (unstable in bf16), no further from ``want32`` than
    1.5x ``want`` is.  Returns whether the first rule held."""
    got, want, want32 = _f32(got), _f32(want), _f32(want32)
    if np.allclose(got, want, atol=tol, rtol=tol):
        return True
    assert not np.allclose(want, want32, atol=tol, rtol=tol), (
        f"bf16 run stable in the reference, port off by "
        f"{np.abs(got - want).max()}")
    noise = float(np.abs(want - want32).max())
    assert float(np.abs(got - want32).max()) <= 1.5 * noise
    return False


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element's magnitude (0 at 0)."""
    _, e = np.frexp(x)
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


def _close_bf16_leaf(mine, want, tol):
    """A bf16 cache leaf: within ``tol`` (allclose) or within one bf16 ulp
    of ``want``.  Both sides compute the leaf in fp32 and round it to
    bf16; values that agree in fp32 to well within ``tol`` may still round
    to the two bf16 neighbours of their midpoint, one ulp apart (2**-13 =
    1.22e-4 at 0.0163, more than 1e-4), and which one each takes depends
    on the host's BLAS."""
    got, want = _f32(mine), _f32(want)
    bound = np.maximum(tol + tol * np.abs(want), _bf16_ulp(want))
    bad = np.abs(got - want) > bound
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} bf16 elements off by more than "
        f"max(allclose {tol}, one ulp); worst {np.abs(got - want).max()}")


def _close_trees(mine: dict, want: dict, tol):
    """Leaf by leaf within ``tol``, a bf16 leaf also within one bf16 ulp
    (:func:`_close_bf16_leaf`); ``tol=None`` checks shapes and that every
    value is finite."""
    assert set(mine) == set(want)
    for k, v in mine.items():
        if isinstance(v, dict):
            _close_trees(v, want[k], tol)
            continue
        assert tuple(v.shape) == tuple(want[k].shape), k
        if tol is None:
            assert bool(torch.isfinite(v.float()).all()), k
        elif v.dtype == torch.bfloat16:
            _close_bf16_leaf(v, want[k], tol)
        else:
            _close(v, want[k], tol)


# ---------------------------------------------------------------------------
# Every architecture, forward and decode, fp32 and bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch, dtype, smoke_mesh):
    ref_cfg, cfg = _configs(arch, dtype)
    ref_p, mine = _params(ref_cfg, cfg)
    got, want = _run_forward(ref_cfg, cfg, ref_p, mine, smoke_mesh)
    assert bool(torch.isfinite(got.float()).all())
    if dtype == "float32":
        _close(got, want, TOL[dtype])
    else:
        _close_bf16(got, want, _ref_forward(
            ref_cfg.with_(compute_dtype="float32"), ref_p,
            _batch(cfg, np.random.default_rng(0))[0], smoke_mesh))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step_matches_reference(arch, dtype, smoke_mesh):
    ref_cfg, cfg = _configs(arch, dtype)
    ref_p, mine = _params(ref_cfg, cfg)
    got, want, got_cache, want_cache = _run_decode(ref_cfg, cfg, ref_p, mine,
                                                   smoke_mesh)
    assert got.shape == (BATCH, cfg.vocab)
    if dtype == "float32":
        _close(got, want, TOL[dtype])
        _close_trees(got_cache, want_cache, TOL[dtype])
        return
    want32, _ = _ref_decode(
        ref_cfg.with_(compute_dtype="float32"), ref_p, ref_M.init_cache(
            ref_cfg, BATCH, CACHE_LEN, cross_len=16 if cfg.enc_layers else 0),
        jnp.arange(1, BATCH + 1, dtype=jnp.int32), smoke_mesh)
    # a run unstable in bf16 has diverged in the cache too; its values are
    # held to the reference by the fp32 case
    close = _close_bf16(got, want, want32)
    _close_trees(got_cache, want_cache, TOL[dtype] if close else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rest_layer_matches_reference(dtype, smoke_mesh):
    """gemma3 smoke at 7 layers: one super-block of 6 and one ``rest_0``
    layer (a local one), unpacked, where the reference casts every leaf."""
    ref_cfg, cfg = _configs("gemma3-27b", dtype, n_layers=7)
    ref_p, mine = _params(ref_cfg, cfg)
    assert "rest_0" in mine and "rest_1" not in mine
    got, want = _run_forward(ref_cfg, cfg, ref_p, mine, smoke_mesh)
    _close(got, want, TOL[dtype])
    got, want, got_cache, want_cache = _run_decode(ref_cfg, cfg, ref_p, mine,
                                                   smoke_mesh)
    _close(got, want, TOL[dtype])
    _close_trees(got_cache, want_cache, TOL[dtype])


# ---------------------------------------------------------------------------
# Packed ternary MLPs (plain route on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-72b", "yi-34b"])
def test_packed_model_matches_reference(arch, smoke_mesh):
    ref_cfg, cfg = _configs(arch, "float32")
    ref_p, mine = _params(ref_cfg, cfg, packed=True)
    ref_mlp = ref_p["stack"]["pos_0"]["mlp"]
    my_mlp = mine["stack"]["pos_0"]["mlp"]
    for key in quant.MLP_KEYS:
        np.testing.assert_array_equal(my_mlp[f"{key}_packed"].numpy(),
                                      np.asarray(ref_mlp[f"{key}_packed"]))
        _close(my_mlp[f"{key}_scale"], ref_mlp[f"{key}_scale"], 1e-6)
    before = dict(tk.launch_counts)
    got, want = _run_forward(ref_cfg, cfg, ref_p, mine, smoke_mesh)
    _close(got, want, TOL["float32"])
    got, want, _, _ = _run_decode(ref_cfg, cfg, ref_p, mine, smoke_mesh)
    _close(got, want, TOL["float32"])
    assert tk.launch_counts == before


def test_packed_scales_round_through_bf16(smoke_mesh):
    """Under bf16 compute the reference rounds each ``*_scale`` to bf16;
    the port's cast does the same and keeps them fp32 for the kernel."""
    ref_cfg, cfg = _configs("qwen3-0.6b", "bfloat16")
    ref_p, mine = _params(ref_cfg, cfg, packed=True)
    scale = mine["stack"]["pos_0"]["mlp"]["w1_scale"]
    assert scale.dtype == torch.float32
    assert torch.equal(scale, scale.to(torch.bfloat16).float())
    assert mine["stack"]["pos_0"]["mlp"]["w1_packed"].dtype == torch.int32
    got, want = _run_forward(ref_cfg, cfg, ref_p, mine, smoke_mesh)
    _close(got, want, TOL["bfloat16"])


def test_plain_packed_mlp_is_the_cpu_route():
    """On CPU tensors the packed branch is ``unpack_matmul`` with or without
    the context manager, and launches nothing."""
    rng = np.random.default_rng(3)
    w = {k: torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))
         for k, s in (("w1", (32, 48)), ("w3", (32, 48)), ("w2", (48, 32)))}
    p = quant.pack_mlp_params(w)
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 32)).astype(np.float32))
    before = dict(tk.launch_counts)
    y = mlp.mlp(p, x)
    with mlp.plain_packed_mlp():
        y_plain = mlp.mlp(p, x)
    want = quant.unpack_matmul(
        torch.nn.functional.silu(quant.unpack_matmul(x, p["w1_packed"],
                                                     p["w1_scale"]))
        * quant.unpack_matmul(x, p["w3_packed"], p["w3_scale"]),
        p["w2_packed"], p["w2_scale"])
    assert y.shape == (2, 3, 32)
    assert torch.equal(y, want) and torch.equal(y_plain, want)
    assert tk.launch_counts == before


def test_forward_refuses_uncast_params():
    cfg = configs.get_smoke_config("qwen3-0.6b")       # bf16 compute
    params = model.init_params(cfg, seed=0, device="cpu")
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.int64)}
    with pytest.raises(ValueError, match="cast_params"):
        model.forward(cfg, params, tokens)
    with torch.inference_mode():
        logits = model.forward(cfg, model.cast_params(cfg, params), tokens)
    assert logits.shape == (1, 4, cfg.vocab)
    assert logits.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The port's own decode-matches-forward (tests/test_models_smoke.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seq,seed,cache_dtype", [
    ("qwen3-0.6b", 12, 0, torch.float32),
    ("mamba2-2.7b", 16, 1, torch.bfloat16)])
def test_decode_matches_forward(arch, seq, seed, cache_dtype):
    cfg = configs.get_smoke_config(arch).with_(compute_dtype="float32")
    params = model.cast_params(cfg, model.init_params(cfg, seed=0,
                                                      device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, seq)))
    with torch.inference_mode():
        fwd = model.forward(cfg, params, {"tokens": toks})
        cache = model.init_cache(cfg, 2, 32, dtype=cache_dtype, device="cpu")
        outs = [model.decode_step(cfg, params, cache, toks[:, i], i)[0]
                for i in range(seq)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), fwd.numpy(),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,k,e,cap", [(16, 2, 4, 8), (37, 2, 8, 3),
                                       (64, 1, 4, 8), (5, 3, 6, 1)])
def test_dispatch_indices_bit_for_bit(t, k, e, cap):
    experts = np.random.default_rng(t).integers(0, e, (t, k)).astype(
        np.int32)
    want = np.asarray(ref_moe._dispatch_indices(jnp.asarray(experts), e, cap))
    got = moe._dispatch_indices(torch.from_numpy(experts), e, cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == e * cap).any() == (np.bincount(
        experts.reshape(-1), minlength=e) > cap).any()


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_attend_blockwise_matches_reference(causal, window):
    """S = 64 in blocks of 16, GQA 4 heads over 2, fp32, within 1e-4."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(0, 1, (2, 64, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    want = ref_attn.attend_blockwise(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, block_q=16, block_k=16)
    tq, tk_, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = attention.attend_blockwise(tq, tk_, tv, causal=causal,
                                     window=window, block_q=16, block_k=16)
    _close(got, want, 1e-4)
    _close(got, attention.attend_dense(tq, tk_, tv, causal=causal,
                                       window=window), 1e-4)


def test_gelu_is_jax_tanh_form():
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    got = common.act_fn("gelu")(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.nn.gelu(x)),
                               atol=1e-6, rtol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x))
    assert float((got - exact).abs().max()) > 1e-4
