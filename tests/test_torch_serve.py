"""The port's serving engine (``repro_torch.serve.engine``) against the
reference's (``repro.serve.engine``), AP-backed, on the CPU.

The model is the reference's tiny serving config (``tests/test_serve.py``'s
``_tiny_engine``: qwen3-0.6b's smoke config at d_model 16, d_ff 24, two
heads of 8, vocab 32, packed ternary MLPs, bf16 compute; an
``ArrayPool(4, 64, 64)`` with ``x_levels=7``).  Weights come from the
reference's ``init_params`` + ``quantize_model_params`` and are carried
across by ``convert.params_from_arrays``.  Greedy decoding: tokens, step
counts and every AP accounting field (cycles, sets/resets, Table XI energy,
makespan and sequential cycles and ns, graph and program counts, the power
rollup) must be equal, with no tolerance.

At three layers the reference's AP serving fails (its stack runs under
``jax.lax.scan`` above two super-blocks, where ``mlp_ap`` meets a tracer:
``TracerArrayConversionError``), so there the port is held against its own
plain route, ``plain_ap_projections()``, logits bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import apc as rapc
from repro.configs import get_smoke_config as ref_smoke
from repro_torch import apc, configs
from repro_torch.configs.base import MoECfg
from repro_torch.convert import params_from_arrays
from repro_torch.kernels.tap_pass import kernel as tap_kernel
from repro_torch.models import model as M
from repro_torch.serve import Engine, ServeCfg

TINY = dict(d_model=16, d_ff=24, n_heads=2, n_kv_heads=2, head_dim=8,
            vocab=32)
POOL = dict(n_arrays=4, rows=64, cols=64)
PROMPT = np.array([[3, 5, 7]], np.int32)
# every field of ap_report() that both engines compute the same way (the
# rest: "cache", the caches' occupancy, and "latency", host times)
AP_FIELDS = ("write_cycles", "compare_cycles", "sets", "resets",
             "energy_write_j", "energy_compare_j", "energy_total_j",
             "makespan_cycles", "sequential_cycles", "makespan_ns",
             "sequential_ns", "n_graphs", "n_programs",
             "pruned_write_cycles", "pruned_compare_cycles",
             "emitted_passes", "pruned_passes", "resident_hits",
             "resident_misses", "resident_hit_rate", "weight_sparsity",
             "power", "n_arrays_total")


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(
        a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating)
        else a), tree)


def _cfgs(arch="qwen3-0.6b", **kw):
    """(reference config, port config): ``arch``'s smoke config at the
    tiny widths with packed ternary MLPs, equal fields."""
    out = []
    for base in (ref_smoke(arch), configs.get_smoke_config(arch)):
        out.append(base.with_(ternary=base.ternary.__class__(enabled=True),
                              **dict(TINY, **kw)))
    return tuple(out)


def _ref_engine(ref_cfg, params, max_len=10):
    from repro.launch.mesh import make_smoke_mesh
    from repro.serve.engine import Engine as RefEngine
    from repro.serve.engine import ServeCfg as RefServeCfg
    ctx = rapc.APServeContext(rapc.Runtime(rapc.ArrayPool(**POOL)),
                              x_levels=7)
    return RefEngine(ref_cfg, params, make_smoke_mesh(),
                     RefServeCfg(max_len=max_len), ap_ctx=ctx)


def port_ctx(**pool):
    return apc.APServeContext(apc.Runtime(apc.ArrayPool(
        **dict(POOL, **pool), device="cpu")), x_levels=7)


def port_engine(cfg, params, *, ap=True, max_len=10, temperature=0.0,
                **pool):
    return Engine(cfg, params, ServeCfg(max_len=max_len,
                                        temperature=temperature),
                  ap_ctx=port_ctx(**pool) if ap else None, device="cpu")


def _engines(ref_cfg, cfg, seed=0):
    """The reference's engine and the port's on the same weights."""
    from repro.models import model as ref_M
    from repro.models.quant import quantize_model_params as ref_quantize
    ref_p = ref_quantize(ref_M.init_params(ref_cfg, jax.random.PRNGKey(seed)))
    mine = M.cast_params(cfg, params_from_arrays(_np_tree(ref_p),
                                                 device="cpu"))
    return _ref_engine(ref_cfg, ref_p), port_engine(cfg, mine)


def tiny_params(cfg, seed=0):
    """The port's own seeded weights for ``cfg``, packed and cast."""
    from repro_torch.models.quant import quantize_model_params
    return M.cast_params(cfg, quantize_model_params(
        M.init_params(cfg, seed=seed, device="cpu")))


def _assert_reports_equal(mine: dict, want: dict):
    for key in AP_FIELDS:
        assert mine[key] == want[key], key


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [1, 2])
def test_engine_matches_reference(n_layers):
    ref_cfg, cfg = _cfgs(n_layers=n_layers)
    ref, mine = _engines(ref_cfg, cfg)
    n_new = 3
    want = ref.generate(PROMPT, n_new)
    got = mine.generate(PROMPT, n_new)
    assert got.dtype == np.int32 and got.shape == (1, n_new)
    np.testing.assert_array_equal(got, np.asarray(want))
    for key in ("n_prefill_steps", "n_decode_steps", "n_model_steps"):
        assert mine.last_latency[key] == ref.last_latency[key], key
    rep = mine.ap_report()
    _assert_reports_equal(rep, ref.ap_report())
    assert rep["n_graphs"] == 2 * n_layers * (PROMPT.shape[1] + n_new - 1)


def test_moe_engine_matches_reference():
    """qwen3-moe's smoke config at 2 layers and the tiny widths (4 experts
    of d_ff 24, top-2): every expert projection through ``moe_ffn_ap``.
    Tokens and the integer accounting equal the reference's; the energy
    fields, priced from the same integers, too."""
    ref_cfg, cfg = _cfgs("qwen3-moe-30b-a3b", n_layers=2)
    ref_cfg = ref_cfg.with_(moe=ref_cfg.moe.__class__(n_experts=4, top_k=2,
                                                      d_ff=24))
    cfg = cfg.with_(moe=MoECfg(n_experts=4, top_k=2, d_ff=24))
    ref, mine = _engines(ref_cfg, cfg)
    prompt, n_new = PROMPT[:, :2], 2
    want = ref.generate(prompt, n_new)
    got = mine.generate(prompt, n_new)
    np.testing.assert_array_equal(got, np.asarray(want))
    rep = mine.ap_report()
    _assert_reports_equal(rep, ref.ap_report())
    assert rep["n_graphs"] == 2 * 2 * (prompt.shape[1] + n_new - 1)


# ---------------------------------------------------------------------------
# Deeper than the reference serves: the plain route
# ---------------------------------------------------------------------------

def serve_logits(eng, prompt, n_new, plain=False):
    """Drive one request step by step (the engine's own Request), under
    ``ap_serving`` and optionally ``plain_ap_projections()``; returns the
    logits of every step and the tokens."""
    ctx = eng.ap_ctx
    ctx.reset()
    req = eng.new_request(prompt, n_new)
    logits = []
    with apc.ap_serving(ctx):
        while not req.done:
            if plain:
                with apc.plain_ap_projections():
                    req.step()
            else:
                req.step()
            logits.append(req.logits.clone())
    return torch.stack(logits), req.tokens()


def test_three_layers_ap_route_equals_plain_route():
    """Three layers (the reference cannot serve this through the AP, see
    the module docstring): two graphs per layer per model step, a program
    launch per graph node, and every step's logits bit-identical to the
    plain route."""
    _, cfg = _cfgs(n_layers=3)
    eng = port_engine(cfg, tiny_params(cfg, seed=1))
    n_new = 3
    steps = PROMPT.shape[1] + n_new - 1
    before = tap_kernel.launch_counts["tap_run_program"]
    logits, toks = serve_logits(eng, PROMPT, n_new)
    assert eng.ap_ctx.n_graphs == 2 * 3 * steps
    n_programs = eng.ap_ctx.n_programs
    plain, plain_toks = serve_logits(eng, PROMPT, n_new, plain=True)
    assert eng.ap_ctx.n_graphs == 0           # the plain route ran no graph
    assert logits.shape == (steps, 1, cfg.vocab)
    assert torch.equal(logits, plain)
    np.testing.assert_array_equal(toks, plain_toks)
    # on the CPU the wrapper counts nothing: the plain version ran
    assert tap_kernel.launch_counts["tap_run_program"] == before
    assert n_programs > eng.ap_ctx.n_graphs


# ---------------------------------------------------------------------------
# The engine's contract (the reference's tests/test_serve.py edge cases)
# ---------------------------------------------------------------------------

def test_generate_step_count_and_n_graphs():
    """Exactly s_prompt + n_new - 1 model steps, 2 graphs per layer each."""
    _, cfg = _cfgs(n_layers=1)
    eng = port_engine(cfg, tiny_params(cfg))
    calls = {"n": 0}
    orig = eng._step

    def counting_step(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    eng._step = counting_step
    s_prompt, n_new = 3, 4
    toks = eng.generate(PROMPT, n_new)
    assert toks.shape == (1, n_new)
    steps = s_prompt + n_new - 1
    assert calls["n"] == steps
    lat = eng.last_latency
    assert (lat["n_model_steps"], lat["n_prefill_steps"],
            lat["n_decode_steps"]) == (steps, s_prompt, n_new - 1)
    assert eng.ap_ctx.n_graphs == 2 * steps
    rep = eng.ap_report()
    assert rep["latency"] is lat and rep["cache"]["linears"] <= 64
    assert rep["power"]["energy_j"] == pytest.approx(rep["energy_total_j"],
                                                     rel=1e-12)


def test_generate_empty_prompt_raises_and_n_new_zero_empty():
    _, cfg = _cfgs(n_layers=1)
    eng = port_engine(cfg, tiny_params(cfg))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate(np.zeros((1, 0), dtype=np.int32), 3)
    out = eng.generate(np.array([[3, 5]], dtype=np.int32), 0)
    assert out.shape == (1, 0) and out.dtype == np.int32
    lat = eng.last_latency
    assert lat["n_model_steps"] == 0
    assert abs(lat["prefill_ms"] + lat["decode_ms"] + lat["other_ms"]
               - lat["request_ms"]) < 1e-6
    with pytest.raises(RuntimeError, match="n_graphs == 0"):
        eng.ap_report()


def test_request_validates_without_model_run():
    class _Cfg:
        enc_layers = 0
    eng = Engine.__new__(Engine)
    eng.cfg = _Cfg()
    eng.serve = ServeCfg(max_len=8)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.new_request(np.zeros((1, 0), dtype=np.int32), 2)
    with pytest.raises(ValueError, match="n_new"):
        eng.new_request(np.array([[1]], dtype=np.int32), -1)
    with pytest.raises(ValueError, match=r"\[B, S\]"):
        eng.new_request(np.array([1, 2], dtype=np.int32), 1)


def test_ap_report_raises_when_nothing_was_ap_served():
    """An AP context on a model with no packed projections: the request
    runs on the float path and ap_report() refuses an all-zero report."""
    _, cfg = _cfgs(n_layers=1)
    cfg = cfg.with_(ternary=cfg.ternary.__class__(enabled=False))
    params = M.cast_params(cfg, M.init_params(cfg, seed=0, device="cpu"))
    eng = Engine(cfg, params, ServeCfg(max_len=8), ap_ctx=port_ctx(),
                 device="cpu")
    assert eng.generate(PROMPT[:, :1], 2).shape == (1, 2)
    with pytest.raises(RuntimeError, match="no AP projections"):
        eng.ap_report()


def test_float_route_equals_decode_step_loop():
    """No ap_ctx: the packed projections' float route; the tokens a plain
    greedy decode_step loop gives, and no AP report."""
    _, cfg = _cfgs(n_layers=2)
    params = tiny_params(cfg)
    eng = port_engine(cfg, params, ap=False)
    prompts = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    n_new = 3
    got = eng.generate(prompts, n_new)
    assert eng.ap_report() is None
    cache = M.init_cache(cfg, 2, 10, device="cpu")
    want = []
    with torch.no_grad():
        for pos in range(prompts.shape[1] + n_new - 1):
            tok = torch.from_numpy(prompts[:, pos]).long() \
                if pos < prompts.shape[1] else want[-1]
            logits, cache = M.decode_step(cfg, params, cache, tok, pos)
            if pos >= prompts.shape[1] - 1:
                want.append(logits.argmax(-1))
    np.testing.assert_array_equal(got, torch.stack(want, 1).numpy())


def test_sampling_is_seeded_per_index():
    """temperature > 0: the same seed draws the same tokens, another seed
    other tokens (a generator seeded from (seed, sample index))."""
    _, cfg = _cfgs(n_layers=1)
    params = tiny_params(cfg)
    outs = []
    for seed in (0, 0, 1):
        eng = Engine(cfg, params, ServeCfg(max_len=12, temperature=5.0,
                                           seed=seed), device="cpu")
        outs.append(eng.generate(np.array([[1, 2]], np.int32), 8))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])


def test_engine_device_defaults_to_the_card():
    _, cfg = _cfgs(n_layers=1)
    if torch.cuda.is_available():
        assert Engine(cfg, {}, ServeCfg()).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(cfg, {}, ServeCfg())


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "3", "--new-tokens", "2"])
    out = capsys.readouterr().out
    assert "generated (2, 2)" in out and "sample:" in out
