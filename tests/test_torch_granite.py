"""granite-4.0-h-small (``repro_torch.configs.granite_4_0_h_small``) on the
port at its smoke size on the CPU, against the plain reference
(``tests/granite_reference.py``, the test suite's copy of
``portbench/reference/hybrid.py``): forward, decode through the cache and
served through ``BatchServer``; each of Granite's knobs turned off; the
dropless MoE; the spans and counters; the configuration beside the
benchmark's file.

Tolerance: the repo's fp32 one, 1e-4 (allclose, atol = rtol), with the
weights, the compute and the KV cache in fp32: the port and the reference
then differ only in the order of their fp32 sums (the chunked Mamba scan
against the stepped recurrence, the capacity buffer's batched products
against the loop over experts), about 2e-7 of logits that spread
about 0.1 here.  The served
path keeps its bf16 KV cache (the engine's), which the reference holds in
bf16 too; there a key that agrees to fp32 rounding may round to the other
bf16 neighbour, so the served tokens are held by the gap of their
reference logit below the reference's best, as the benchmark's check
holds them, at 1e-3."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.apc import trace
from repro_torch.apc.metrics import get_registry
from repro_torch.configs import granite_4_0_h_small as granite
from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.models.quant import quantize_model_params
from repro_torch.serve import AdmissionCfg, BatchServer, Engine, ServeCfg

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
SERVED_GAP = 1e-3
BATCH, SEQ = 2, 32              # two Mamba chunks of 16
F32 = {"kv_cache_dtype": "float32"}


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(ROOT / "tests" / "granite_reference.py", "granite_reference")


def _cfg(**kw):
    return granite.smoke_config().with_(param_dtype="float32",
                                        compute_dtype="float32", **kw)


def _raw_params(cfg, seed=0) -> dict:
    """``init_params``, every leaf that it leaves constant (norms, the conv
    bias, dt_bias, a_log, D) drawn around its constant so that each is
    exercised, and the tied embedding at std 0.2, so that the logits
    spread (0.1) against the 1e-4 tolerance."""
    p = M.init_params(cfg, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)

    def draw(t, mean, std):
        return mean + std * torch.randn(t.shape, generator=g)

    p["embed"]["table"] = draw(p["embed"]["table"], 0.0, 0.2)
    p["final_norm"] = draw(p["final_norm"], 1.0, 0.05)
    for pos in p["stack"].values():
        for name in ("norm1", "norm2"):
            pos[name] = draw(pos[name], 1.0, 0.05)
        for name, mean, std in (("conv_b", 0.0, 0.1), ("dt_bias", -1.0, 0.5),
                                ("a_log", 0.5, 0.5), ("d_skip", 1.0, 0.05),
                                ("norm", 1.0, 0.05)):
            if name in pos.get("mamba", {}):
                pos["mamba"][name] = draw(pos["mamba"][name], mean, std)
    return p


def _reference_weights(cfg, p):
    """The reference's flat layers and top leaves from the port's tree:
    layer i at ``stack/pos_{i % period}`` row ``i // period``, the shared
    expert's ``mlp/w*`` as ``shared_w*``."""
    period = len(cfg.layer_pattern)
    layers = []
    for i in range(cfg.n_layers):
        pos, row = p["stack"][f"pos_{i % period}"], i // period
        flat = {"norm1": pos["norm1"][row], "norm2": pos["norm2"][row]}
        for group in ("mamba", "attn", "moe"):
            flat.update({k: v[row] for k, v in pos.get(group, {}).items()})
        flat.update({f"shared_{k}": v[row]
                     for k, v in pos.get("mlp", {}).items()})
        layers.append(flat)
    return layers, {"embed": p["embed"]["table"],
                    "final_norm": p["final_norm"]}


def _reference(cfg, p, tokens, serve=F32, first=0, precision="fp32",
               ref=REF):
    layers, top = _reference_weights(cfg, p)
    return ref.logits(dataclasses.asdict(cfg), serve, layers.__getitem__,
                      top, tokens, first, precision=precision)


def _served_params(cfg, p):
    """The shared expert packed ternary, as the benchmark serves it."""
    return M.cast_params(cfg, quantize_model_params(p))


def _tokens(cfg, seed=0, shape=(BATCH, SEQ)):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(1, cfg.vocab, shape))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------

def _decode_all(cfg, params, tokens):
    """A token a step through an fp32 cache: logits [B, S, V]."""
    cache = M.init_cache(cfg, tokens.shape[0], tokens.shape[1],
                         dtype=torch.float32, device="cpu")
    out = []
    with torch.inference_mode():
        for i in range(tokens.shape[1]):
            logits, cache = M.decode_step(cfg, params, cache, tokens[:, i], i)
            out.append(logits)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("path", ["forward", "decode"])
def test_matches_the_reference(path):
    cfg = _cfg()
    raw = _raw_params(cfg)
    tokens = _tokens(cfg)
    want = _reference(cfg, raw, tokens)
    params = _served_params(cfg, raw)
    if path == "forward":
        with torch.inference_mode():
            got = M.forward(cfg, params, {"tokens": tokens})
    else:
        got = _decode_all(cfg, params, tokens)
    assert got.shape == want.shape == (BATCH, SEQ, cfg.vocab)
    assert float(want.std()) > 0.05         # logits that spread
    _close(got, want)


def test_served_tokens_are_the_references():
    """``BatchServer.submit`` -> ``Engine`` -> ``decode_step`` (a token a
    step through the engine's bf16 KV cache), greedy: every served token's
    reference logit within ``SERVED_GAP`` of the reference's best."""
    cfg = _cfg()
    raw = _raw_params(cfg, seed=3)
    prompts = _tokens(cfg, seed=4, shape=(4, 8)).numpy().astype(np.int32)
    engine = Engine(cfg, _served_params(cfg, raw), ServeCfg(max_len=24),
                    device="cpu")
    server = BatchServer(engine, admission=AdmissionCfg(max_inflight=1))
    try:
        served = np.asarray(server.submit(prompts, 16).result(timeout=300))
    finally:
        server.close()
    assert served.shape == (4, 16)
    tokens = torch.as_tensor(np.concatenate([prompts, served[:, :-1]], 1))
    ref = _reference(cfg, raw, tokens, serve={"kv_cache_dtype": "bfloat16"},
                     first=prompts.shape[1] - 1)
    want = torch.as_tensor(served, dtype=torch.long)
    gap = ref.amax(-1) - ref.gather(-1, want[..., None])[..., 0]
    assert float(gap.max()) <= SERVED_GAP


def _knob_off(cfg, raw, knob):
    """(configuration, weights) with one of Granite's knobs at its
    identity: a multiplier at its default, the conv bias or the shared
    expert left out of the configuration and the weights."""
    if knob in ("embedding_multiplier", "residual_multiplier",
                "logits_scaling"):
        return cfg.with_(**{knob: 1.0}), raw
    if knob == "attention_multiplier":
        return cfg.with_(attention_multiplier=0.0), raw
    raw = {**raw, "stack": {k: dict(v) for k, v in raw["stack"].items()}}
    if knob == "conv_bias":
        for pos in raw["stack"].values():
            if "mamba" in pos:
                pos["mamba"] = {k: v for k, v in pos["mamba"].items()
                                if k != "conv_b"}
        return cfg.with_(ssm=dataclasses.replace(cfg.ssm,
                                                 conv_bias=False)), raw
    for pos in raw["stack"].values():
        del pos["mlp"]
    return cfg.with_(moe=dataclasses.replace(cfg.moe, shared_d_ff=0)), raw


@pytest.mark.parametrize("knob", ["embedding_multiplier",
                                  "residual_multiplier",
                                  "attention_multiplier", "logits_scaling",
                                  "conv_bias", "shared_expert"])
def test_each_knob_changes_the_logits(knob):
    """Each knob at its identity: the port still matches the reference
    (which takes it from the same configuration), and its logits move, so
    no knob is silently ignored."""
    cfg = _cfg()
    raw = _raw_params(cfg, seed=5)
    tokens = _tokens(cfg, seed=6)
    with torch.inference_mode():
        on = M.forward(cfg, _served_params(cfg, raw), {"tokens": tokens})
        cfg_off, raw_off = _knob_off(cfg, raw, knob)
        off = M.forward(cfg_off, _served_params(cfg_off, raw_off),
                        {"tokens": tokens})
    _close(off, _reference(cfg_off, raw_off, tokens))
    assert float((on - off).abs().max()) > 100 * TOL


# ---------------------------------------------------------------------------
# The dropless MoE
# ---------------------------------------------------------------------------

E, K, D, FF = 8, 3, 32, 16


def _all_to_the_same_experts(t: int):
    """x [1, t, D] > 0 and a router whose logits put experts 0..K-1 first
    (in that order) for every token: each of them gets all t tokens."""
    g = torch.Generator().manual_seed(t)
    x = torch.rand(1, t, D, generator=g) + 0.1
    router = torch.full((D, E), -1.0)
    router[:, :K] = torch.arange(K, 0, -1, dtype=torch.float32)
    p = {"router": router,
         "w1": torch.randn(E, D, FF, generator=g) * D ** -0.5,
         "w3": torch.randn(E, D, FF, generator=g) * D ** -0.5,
         "w2": torch.randn(E, FF, D, generator=g) * FF ** -0.5}
    return x, p


def _moe_reference(x, cfg):
    return lambda p: REF._moe(p, x, {"moe": dataclasses.asdict(cfg)},
                              torch.float32, "fp32")


@pytest.mark.parametrize("t", [1, 7, 64])
def test_the_moe_drops_no_pair(t):
    cfg = granite.GraniteMoECfg(n_experts=E, top_k=K, d_ff=FF, dropless=True)
    x, p = _all_to_the_same_experts(t)
    _, experts = moe_mod._route(x.reshape(t, D), p["router"], cfg)
    assert (experts == torch.arange(K, dtype=torch.int32)).all()
    reg = get_registry()
    before = [reg.counter(n).value for n in ("moe.routed_pairs",
                                              "moe.expert_rows")]
    got = moe_mod.moe_ffn(p, x, cfg, "silu")
    after = [reg.counter(n).value for n in ("moe.routed_pairs",
                                             "moe.expert_rows")]
    assert [a - b for a, b in zip(after, before)] == [t * K, E * t]
    _close(got, _moe_reference(x, cfg)(p))


def test_the_capacity_route_would_drop_them():
    """The same traffic at the registered configurations' capacity factor
    (1.25: 30 slots an expert for 64 tokens) loses pairs."""
    cfg = granite.GraniteMoECfg(n_experts=E, top_k=K, d_ff=FF)
    assert moe_mod._capacity(64, cfg) == 30
    x, p = _all_to_the_same_experts(64)
    got = moe_mod.moe_ffn(p, x, cfg, "silu")
    want = _moe_reference(x, cfg)(p)
    assert float((got - want).abs().max()) > 100 * TOL


@pytest.mark.parametrize("t", [1, 7, 128])
def test_dropless_capacity_is_the_token_count(t):
    cfg = granite.config().moe
    assert moe_mod._capacity(t, cfg) == t
    assert moe_mod._capacity(t, dataclasses.replace(
        cfg, dropless=False)) == max(8, int(t * 10 * 1.25 / 72))


# ---------------------------------------------------------------------------
# Spans, counters, the references, the configuration
# ---------------------------------------------------------------------------

def test_spans_and_counters_of_a_decode_step():
    """One decode step: a ``model.mamba`` span a Mamba layer and a
    ``model.moe`` span a layer, with their args; ``ssm.state_bytes`` the
    state and conv state read and written once."""
    cfg = _cfg()
    params = _served_params(cfg, _raw_params(cfg))
    cache = M.init_cache(cfg, BATCH, 8, dtype=torch.float32, device="cpu")
    reg = get_registry()
    before = reg.counter("ssm.state_bytes").value
    with trace.tracing(trace.Tracer()) as tracer, torch.inference_mode():
        M.decode_step(cfg, params, cache, _tokens(cfg)[:, 0], 0)
    spans = [r for r in tracer.events if isinstance(r, trace.SpanRecord)]
    mamba = [i for i in range(cfg.n_layers) if cfg.mixer_at(i) == "mamba"]
    assert [s.args for s in spans if s.name == "model.mamba"] == [
        {"layer": i, "tokens": BATCH, "phase": "decode"} for i in mamba]
    assert [s.args for s in spans if s.name == "model.moe"] == [
        {"layer": i, "tokens": BATCH} for i in range(cfg.n_layers)]
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    state = BATCH * (d_in // s.head_dim) * s.d_state * s.head_dim
    conv = BATCH * (s.conv_width - 1) * (d_in + 2 * s.n_groups * s.d_state)
    assert reg.counter("ssm.state_bytes").value - before == \
        len(mamba) * 2 * 4 * (state + conv)


@pytest.mark.parametrize("precision", ["fp32", "tf32", "fp8"])
def test_the_benchmarks_reference_is_the_tests(precision):
    bench = _load(ROOT / "portbench" / "reference" / "hybrid.py",
                  "portbench_reference_hybrid_copy")
    cfg = _cfg()
    raw = _raw_params(cfg, seed=7)
    tokens = _tokens(cfg, seed=8, shape=(2, 12))
    for serve in (F32, {"kv_cache_dtype": "bfloat16"}):
        assert torch.equal(
            _reference(cfg, raw, tokens, serve, 4, precision, ref=bench),
            _reference(cfg, raw, tokens, serve, 4, precision))


def test_the_configuration():
    """The published widths; 32B parameters, 9B active (the model's name
    says 32B-A9B); out of the registry; the benchmark's file serves one
    whole period of this configuration, in bf16."""
    cfg = granite.config()
    assert "granite-4.0-h-small" not in configs.ARCH_IDS
    counts = cfg.param_counts()
    assert round(counts["total"] / 1e9) == 32
    assert round(counts["active"] / 1e9) == 9
    assert [cfg.mixer_at(i) for i in range(40)].count("mamba") == 36
    bench = json.loads((ROOT / "portbench" / "configs" /
                        "granite-4.0-h-small.json").read_text())
    model = bench["model"]
    want = dataclasses.asdict(granite.config(n_layers=10).with_(
        param_dtype="bfloat16"))             # served in bf16
    for key, value in model.items():
        got = want[key]
        if isinstance(got, dict):             # the file's keys of a block
            got = {k: got[k] for k in value}
        assert (list(got) if isinstance(got, tuple) else got) == value, key
    assert bench["hidden_size"] == cfg.d_model
    assert bench["num_local_experts"] == cfg.moe.n_experts
    assert bench["shared_intermediate_size"] == cfg.moe.shared_d_ff
    assert bench["mamba_n_heads"] == cfg.ssm.expand * cfg.d_model // \
        cfg.ssm.head_dim
    assert [t.replace("attention", "attn") for t in bench["layer_types"]] \
        == list(cfg.layer_pattern)
