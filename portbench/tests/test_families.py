"""The family seam on the CPU at smoke size: the dense family gives what
the benchmark's own functions give, bit for bit; the port's configuration
is built from a file's nested blocks; and a configuration of a family of
its own, with a cell that asks for the program's spans and counters, comes
to the benchmark as new files only."""
import json

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.families import model_config
from portbench.harness import Spec, run
from portbench.reference import model as reference

from .smoke import AP_CELL, FLOAT_CELL, smoke_root

CPU = torch.device("cpu")
SEED = 2 ** 31 + 5
CELLS = [FLOAT_CELL, AP_CELL]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("smoke"))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _same(a: dict, b: dict) -> None:
    a, b = _flat(a), _flat(b)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# -- the dense family, pinned to the functions it re-exports ---------------

@pytest.mark.parametrize("cell", CELLS)
def test_the_models_family_names_the_module(root, cell):
    spec = Spec(cell, root)
    assert spec.model["family"] == "dense"
    assert spec.family.__file__.endswith("families/dense.py")
    from repro_torch.configs.base import ModelConfig
    assert spec.family.model_config(spec.model) == ModelConfig(**spec.model)


@pytest.mark.parametrize("cell", CELLS)
def test_dense_weights_are_the_benchmarks_own(root, cell):
    spec = Spec(cell, root)
    fam, model = spec.family, spec.model
    dtype = weights.DTYPES[model["param_dtype"]]
    _same(fam.program_tree(model, SEED, CPU, dtype),
          weights.program_tree(model, SEED, CPU, dtype))
    _same(fam.top_params(model, SEED, CPU, dtype),
          weights.top_params(model, SEED, CPU, dtype))
    for i in range(model["n_layers"]):
        _same(fam.layer_params(model, SEED, i, CPU, dtype),
              weights.layer_params(model, SEED, i, CPU, dtype))
    assert fam.keeps_layer_weights(model) == (
        model["n_layers"] * model["d_model"] * model["d_ff"] < 2 ** 28)


@pytest.mark.parametrize("precision", ["fp32", "tf32", "fp8"])
@pytest.mark.parametrize("cell", CELLS)
def test_dense_reference_is_the_benchmarks_own(root, cell, precision):
    spec = Spec(cell, root)
    fam, model, serve = spec.family, spec.model, spec.serve
    dtype = weights.DTYPES[model["param_dtype"]]
    top = weights.top_params(model, SEED, CPU, dtype)

    def layer_fn(i):
        return weights.layer_params(model, SEED, i, CPU, dtype)
    tr = spec.cell["traffic"]
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(
        1, model["vocab"], size=(4, tr["prompt_len"] + tr["new_tokens"] - 1)))
    first = tr["prompt_len"] - 1
    got = fam.logits(model, serve, layer_fn, top, tokens, first,
                     precision=precision)
    want = reference.logits(model, serve, layer_fn, top, tokens, first,
                            precision=precision)
    assert torch.equal(got, want)
    got = fam.logits_stepwise(model, serve, layer_fn, top, tokens, first,
                              cache_len=tr["max_len"], precision=precision)
    want = reference.logits_stepwise(model, serve, layer_fn, top, tokens,
                                     first, cache_len=tr["max_len"],
                                     precision=precision)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", CELLS)
def test_dense_ap_graph_count_is_the_benchmarks_own(root, cell):
    spec = Spec(cell, root)
    model, tr = spec.model, spec.cell["traffic"]
    n_steps = tr["prompt_len"] + tr["new_tokens"] - 1
    assert spec.family.ap_graphs_per_step(model) * n_steps == \
        2 * model["n_layers"] * n_steps


# -- the port's configuration from a file's blocks -------------------------

def test_model_config_builds_the_nested_blocks():
    from repro_torch.configs.base import MoECfg, SSMCfg, TernaryCfg
    model = dict(name="hybrid-toy", family="hybrid", n_layers=4,
                 d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                 layer_pattern=["mamba", "attn"], ffn_pattern=["moe", "mlp"],
                 moe={"n_experts": 8, "top_k": 2, "d_ff": 32,
                      "norm_topk": False},
                 ssm={"d_state": 16, "head_dim": 16, "chunk": 8},
                 ternary={"enabled": True})
    before = json.dumps(model)
    cfg = model_config(model)
    assert cfg.moe == MoECfg(n_experts=8, top_k=2, d_ff=32, norm_topk=False)
    assert cfg.ssm == SSMCfg(d_state=16, head_dim=16, chunk=8)
    assert cfg.ternary == TernaryCfg(enabled=True)
    assert cfg.layer_pattern == ("mamba", "attn")
    assert cfg.ffn_pattern == ("moe", "mlp")
    assert cfg.mixer_at(2) == "mamba" and cfg.ffn_at(3) == "mlp"
    hash(cfg)                        # frozen, every field hashable
    assert json.dumps(model) == before
    with pytest.raises(TypeError):
        model_config({**model, "ssm": {"d_state": 16, "width": 3}})


# -- a family of its own, as new files ---------------------------------------

# two attention positions a period: the dense layers, layer i at
# ``stack/pos_{i % 2}`` row ``i // 2``
_FAMILY = '''"""Dense layers on a two-position layer pattern."""
import torch

from portbench.families import dense, model_config
from portbench.weights import layer_shapes

logits, logits_stepwise = dense.logits, dense.logits_stepwise
top_params, layer_params = dense.top_params, dense.layer_params
keeps_layer_weights = dense.keeps_layer_weights
ap_graphs_per_step = dense.ap_graphs_per_step


def program_tree(model, seed, device, dtype):
    period = len(model["layer_pattern"])
    stack = {}
    for p in range(period):
        rows = [layer_params(model, seed, i, device, dtype)
                for i in range(p, model["n_layers"], period)]
        pos = {"attn": {}, "mlp": {}}
        for name, (_, _, _, group) in layer_shapes(model).items():
            (pos if group is None else pos[group])[name] = torch.stack(
                [r[name] for r in rows])
        stack[f"pos_{p}"] = pos
    top = top_params(model, seed, device, dtype)
    tree = {"embed": {"table": top["embed"]},
            "final_norm": top["final_norm"], "stack": stack}
    if "lm_head" in top:
        tree["lm_head"] = {"w": top["lm_head"]}
    return tree
'''

# decode attentions a model step, from the program's counter and spans: on
# the CPU every attention takes the einsum path, one a layer a step
_METRIC = '''def read(data):
    steps = [s for s in data.get("program_spans", ())
             if s["name"] == "serve.step" and s["end_ns"] > s["start_ns"]]
    calls = data.get("program_counters", {}).get("attn.decode.einsum", 0)
    if not steps or not calls:
        return None
    return calls / len(steps)
'''


def test_a_family_comes_as_new_files_only(tmp_path):
    """A family module, a configuration that names it (nested blocks, a
    two-position layer pattern), a cell with ``program_trace`` and a
    reader of the program's counters and spans: four new files and
    ``BENCHMARK.json`` entries, no file of the benchmark edited."""
    root = smoke_root(tmp_path)
    bench_dir = root / "portbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    (bench_dir / "families" / "two_position.py").write_text(_FAMILY)
    cfg = json.loads((bench_dir / "configs" / "qwen2-72b.json").read_text())
    cfg["model"].update(name="toy-2pos", family="two_position",
                        layer_pattern=["attn", "attn"],
                        ffn_pattern=["mlp"], ternary={"enabled": True},
                        moe={"n_experts": 4, "top_k": 2, "d_ff": 32})
    (bench_dir / "configs" / "toy-2pos.json").write_text(json.dumps(cfg))
    cell = json.loads((bench_dir / "workloads" /
                       f"{FLOAT_CELL}.json").read_text())
    cell.update(config="toy-2pos", program_trace=True)
    (bench_dir / "workloads" / "toy-2pos.short.json").write_text(
        json.dumps(cell))
    (bench_dir / "metrics" / "attn_calls_per_step.py").write_text(_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy-2pos", "source": "https://example.org/toy",
        "file": "portbench/configs/toy-2pos.json",
        "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy-2pos.short",
                               "config": "toy-2pos", "traffic": "short",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "attn_calls_per_step", "unit": "calls/step",
        "better": "lower", "source": "program_counter", "layer": "model step",
        "moves": "decode_tokens_per_s", "workloads": ["toy-2pos.short"]})
    for m in bench["end_to_end"]:
        if FLOAT_CELL in m.get("workloads", ()):
            m["workloads"].append("toy-2pos.short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec("toy-2pos.short", root)
    assert set(spec.family.program_tree(
        spec.model, SEED, CPU, torch.float32)["stack"]) == {"pos_0", "pos_1"}
    for trace in (False, True):
        out = run(spec, SEED, 0.2, trace, CPU)
        assert out["correct"], out["checks"]
    # an attention a layer a step
    assert out["metrics"]["attn_calls_per_step"]["value"] == \
        spec.model["n_layers"]
    for p, data in before.items():
        assert p.read_bytes() == data, p
