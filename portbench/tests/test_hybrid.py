"""The hybrid family (granite-4.0-h-small) on the CPU at smoke size: its
weights land in the program's tree as the port lays it out, its cell runs
through the harness end to end, traced and not, with its readers reading,
and its work counts are those of the configuration's shapes."""
import json

import pytest
import torch

from portbench.families import hybrid
from portbench.harness import Spec, run
from portbench.work_hybrid import step_bytes, token_flops

from .smoke import smoke_root

CPU = torch.device("cpu")
SEED = 2 ** 31 + 17
CELL = "granite-4.0-h-small.batch128"
SMOKE = dict(n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             vocab=256, attention_multiplier=1 / 16)
SMOKE_MOE = dict(n_experts=8, top_k=3, d_ff=32, shared_d_ff=48)
SMOKE_SSM = dict(d_state=16, head_dim=16, chunk=16)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark at smoke size, granite's configuration and cell cut
    to a few units of every width (the check's limit kept)."""
    root = smoke_root(tmp_path_factory.mktemp("smoke"))
    bench = root / "portbench"
    path = bench / "configs" / "granite-4.0-h-small.json"
    cfg = json.loads(path.read_text())
    cfg["model"].update(SMOKE)
    cfg["model"]["moe"].update(SMOKE_MOE)
    cfg["model"]["ssm"].update(SMOKE_SSM)
    path.write_text(json.dumps(cfg))
    path = bench / "workloads" / f"{CELL}.json"
    cell = json.loads(path.read_text())
    cell["traffic"].update(batch=16, prompt_len=3, new_tokens=6, max_len=12)
    cell["warmup"].update(batch=16)
    path.write_text(json.dumps(cell))
    return root


def _shapes(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), tree.dtype)}


def test_the_tree_is_the_ports(root):
    from repro_torch.models.model import init_params
    spec = Spec(CELL, root)
    cfg = spec.family.model_config(spec.model)
    assert type(cfg).__name__ == "GraniteConfig"
    mine = spec.family.program_tree(spec.model, SEED, CPU, torch.bfloat16)
    port = init_params(cfg.with_(param_dtype="bfloat16"), device="cpu")
    # the port keeps its router in fp32 until the cast
    want = {k: (s, torch.bfloat16) for k, (s, _) in _shapes(port).items()}
    assert _shapes(mine) == want


def test_layer_params_are_the_trees_rows(root):
    spec = Spec(CELL, root)
    tree = hybrid.program_tree(spec.model, SEED, CPU, torch.float32)
    for i in (0, 5, 9):
        flat = hybrid.layer_params(spec.model, SEED, i, CPU, torch.float32)
        pos = tree["stack"][f"pos_{i}"]
        for name, (_, _, _, path) in hybrid.layer_shapes(
                spec.model, i).items():
            node = pos
            for key in path:
                node = node[key]
            assert torch.equal(node[0], flat[name]), name


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_end_to_end(root, trace):
    spec = Spec(CELL, root)
    out = run(spec, SEED, 0.2, bool(trace), CPU)
    assert out["correct"], out["checks"]
    names = {m["name"] for m in (spec.per_layer if trace
                                 else spec.end_to_end)}
    if not trace:
        assert set(out["metrics"]) == names
        return
    # on the CPU the profiler sees no device: the device readers are
    # silent, the program's spans and counters are read
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(got) == {"hybrid_mfu", "mamba_ms_per_step.hybrid",
                        "moe_ms_per_step.hybrid", "moe_rows_used.hybrid"}
    assert got["moe_rows_used.hybrid"] == pytest.approx(100 * 3 / 8)
    assert all(v > 0 for v in got.values())


def test_ap_graphs_are_refused(root):
    with pytest.raises(NotImplementedError):
        hybrid.ap_graphs_per_step(Spec(CELL, root).model)


def test_the_published_step_work():
    """At the published widths (the file's own model block): about 5
    GFLOP a token, and at batch 128 about 26 GB of compulsory bytes a
    step (13.6 GB of experts, 9.7 GB of Mamba state in and out, the
    rest weights and keys)."""
    from .smoke import ROOT
    model = json.loads((ROOT / "portbench" / "configs" /
                        "granite-4.0-h-small.json").read_text())["model"]
    assert 4.9e9 < token_flops(model, 256) < 5.2e9
    gb = step_bytes(model, 255, 128) / 1e9
    assert 25.5 < gb < 27
    # a sequence more: its state and keys, and below 72 experts reached,
    # the experts its 10 pairs reach (2 more at 8 sequences than at 7)
    state = 2 * (128 * 128 * 64 + 3 * 8448) * 4 * 9
    keys = 2 * 8 * 128 * 2
    experts = 3 * 4096 * 768 * 2 * 10
    assert step_bytes(model, 0, 8) - step_bytes(model, 0, 7) == \
        2 * experts + state + keys
    assert step_bytes(model, 0, 129) - step_bytes(model, 0, 128) == \
        state + keys
