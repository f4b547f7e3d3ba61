"""The harness on the CPU at smoke size: a whole run of each cell, the
command's refusals, the files a later change adds, the faults that the
check must catch, and the controls."""
import contextlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import Spec, run

from .smoke import AP_CELL, FLOAT_CELL, ROOT, SMOKE_LIMITS, smoke_root

CPU = torch.device("cpu")
SEED = 2 ** 31 + 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smoke_root(tmp_path_factory.mktemp("smoke"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [FLOAT_CELL, AP_CELL])
def test_cell_runs_end_to_end(root, cell, trace):
    spec = Spec(cell, root)
    out = run(spec, SEED, 0.2, bool(trace), CPU)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1
    names = {m["name"] for m in (spec.per_layer if trace
                                 else spec.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    key, limit = SMOKE_LIMITS[cell]
    assert line["checks"][key]["limit"] == limit


def _cli(cwd: Path, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", FLOAT_CELL,
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=str(cwd), capture_output=True, text=True, timeout=300,
        env=env)


def test_command_refuses_without_a_card():
    out = _cli(ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_command_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_later_files_are_found_by_name(tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    and ``BENCHMARK.json`` entries, no file of the benchmark edited."""
    root = smoke_root(tmp_path)
    bench_dir = root / "portbench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*")
              if p.is_file()}
    shutil.copy(bench_dir / "configs" / "qwen2-72b.json",
                bench_dir / "configs" / "dummy-model.json")
    cell = json.loads((bench_dir / "workloads" /
                       f"{FLOAT_CELL}.json").read_text())
    cell["config"] = "dummy-model"
    (bench_dir / "workloads" / "dummy-model.short.json").write_text(
        json.dumps(cell))
    (bench_dir / "metrics" / "dummy_requests.py").write_text(
        "def read(data):\n    return float(len(data['records']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "dummy-model", "source": "https://example.org/dummy",
        "file": "portbench/configs/dummy-model.json", "reduced": [],
        "why": "a test"})
    bench["workloads"].append({"name": "dummy-model.short",
                               "config": "dummy-model", "traffic": "short",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "dummy_requests", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "serve",
        "moves": "decode_tokens_per_s", "workloads": ["dummy-model.short"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and FLOAT_CELL in m["workloads"]:
            m["workloads"].append("dummy-model.short")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run(Spec("dummy-model.short", root), SEED, 0.2, True, CPU)
    assert out["correct"]
    assert out["metrics"]["dummy_requests"]["value"] >= 1
    for p, data in before.items():
        assert p.read_bytes() == data, p


# -- faults the check must catch (the timed path broken underneath) --------

@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _token_altered():
    from repro_torch.serve.engine import Engine

    def make(orig):
        def sample(self, logits, index):
            tok = orig(self, logits, index).clone()
            tok[0] = (tok[0] + 1) % logits.shape[-1]
            return tok
        return sample
    return _patched(Engine, "_sample", make)


def _state_unchanged():
    import repro_torch.models.model as M
    last = {}

    def make(orig):
        def step(cfg, params, cache, tokens, pos, **kw):
            key = (id(cache), tokens.shape[0])
            if pos >= 2 and key in last:     # the cache is not written
                return last[key].clone(), cache
            logits, cache = orig(cfg, params, cache, tokens, pos, **kw)
            last[key] = logits
            return logits, cache
        return step
    return _patched(M, "decode_step", make)


def _half_batch_left_out():
    import repro_torch.models.model as M

    def make(orig):
        def step(cfg, params, cache, tokens, pos, **kw):
            logits, cache = orig(cfg, params, cache, tokens, pos, **kw)
            h = logits.shape[0] // 2
            logits = logits.clone()
            logits[h:] = logits[:logits.shape[0] - h]
            return logits, cache
        return step
    return _patched(M, "decode_step", make)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_batch_left_out],
                         ids=["token_altered", "state_unchanged",
                              "half_batch_left_out"])
@pytest.mark.parametrize("cell", [FLOAT_CELL, AP_CELL])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    with fault():
        out = run(Spec(cell, root), SEED + 1, 0.2, False, CPU)
    assert out["correct"] is False
    key, limit = SMOKE_LIMITS[cell]
    assert out["checks"][key]["value"] > limit


def test_skipping_the_ap_simulator_is_not_correct(root):
    """Exact integer products in place of the AP's graphs give the same
    logits; the graphs counted per request catch it."""
    import contextvars

    import repro_torch.apc.layers as layers
    with _patched(layers, "_PLAIN_AP", lambda _: contextvars.ContextVar(
            "plain_ap_projections", default=True)):
        out = run(Spec(AP_CELL, root), SEED + 1, 0.2, False, CPU)
    key, limit = SMOKE_LIMITS[AP_CELL]
    assert out["checks"][key]["value"] <= limit
    assert out["checks"]["ap_graphs_off"]["value"] > 0
    assert out["checks"]["ap_counters_off"]["value"] > 0
    assert out["correct"] is False


@pytest.mark.parametrize("counter", ["write_cycles", "sequential_cycles"])
def test_a_modelled_counter_changed_is_not_correct(root, counter):
    """A simulator that serves the same tokens but counts its modelled
    cycles otherwise is caught by the frozen counts."""
    from repro_torch.apc.layers import APSink

    def make(orig):
        def report(self, *a, **kw):
            rep = orig(self, *a, **kw)
            rep[counter] += 1
            return rep
        return report
    with _patched(APSink, "report", make):
        out = run(Spec(AP_CELL, root), SEED + 1, 0.2, False, CPU)
    key, limit = SMOKE_LIMITS[AP_CELL]
    assert out["checks"][key]["value"] <= limit
    assert out["checks"]["ap_graphs_off"]["value"] == 0
    assert out["checks"]["ap_counters_off"]["value"] > 0
    assert out["correct"] is False


@pytest.mark.parametrize("cell,control", [(FLOAT_CELL, "fp8"),
                                          (AP_CELL, "tf32")])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(root, cell, control, seed):
    """The reference in the next precision below the configuration's, put
    in the program's place at the served tokens' positions, comes out as
    not correct through the harness's own check, where the program passes
    the same limit (the smoke sizes' limits; the cells' own are set from
    the card's readings, ``portbench/control.py``)."""
    out = run(Spec(cell, root), seed, 0.2, False, CPU, control=control)
    assert out["correct"] is False
    key, limit = SMOKE_LIMITS[cell]
    assert out["checks"][key]["value"] > limit
    assert out["checks"][key]["value"] == out["readings"]["control_" + key]
    assert out["readings"][key] <= limit


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [AP_CELL, FLOAT_CELL])
def test_a_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
