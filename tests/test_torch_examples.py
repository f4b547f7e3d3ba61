"""The port's examples (``examples/torch_*.py``) on the CPU.

``torch_quickstart`` and ``torch_ap_arithmetic`` take their inputs from
numpy as the reference examples do, so with ``--device cpu`` they must
print exactly the reference's lines (the reference scripts run in
subprocesses under ``JAX_PLATFORMS=cpu``, both at once).  The other three
draw their weights from ``torch.Generator``, so they are held to their own
self-checks, at cut counts: ``torch_serve_lm`` 4 new tokens (of 24),
``torch_train_lm`` 60 steps (of 200; its schedule's length follows the
step count, and 60 is the fewest at which the loss falls below 0.6 of the
first here).  None of the five imports ``jax`` or ``repro``.
"""
import ast
import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
PORTED = ("quickstart", "ap_arithmetic", "ternary_inference", "serve_lm",
          "train_lm")
SAME_PRINT = ("quickstart", "ap_arithmetic")


def load_example(name: str):
    """``examples/torch_<name>.py`` as a module (its ``main`` not run)."""
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, *argv: str) -> tuple[object, str]:
    """(``main``'s return, its standard output) on the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = load_example(name).main(["--device", "cpu", *argv])
    return ret, out.getvalue()


@pytest.fixture(scope="module")
def reference_output():
    """The reference examples' standard output, both run at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, f"{name}.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name in SAME_PRINT}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        out[name] = stdout
    return out


@pytest.mark.parametrize("name", SAME_PRINT)
def test_example_prints_the_reference_lines(reference_output, name):
    """With ``--device cpu`` the port's example prints the reference
    example's lines, every number included."""
    _, printed = run_example(name)
    assert printed.splitlines() == reference_output[name].splitlines()


def test_ternary_inference_runs_its_checks():
    """Every bit-exactness check of the example holds (it exits otherwise)
    and the served request ran on the AP."""
    _, printed = run_example("ternary_inference")
    lines = printed.splitlines()
    assert sum("bit-exact" in ln and "True" in ln for ln in lines) == 4
    assert lines[-1].startswith("AP-backed serve request")


def test_serve_lm_runs_three_families():
    out, printed = run_example("serve_lm", "--new-tokens", "4")
    assert sorted(out) == sorted(load_example("serve_lm").ARCHS)
    assert all(v.shape == (4, 4) for v in out.values())
    assert len(printed.splitlines()) == 3


def test_train_lm_learns():
    out, printed = run_example("train_lm", "--steps", "60")
    assert "LEARNED" in printed
    assert out["last"] < 0.6 * out["first"]


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_no_jax_and_no_reference(name):
    """An AST walk: no ``import jax`` / ``repro`` (or their submodules)
    anywhere in the port's example."""
    path = os.path.join(EXAMPLES, f"torch_{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots
