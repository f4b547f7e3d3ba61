"""The port stands alone: it imports neither JAX nor the reference package,
its entry points default to the card, and its CUDA wrappers never run a
CPU tensor through a kernel launch."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import apc
from repro_torch.core import ap, build_lut_nonblocked
from repro_torch.core import truth_tables as tt
from repro_torch.kernels.tap_pass import kernel, ops

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "repro"


def test_import_loads_no_jax_and_no_reference():
    code = ("import sys, repro_torch, repro_torch.apc, repro_torch.convert, "
            "repro_torch.kernels.tap_pass; "
            "bad = [m for m in sys.modules if m.split('.')[0] == 'repro' "
            "or m.split('.')[0].startswith('jax')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, device=None raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = np.zeros((8, 9), np.int8)
    compiled = apc.compile_named("add", 3, 4)
    lut = build_lut_nonblocked(tt.full_adder(3))
    calls = [lambda: apc.execute(arr, compiled),
             lambda: apc.run(arr, compiled),
             lambda: ap.ripple_add(arr, lut, 4, 8),
             lambda: ap.ripple_add(arr, lut, 4, 8, engine="apc"),
             lambda: ops.tap_apply_lut(arr, lut, (0, 1, 2)),
             lambda: ops.tap_ripple_add(arr, lut, 4, 8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    out, _ = apc.execute(arr, compiled, device="cpu")
    assert out.device.type == "cpu"


def test_cuda_launchers_refuse_cpu_tensors():
    """The launch paths check the device before building or loading
    anything: a CPU tensor that did not take the plain path raises."""
    compiled = apc.compile_named("add", 3, 2)
    arr = torch.zeros((64, 5), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel._launch_program(arr, compiled.schedule_tensors, 64, 64,
                               True, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel._launch_schedule(arr, ((), (), (0,), (1,)))


def test_plain_path_counts_no_launches():
    before = dict(kernel.launch_counts)
    compiled = apc.compile_named("add", 3, 2)
    apc.execute(np.zeros((16, 5), np.int8), compiled, collect_stats=True,
                device="cpu")
    ops.tap_apply_lut(np.zeros((16, 3), np.int8),
                      build_lut_nonblocked(tt.full_adder(3)), (0, 1, 2),
                      device="cpu")
    assert kernel.launch_counts == before


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Copied alone into an empty directory (or on a host with no card) the
    smoke script exits non-zero and prints no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
