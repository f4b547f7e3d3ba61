"""Nothing the benchmark runs loads JAX or the JAX package (``repro``),
compared by whole top-level names (``repro_torch`` is the program), and
the plain reference loads nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from .smoke import AP_CELL, FLOAT_CELL, ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    assert not _imported_tops(path) & FORBIDDEN
    if "reference" in path.parts or path.name == "weights.py":
        assert "repro_torch" not in _imported_tops(path)


_RUN = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
import torch
from portbench.harness import Spec, run
from portbench.tests.smoke import smoke_root
root = smoke_root({tmp!r})
out = run(Spec({cell!r}, root), 2 ** 31 + 11, 0.2, False, torch.device("cpu"))
print(json.dumps({{"correct": out["correct"],
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

_REF = """
import json, sys
sys.path[:0] = [{root!r}]
import numpy as np, torch
from portbench.reference.check import read_gaps
model = dict(n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
             d_ff=32, vocab=32, qk_norm=True, tie_embeddings=True,
             param_dtype="float32", compute_dtype="float32")
p = np.ones((2, 3), np.int32); s = np.ones((2, 2), np.int32)
read_gaps(model, {{"route": "ap", "x_levels": 7}}, 5, torch.device("cpu"),
          [(p, s)], control="tf32", cache_len=8)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("cell", [FLOAT_CELL, AP_CELL])
def test_a_run_loads_no_jax(cell, tmp_path):
    got = json.loads(_python(_RUN.format(src=str(ROOT / "src"),
                                         root=str(ROOT), tmp=str(tmp_path),
                                         cell=cell)))
    assert got["correct"]
    assert "repro_torch" in got["tops"]
    assert not set(got["tops"]) & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = set(json.loads(_python(_REF.format(root=str(ROOT)))))
    assert not tops & (FORBIDDEN | {"repro_torch"})
