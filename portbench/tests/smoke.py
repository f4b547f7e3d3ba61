"""A copy of the benchmark at smoke size, for the CPU tests: the same
files, the configurations cut to a few units of every width (the cells'
shapes of work otherwise kept: 8-sequence AP requests, a merged wave)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
AP_CELL = "qwen3-0.6b-ap.wave4x8"
FLOAT_CELL = "qwen2-72b.batch128"

SMOKE_MODELS = {
    "qwen3-0.6b-ap": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=256),
    "qwen2-72b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256),
}
SMOKE_TRAFFIC = {
    AP_CELL: dict(clients=2, batch=8, prompt_len=2, new_tokens=3,
                  max_len=8),
    FLOAT_CELL: dict(clients=1, batch=128, prompt_len=3, new_tokens=8,
                     max_len=12),
}
# the AP cell's modelled counters that do not depend on the data, as the
# program reads them per request at smoke size (seeds 11, 12, 2^31 + 3)
SMOKE_AP_COUNTERS = dict(write_cycles=621256, compare_cycles=616224,
                         n_programs=144, emitted_passes=4096,
                         pruned_passes=0, makespan_cycles=3758080,
                         sequential_cycles=3758080, resident_hits=24,
                         resident_misses=0)
# the number each cell compares, and the smoke sizes' own limits from
# their CPU readings, nearer the control's than the program's: the
# program's widest gap (AP 0.0 on seeds 11-14; float 0.0202-0.0295 on
# seeds 11-16 and 2^31 + 3..8, every row of a request) and the
# control's (TF32 0.0168-0.0326 on seeds 11-14; fp8 0.317-0.597)
SMOKE_LIMITS = {AP_CELL: ("logit_gap", 1e-2),
                FLOAT_CELL: ("logit_gap", 0.12)}


def _edit(path: Path, fn) -> None:
    d = json.loads(path.read_text())
    fn(d)
    path.write_text(json.dumps(d, indent=1))


def smoke_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``portbench/`` at smoke
    size."""
    tmp = Path(tmp)
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, sizes in SMOKE_MODELS.items():
        def shrink(d, sizes=sizes):
            d["model"].update(sizes)
            if d["serve"]["route"] == "ap":
                d["serve"]["pool"] = {"n_arrays": 4, "rows": 64, "cols": 160}
        _edit(tmp / "portbench" / "configs" / f"{name}.json", shrink)
    for cell, tr in SMOKE_TRAFFIC.items():
        def shrink(d, tr=tr, cell=cell):
            d["traffic"].update(tr)
            d["warmup"].update(clients=tr["clients"], batch=tr["batch"])
            d["check"]["limits"] = dict([SMOKE_LIMITS[cell]])
            if "ap_counters" in d["check"]:
                d["check"]["ap_counters"] = dict(SMOKE_AP_COUNTERS)
        _edit(tmp / "portbench" / "workloads" / f"{cell}.json", shrink)
    return tmp
