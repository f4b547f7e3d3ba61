"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and the control's beside them, in one process.

    python3 portbench/control.py --workload <name> --seconds <s> \
        --control <tf32|fp8> --seeds <n> [<n> ...] [--out FILE]

Each seed runs the cell as ``run.py`` does (set-up, a short window at the
cell's own load, the check), with the reference in the control's
precision put in the program's place at the same positions
(``reference.check``): ``correct`` and ``checks`` are the control's
verdict, which has to be false, and ``readings`` holds the program's
numbers (``logit_gap``, the lower reading of a limit) beside the
control's (``control_logit_gap``, the upper).  One JSON line per seed on
standard output (and appended to ``--out``): ``{"seed", "correct",
"checks", "readings", "metrics"}``.  The benchmark's own runs never run
the control.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", required=True, choices=("tf32", "fp8"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from portbench.harness import Spec, run
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = Spec(args.workload, ROOT)
    for seed in args.seeds:
        out = run(spec, seed, args.seconds, False, torch.device("cuda", 0),
                  control=args.control)
        if out is None:
            return 4
        line = json.dumps({"seed": seed, "correct": out["correct"],
                           "checks": out["checks"],
                           "readings": out["readings"],
                           "metrics": out["metrics"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
