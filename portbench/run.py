"""Run one cell of the port's benchmark once, on the chip this process sees.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints a set-up line and the compared numbers beside their limits on
standard error, and one JSON object as the last line of standard output.
Exits non-zero, with no result, without a CUDA device (or fewer than the
cell asks for), without the program (``src/repro_torch``) beside this
folder, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from portbench.harness import Spec, run
    spec = Spec(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} CUDA device(s); this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run(spec, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), t_start=T_START)
    if out is None:
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
