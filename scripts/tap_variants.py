#!/usr/bin/env python3
"""Where the time of a one-row-per-thread TAP program kernel goes: time
variants of its source with one part of the step taken out.

Run on a machine with one card, from the root of a checkout:

    git show <rev>:src/repro_torch/kernels/tap_pass/csrc/tap_program.cu > D/tap_program.cu
    git show <rev>:src/repro_torch/kernels/tap_pass/csrc/tap_common.cuh > D/tap_common.cuh
    python3 scripts/tap_variants.py --src D --json out.json

``D`` holds a one-row-per-thread scalar program kernel (the design that the
four-rows-per-thread kernel replaced; ``<rev>`` is a commit that has it).  Each
variant is a text edit of those two files, compiled with nvcc for sm_90a and
timed with CUDA events on the program kernel's two timed shapes: add 3x20 at
2^20 rows (421 steps, 41 columns) and the AP matmul's tile program (24329
steps, 650 columns) at 12288 rows, counters on.  The variants compute wrong
digits on purpose: only their times mean anything.

- ``base``: the source as it is;
- ``nohist``: the 8-bin histogram update (16 instructions per key) becomes
  one add;
- ``nowrite``: tagged rows count a set instead of writing;
- ``l1sched``: the slot index is taken mod 64, so every schedule load hits
  the same 64 slots (L1-resident);
- ``static``: K, C and W become compile-time constants (the loops unroll);
- ``floor``: all four at once.

Prints one line per (variant, program) with the time and the SM cycles per
warp per step at the card's boost clock (1.98 GHz, 132 SMs).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SM_CLOCK_HZ, N_SM = 1.98e9, 132

EDITS = {
    "nohist": [("tap_common.cuh",
                "for (int b = 0; b < kHistBins; ++b) hist[b] += (bin == b);",
                "hist[0] += bin;")],
    "nowrite": [("tap_program.cu",
                 "tap::slot_write<kStats>(row, stride, cols, g * pack + p, W,\n"
                 "                                  wr_cols, wr_vals, sets, "
                 "resets);", "sets += 1;")],
    "l1sched": [("tap_program.cu", "const int s = g * pack + p;",
                 "const int s = (g * pack + p) & 63;"),
                ("tap_program.cu", "g * pack + p, W,",
                 "(g * pack + p) & 63, W,")],
    "static": [("tap_program.cu", "  const int t = threadIdx.x;\n",
                "  const int t = threadIdx.x;\n  K = SK; C = SC; W = SW;\n")],
}
EDITS["floor"] = (EDITS["nohist"] + EDITS["l1sched"][:1] + EDITS["nowrite"]
                  + EDITS["static"])


def variant_sources(src: str, out: str, name: str) -> str:
    texts = {f: open(os.path.join(src, f)).read()
             for f in ("tap_program.cu", "tap_common.cuh")}
    for fname, old, new in EDITS.get(name, []):
        if old not in texts[fname]:
            raise SystemExit(f"variant {name}: pattern not in {fname}: "
                             f"{old!r}")
        texts[fname] = texts[fname].replace(old, new)
    d = os.path.join(out, name)
    os.makedirs(d, exist_ok=True)
    for fname, text in texts.items():
        with open(os.path.join(d, fname), "w") as f:
            f.write(text)
    return d


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", required=True)
    p.add_argument("--json")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tap_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import apc
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.tap_pass.ops import _pad_rows
    from torch.utils.cpp_extension import CUDA_HOME

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    programs = []
    add = apc.compile_named("add", 3, 20)
    a = rng.integers(0, 3, (1 << 20, 41)).astype(np.int8)
    programs.append(("add3x20", add, a, 4096))
    width = apc.mac_acc_width(3, 1024, 7)
    tile = apc.compile_mac_tiled(3, 1024, width, 64).programs[0]
    x = rng.integers(-7, 8, (12288, 64))
    w = rng.integers(-1, 2, (12288, 64))
    programs.append(("mac_tile", tile, apc.encode_mac_rows(x, w, 3, width),
                     4096))

    build = os.path.join(ROOT, "build", "tap_variants")
    names = ["base", "nohist", "nowrite", "l1sched", "static", "floor"]
    libs, procs = {}, []
    for name in names:
        d = variant_sources(args.src, build, name)
        for pname, prog, _, _ in programs:
            C, W = prog.cmp_cols.shape[1], prog.wr_cols.shape[1]
            K = prog.keys.shape[1]
            so = os.path.join(d, f"{pname}.so")
            cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *cuda_lib.NVCC_FLAGS,
                   f"-DSK={K}", f"-DSC={C}", f"-DSW={W}", "-o", so,
                   os.path.join(d, "tap_program.cu")]
            procs.append((name, pname, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for name, pname, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        fn = ctypes.CDLL(so).tap_run_program_launch
        V, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [V, V, L, I, I, L, V, V, V, V, V, V, I, I, I, I, I, V,
                       I, V]
        fn.restype = I
        libs[(name, pname)] = fn

    results = []
    for pname, prog, arr, block_rows in programs:
        t = [torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for v in prog.schedule_tensors]
        t = [t[0].int(), t[1].to(torch.int8), t[2].to(torch.uint8),
             t[3].to(torch.uint8), t[4].int(), t[5].to(torch.int8)]
        rows = arr.shape[0]
        padded, _ = _pad_rows(torch.from_numpy(arr).to(dev), block_rows)
        out = torch.empty_like(padded)
        cols = padded.shape[1]
        counts = torch.zeros((padded.shape[0] // block_rows, 10),
                             dtype=torch.int32, device=dev)
        threads = 256
        while cols * threads > 232448:
            threads //= 2
        S, C = t[0].shape
        K, W = t[1].shape[1], t[4].shape[1]
        for name in names:
            fn = libs[(name, pname)]

            def run():
                err = fn(padded.data_ptr(), out.data_ptr(), padded.shape[0],
                         cols, block_rows, rows, *(v.data_ptr() for v in t),
                         S, 1, K, C, W, counts.data_ptr(), threads,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} {pname}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            times = []
            for _ in range(3 if pname == "mac_tile" else 5):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                run()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            ms = statistics.median(times)
            warp_steps = padded.shape[0] / 32 * S
            cyc = ms * 1e-3 * SM_CLOCK_HZ * N_SM / warp_steps
            row = {"variant": name, "program": pname, "rows": rows,
                   "cols": cols, "steps": S, "ms": ms,
                   "sm_cycles_per_warp_step": cyc}
            results.append(row)
            print(f"{name:8s} {pname:9s} rows={rows} steps={S} {ms:.3f} ms "
                  f"{cyc:.1f} SM-cycles per warp-step", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
