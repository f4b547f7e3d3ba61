#!/usr/bin/env python3
"""Where the cost of the fp32 promotion in the tensor-core packed matmul
comes from: time text variants of ``ternary_matmul_tc.cu`` that promote
the sums at other K intervals, beside a source without promotion.

Run on a machine with one card, from the root of a checkout:

    git show <rev>:src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul_tc.cu > P.cu
    python3 scripts/tc_promote_variants.py --parent P.cu --json out.json

``P.cu`` is a tensor-core kernel that sums all of K in one accumulator
(``<rev>`` is a commit that has it).  Variants of this checkout's source,
each compiled with nvcc for sm_90a and called through ctypes:

- ``parent``: ``P.cu`` as it is;
- ``k512``: this checkout's source (sums promoted every 512 of K into a
  second set of accumulators, in registers);
- ``k1024``, ``k2048``: promoted every 1024 or 2048 of K;
- ``end``: promoted once, after the last step (the second set of
  accumulators without the promotions);
- ``smem``: the 64- and 128-row tiles keep the total in shared memory,
  one float per accumulator and thread, read and written once per
  promotion (fewer registers, more shared memory per CTA).

Timed on fp32 x at qwen3-0.6b's two MLP products at M = 2048 (K x N =
1024 x 3072 and 3072 x 1024) on the M tile the wrapper picks: the median
CUDA-event time of a CUDA graph of 20 launches, per launch, the variants
timed in one order and then the reverse.  Each variant's largest error on
qwen2-72b's w1 (K = 8192, N = 29568, M = 1 and 16; the inputs
``chip_smoke.py`` draws) is given as a share of the limit 1e-4 +
1e-4·|want| of ``ternary_matmul_ref``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels",
                      "ternary_matmul", "csrc", "ternary_matmul_tc.cu")
EDITS = {
    "k512": [],
    "k1024": [("constexpr int kPromoteK = 512;",
               "constexpr int kPromoteK = 1024;")],
    "k2048": [("constexpr int kPromoteK = 512;",
               "constexpr int kPromoteK = 2048;")],
    "end": [("if ((kt + 1) % kPromoteSteps == 0 || kt + 1 == n_steps) "
             "promote();", "if (kt + 1 == n_steps) promote();")],
    "smem": [
        ("  static constexpr int kSmem = kStages * (kXBytes + kWBytes);\n",
         "  static constexpr bool kSmemTotal =\n"
         "      std::is_same_v<XT, float> && kMI * kNI >= 16;\n"
         "  static constexpr int kTotalBytes = kSmemTotal ? kMI * kNI * 16 * "
         "kThreads\n                                                : 0;\n"
         "  static constexpr int kSmem = kStages * (kXBytes + kWBytes) + "
         "kTotalBytes;\n"),
        ("  float acc[kMI][kNI][4], total[kMI][kNI][4];\n",
         "  float acc[kMI][kNI][4], total[kMI][kNI][4];\n"
         "  float* const tot = reinterpret_cast<float*>(\n"
         "      smem + kStages * (T::kXBytes + T::kWBytes)) + threadIdx.x;\n"
         "  const auto total_at = [&](int i, int j, int q) -> float& {\n"
         "    if constexpr (T::kSmemTotal)\n"
         "      return tot[((i * kNI + j) * 4 + q) * T::kThreads];\n"
         "    else\n"
         "      return total[i][j][q];\n"
         "  };\n"),
        ("acc[i][j][q] = total[i][j][q] = 0.f;",
         "acc[i][j][q] = total_at(i, j, q) = 0.f;"),
        ("total[i][j][q] += acc[i][j][q];",
         "total_at(i, j, q) += acc[i][j][q];"),
        ("  cp_async_wait<0>();\n\n",
         "  cp_async_wait<0>();\n"
         "  if constexpr (kFp32) {\n"
         "#pragma unroll\n"
         "    for (int i = 0; i < kMI; ++i)\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < kNI; ++j)\n"
         "#pragma unroll\n"
         "        for (int q = 0; q < 4; ++q) acc[i][j][q] = total_at(i, j, "
         "q);\n"
         "  }\n\n"),
        ("(kFp32 ? total : acc)[i][j][2 * h] * s0;", "acc[i][j][2 * h] * s0;"),
        ("(kFp32 ? total : acc)[i][j][2 * h + 1] * s1;",
         "acc[i][j][2 * h + 1] * s1;")],
}


def variant_source(name: str, parent: str, out: str) -> str:
    text = open(parent if name == "parent" else SOURCE).read()
    for old, new in EDITS.get(name, []):
        if old not in text:
            raise SystemExit(f"variant {name}: pattern not in the source: "
                             f"{old!r}")
        text = text.replace(old, new)
    path = os.path.join(out, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True,
                   help="a ternary_matmul_tc.cu without promotion")
    p.add_argument("--json")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tc_promote_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref
    from torch.utils.cpp_extension import CUDA_HOME

    out = os.path.join(ROOT, "build", "tc_promote_variants")
    os.makedirs(out, exist_ok=True)
    names = ["parent", *EDITS]
    procs = []
    for name in names:
        so = os.path.join(out, f"{name}.so")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *cuda_lib.NVCC_FLAGS,
               "-o", so, variant_source(name, args.parent, out)]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    entries, ptxas = {}, {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln]
        fn = ctypes.CDLL(so).ternary_matmul_tc_launch
        fn.argtypes = list(cuda_lib.LIBRARIES["ternary_matmul_tc"].argtypes)
        fn.restype = ctypes.c_int
        entries[name] = fn
        print(f"{name}: {ptxas[name]}", flush=True)

    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def run(name, x, packed, scale, bm):
        m, kx = x.shape
        k16, n = packed.shape
        y = torch.empty((m, n), dtype=x.dtype, device=dev)
        err = entries[name](
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            m, kx, k16, n, 0, bm, int(kx % 4 == 0), int(n % 4 == 0),
            torch.cuda.current_stream(dev).cuda_stream)
        cs.check(err == 0, f"{name}: launch error {err}")
        return y

    rows = []
    card = cs.card_line()
    # errors at K = 8192 on chip_smoke's qwen2-72b inputs (same draws)
    k, n = cs.QWEN2_72B
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 8)
    packed, scale = cs.seeded_packed(k, n, gen, dev)
    for m in (1, 16):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            torch.randint(-cs.AP_MAX_ABS, cs.AP_MAX_ABS + 1, (m, k),
                          generator=gen, device=dev)
            if dtype != torch.float32:
                continue
            want = ternary_matmul_ref(x, packed, scale)
            limit = 1e-4 + 1e-4 * want.abs()
            for name in names:
                y = run(name, x, packed, scale, tk.tc_m_tile(m, n, n_sm))
                worst = float(((y - want).abs() / limit).max())
                row = {"variant": name, "what": "error", "model":
                       "qwen2-72b", "m": m, "k": k, "n": n,
                       "worst_over_limit": worst, "card": card}
                rows.append(row)
                print(json.dumps(row), flush=True)
    del packed, scale
    # times at qwen3-0.6b M = 2048, fp32, forward then reverse order
    d, f = cs.QWEN3_06B
    for k, n in ((d, f), (f, d)):
        packed, scale = cs.seeded_packed(k, n, gen, dev)
        x = torch.randn((2048, k), generator=gen, device=dev)
        bm = tk.tc_m_tile(2048, n, n_sm)
        want = run("parent", x, packed, scale, bm)
        for order, seq in (("forward", names), ("reverse", names[::-1])):
            for name in seq:
                diff = float((run(name, x, packed, scale, bm) - want).abs()
                             .max())
                ms = cs.graph_ms(lambda: run(name, x, packed, scale, bm))
                row = {"variant": name, "what": "time", "order": order,
                       "model": "qwen3-0.6b", "m": 2048, "k": k, "n": n,
                       "bm": bm, "device_ms": ms,
                       "max_abs_diff_vs_parent": diff, "card": card}
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"ptxas": ptxas, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
