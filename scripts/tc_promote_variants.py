#!/usr/bin/env python3
"""The tensor-core packed matmul beside the kernel it replaced and the
library product, and what its fp32 promotion costs: time text variants of
``ternary_matmul_tc.cu`` in one session on one card.

Run on a machine with one card, from the root of a checkout:

    git show <rev>:src/repro_torch/kernels/ternary_matmul/csrc/\
ternary_matmul_tc.cu > P.cu
    python3 scripts/tc_promote_variants.py --parent P.cu --json out.json

``P.cu`` is an earlier tensor-core kernel with the C entry
``ternary_matmul_tc_launch(x, packed, scale, y, M, K, K16, N, dtype, bm,
x_vec, w_vec, stream)`` and 16- or 64-row tiles (the ``mma.sync`` kernel of
commit b1a6bba).  Each source is compiled with nvcc for sm_90a and called
through ctypes:

- ``parent``: ``P.cu`` as it is, at the M tile that commit's wrapper
  picked (64 rows where that grid gave every SM a CTA, else 16);
- ``k1024``: this checkout's source (fp32 sums promoted every 1024 of K);
- ``k512``, ``k2048``: promoted every 512 or 2048 of K;
- ``end``: promoted once, after the last step (the total without the
  promotions between).

The variants run at ``kernel.tc_shape``'s tile and split.  Times are the
median CUDA-event time of a CUDA graph of 20 launches, per launch, with
the library product (``torch.matmul`` on the dense weight, times scale) in
the same session, in the order parent, variants, library and then the
reverse: qwen3-0.6b's w1 (K x N = 1024 x 3072) and w2 (3072 x 1024) at M
= 16 and 2048, and qwen2-72b's w1 (8192 x 29568) at M = 16, in bf16 and
fp32 (the promotion variants in fp32 only).  Beside each time, the host's
microseconds per call through the script's launcher (y allocated, the
shape picked, the C entry called; this checkout's encodes its tensor maps
there) for the parent and this checkout, 400 calls not synchronised.  Each
fp32 variant's largest error at K = 8192 (qwen2-72b's w1 at M = 16 and
2048) is given as a share of the limit 1e-4 + 1e-4·|want| of
``ternary_matmul_ref``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels",
                      "ternary_matmul", "csrc", "ternary_matmul_tc.cu")
EDITS = {
    "k1024": [],
    "k512": [("constexpr int kPromoteK = 1024;",
              "constexpr int kPromoteK = 512;")],
    "k2048": [("constexpr int kPromoteK = 1024;",
               "constexpr int kPromoteK = 2048;")],
    "end": [("((j + 1) % T::kPromoteSteps == 0 || j + 1 == n_local)",
             "(j + 1 == n_local)")],
}
FP32_ONLY = ("k512", "k2048", "end")
PARENT_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + \
    [ctypes.c_int] * 7 + [ctypes.c_void_p]


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
                   help="the earlier tensor-core kernel's source")
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
    from repro_torch.kernels.ternary_matmul.ref import (PACK,
                                                        ternary_matmul_ref,
                                                        unpack_ternary)
    from torch.utils.cpp_extension import CUDA_HOME

    out = os.path.join(ROOT, "build", "tc_promote_variants")
    os.makedirs(out, exist_ok=True)
    names = ["parent", *EDITS]
    sources = {name: variant_source(name, args.parent, out)
               for name in names}
    procs = []
    for name in names:
        so = os.path.join(out, f"{name}.so")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *cuda_lib.NVCC_FLAGS,
               "-o", so, sources[name]]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs = {name: proc.communicate()[0] for name, _, proc in procs}
    failed = [name for name, _, proc in procs if proc.returncode]
    if failed:
        for name in failed:
            print(logs[name], file=sys.stderr)
        return 1
    entries, ptxas = {}, {}
    for name, so, proc in procs:
        log = logs[name]
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "Potential" in ln]
        fn = ctypes.CDLL(so).ternary_matmul_tc_launch
        fn.argtypes = PARENT_ARGS if name == "parent" else list(
            cuda_lib.LIBRARIES["ternary_matmul_tc"].argtypes)
        fn.restype = ctypes.c_int
        entries[name] = fn
        print(f"{name}: {ptxas[name]}", flush=True)

    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def run(name, x, packed, scale):
        m, kx = x.shape
        k16, n = packed.shape
        y = torch.empty((m, n), dtype=x.dtype, device=dev)
        dtype = 0 if x.dtype == torch.float32 else 1
        x_vec = (kx * x.element_size()) % 16 == 0
        if name == "parent":
            bm = 64 if m >= 64 and -(-m // 64) * -(-n // 128) >= n_sm else 16
            shape = (bm,)
        else:
            shape = tk.tc_shape(m, n, k16, n_sm, x.dtype)
        err = entries[name](
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            m, kx, k16, n, dtype, *shape, int(x_vec), int(n % 4 == 0),
            torch.cuda.current_stream(dev).cuda_stream)
        cs.check(err == 0, f"{name}: launch error {err}")
        return y

    rows = []
    card = cs.card_line()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 8)
    # fp32 errors at K = 8192
    k, n = cs.QWEN2_72B
    packed, scale = cs.seeded_packed(k, n, gen, dev)
    for m in (16, 2048):
        x = torch.randn((m, k), generator=gen, device=dev)
        want = ternary_matmul_ref(x, packed, scale)
        limit = 1e-4 + 1e-4 * want.abs()
        for name in names:
            worst = float(((run(name, x, packed, scale) - want).abs() /
                           limit).max())
            row = {"variant": name, "what": "error", "model": "qwen2-72b",
                   "m": m, "k": k, "n": n, "worst_over_limit": worst,
                   "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    del packed, scale
    torch.cuda.empty_cache()
    # times, forward then reverse order
    d, f = cs.QWEN3_06B
    cases = [("qwen3-0.6b", "w1", d, f, 2048), ("qwen3-0.6b", "w1", d, f, 16),
             ("qwen3-0.6b", "w2", f, d, 2048), ("qwen3-0.6b", "w2", f, d, 16),
             ("qwen2-72b", "w1", *cs.QWEN2_72B, 16)]
    weights = {}
    for model, product, k, n, m in cases:
        if (k, n) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[(k, n)] = cs.seeded_packed(k, n, gen, dev)
        packed, scale = weights[(k, n)]
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[1]
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            w = torch.empty((k, n), dtype=dtype, device=dev)
            for lo in range(0, k, 1024):
                w[lo:lo + 1024] = unpack_ternary(
                    packed[lo // PACK:(lo + 1024) // PACK], dtype)
            sc = scale.to(dtype)
            want = run("parent", x, packed, scale)
            seq = ["parent", *(v for v in EDITS if dtype == torch.float32
                               or v not in FP32_ONLY), "library"]
            for name in ("parent", "k1024"):
                run(name, x, packed, scale)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(400):
                    run(name, x, packed, scale)
                host_us = (time.perf_counter() - t0) / 400 * 1e6
                torch.cuda.synchronize()
                row = {"variant": name, "what": "host_us_per_call",
                       "model": model, "product": product, "m": m, "k": k,
                       "n": n, "dtype": dname, "host_us": host_us,
                       "card": card}
                rows.append(row)
                print(json.dumps(row), flush=True)
            for order, names_in in (("forward", seq), ("reverse", seq[::-1])):
                for name in names_in:
                    if name == "library":
                        fn = lambda: torch.matmul(x, w) * sc  # noqa: E731
                        diff = None
                    else:
                        fn = lambda: run(name, x, packed, scale)  # noqa
                        diff = float((fn() - want).float().abs().max())
                    row = {"variant": name, "what": "time", "order": order,
                           "model": model, "product": product, "m": m,
                           "k": k, "n": n, "dtype": dname,
                           "shape": (None if name in ("parent", "library")
                                     else tk.tc_shape(m, n, k // PACK, n_sm,
                                                      dtype)),
                           "device_ms": cs.graph_ms(fn),
                           "max_abs_diff_vs_parent": diff, "card": card}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
            del w
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"ptxas": ptxas, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
