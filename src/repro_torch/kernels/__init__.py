"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch version.

tap_pass        — fused MvAP LUT-schedule application: the whole compare/
                  write schedule runs on rows staged in shared memory, one
                  device-memory read and one write per row instead of a
                  round trip per pass.
decode_attention — GQA decode attention read straight from a bf16 or fp16
                  KV cache: each cache element read once a step for all of
                  its group's query heads, fp32 maths, no copy of the cache.
ternary_matmul  — packed balanced-ternary (2-bit) weight matmul: weights held
                  16-per-int32 in device memory and decoded in registers,
                  fp32 accumulation — the serving path's weight-byte lever.

Each kernel ships kernel.py (ctypes wrapper + launch counter), csrc/*.cu
(the CUDA source), ops.py (public wrappers) and ref.py (the plain PyTorch
versions: the oracle, and the path for tensors on the CPU).  All of them
build through :mod:`.cuda_lib`.
"""
from . import cuda_lib, decode_attention, tap_pass, ternary_matmul  # noqa: F401
