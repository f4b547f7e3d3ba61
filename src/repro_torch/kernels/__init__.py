"""Hand-written CUDA kernels for Hopper, each with a plain PyTorch version.

tap_pass        — fused MvAP LUT-schedule application: the whole compare/
                  write schedule runs on rows staged in shared memory, one
                  device-memory read and one write per row instead of a
                  round trip per pass.

Each kernel ships kernel.py (ctypes wrapper + build + launch counter),
csrc/*.cu (the CUDA source), ops.py (public wrappers) and ref.py (the plain
PyTorch versions: the oracle, and the path for tensors on the CPU).
"""
from . import tap_pass  # noqa: F401
