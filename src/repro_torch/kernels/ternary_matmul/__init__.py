"""Packed balanced-ternary matmul: three backends behind one dispatcher.

``ternary_matmul(x, packed, scale, impl=...)`` routes to:

- ``impl="ref"`` — the plain PyTorch oracle (:mod:`.ref`): unpack the 2-bit
  weights to a dense fp32 matrix and matmul.  Correctness baseline for the
  other two; use it in tests and for one-off host math.
- ``impl="pallas"`` (default; also ``"packed"``, the reference's names) —
  the packed-weight CUDA kernel (:mod:`.kernel` via
  :func:`~.ops.ternary_matmul_op`): weights stay 2-bit in device memory and
  are decoded in registers, so the weight traffic of a decode-shape matmul
  drops 8x vs bf16.  The serving path.  Tensors on the CPU take the plain
  version.
- ``impl="ap"`` — the associative-processor MAC program (:mod:`.ap`): every
  output cell is a CAM row and the dot product runs as predicated in-place
  add/sub sweeps compiled by :func:`repro_torch.apc.compile_mac` — the
  paper's in-memory arithmetic on the serving path.  Exact integer
  arithmetic (activations must be integer-valued) with per-matmul cycle
  counts for the Table XI energy model; ``k_tile=`` splits K into tiles
  folded by ripple-add reductions, bit-exact vs ``impl="ref"``.
"""
from . import ap, kernel, ops, ref
from .ops import quantize_and_pack, ternary_matmul, ternary_matmul_op

__all__ = ["ap", "kernel", "ops", "ref", "quantize_and_pack",
           "ternary_matmul", "ternary_matmul_op"]
