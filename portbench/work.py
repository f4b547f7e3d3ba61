"""Frozen counts of the work the benchmark's kernels and model steps do,
priced only at the published peaks of one NVIDIA H100 SXM.

Nothing here reads the program: every count comes from shapes, row counts
and schedule sizes that the harness records.  The functions return the
least time the card could take for that work (a roofline's numerator).

Peaks (NVIDIA H100 SXM data sheet and whitepaper, dense, at the 700 W
limit):

- 989 TFLOP/s bf16 on the tensor cores;
- 3.35 TB/s of HBM3;
- INT32: 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.73 Tops/s.  A
  digit of the AP's rows is one byte, so one 32-bit instruction can
  compare or write four cells: the cell rate is four times the INT32 rate.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
CELLS_PER_INT32_OP = 4

PACK = 16                       # ternary digits per 32-bit word


def packed_matmul_bytes(m: int, k: int, n: int, x_bytes: int) -> int:
    """y[m, n] = (x[m, k] @ unpack(words)) * scale: the words, x and the
    scale read once and y written once."""
    words = -(-k // PACK) * n * 4
    return words + m * k * x_bytes + n * 4 + m * n * x_bytes


def packed_matmul_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def packed_matmul_seconds(m: int, k: int, n: int, x_bytes: int) -> float:
    """The least time of one packed-ternary product: bytes at the HBM rate
    or operations at the bf16 tensor-core rate, whichever is longer (fp32
    x is priced at the same rate: the work the product needs, not the
    passes a kernel chooses)."""
    return max(packed_matmul_bytes(m, k, n, x_bytes) / HBM_BYTES_PER_S,
               packed_matmul_flops(m, k, n) / BF16_FLOPS)


def program_cells(n_keys, n_compare_cols, n_write_cols) -> int:
    """Cell operations one row takes through a compiled program: per step,
    every valid key compared over the step's compare columns, and every
    write column written.  The arguments are per-step sequences."""
    return sum(k * c for k, c in zip(n_keys, n_compare_cols)) + \
        sum(n_write_cols)


def program_launch_seconds(rows: int, cols: int, cells_per_row: int) -> float:
    """The least time of one program launch over ``rows`` rows of ``cols``
    one-byte digits: each row read and written once at the HBM rate, or its
    cell operations at the INT32 rate with four byte cells an operation,
    whichever is longer.  No latency term."""
    byte_s = 2 * rows * cols / HBM_BYTES_PER_S
    op_s = rows * cells_per_row / (INT32_OPS_PER_S * CELLS_PER_INT32_OP)
    return max(byte_s, op_s)


def dense_token_flops(model: dict, context: int) -> int:
    """Model FLOPs of one token at position ``context - 1`` (it attends over
    ``context`` positions), as a dense step from the configuration's
    shapes: every projection at 2 FLOPs a weight (the ternary ones
    counted dense), attention's scores and values at 4 x heads x head_dim
    a position, and the output head.  Norms, RoPE and the embedding
    lookup are left out."""
    d = model["d_model"]
    hd = model.get("head_dim") or d // model["n_heads"]
    h, hk = model["n_heads"], model["n_kv_heads"]
    attn_w = d * h * hd + 2 * d * hk * hd + h * hd * d
    mlp_w = 3 * d * model["d_ff"]
    per_layer = 2 * (attn_w + mlp_w) + 4 * h * hd * context
    return model["n_layers"] * per_layer + 2 * d * model["vocab"]


def steps_flops(model: dict, steps) -> int:
    """Sum of :func:`dense_token_flops` over ``steps``, each a
    ``(position, batch)`` pair: ``batch`` tokens at ``position``."""
    return sum(b * dense_token_flops(model, pos + 1) for pos, b in steps)
