"""Public wrappers around the fused TAP LUT kernels."""
from __future__ import annotations

import torch

from ...core.lut import LUT
from ...device import as_digits
from .kernel import BLOCK_ROWS, tap_apply_schedule, tap_run_program
from .ref import ripple_add_schedule, schedule_from_lut

# Schedules longer than this run through the program kernel
# (tap_run_program), which reads its schedule from device memory; short
# ones go to the schedule kernel, which stages the whole schedule in shared
# memory.
UNROLL_STEP_LIMIT = 64


def _pad_rows(arr: torch.Tensor, block_rows: int
              ) -> tuple[torch.Tensor, int]:
    rows = arr.shape[0]
    padded = (rows + block_rows - 1) // block_rows * block_rows
    if padded != rows:
        # don't-care rows never match any key and pass through unchanged
        pad = torch.full((padded - rows, arr.shape[1]), -1, dtype=arr.dtype,
                         device=arr.device)
        arr = torch.cat([arr, pad], dim=0)
    return arr, rows


def _run_schedule(arr: torch.Tensor, sched, block_rows: int,
                  kernel_variant: str | None = None) -> torch.Tensor:
    """Dispatch a flat schedule to the schedule or program kernel."""
    padded, rows = _pad_rows(arr, block_rows)
    if len(sched) <= UNROLL_STEP_LIMIT:
        out = tap_apply_schedule(padded, sched, block_rows=block_rows)
        return out[:rows]
    from ...apc.exec import device_schedule          # lazy: import cycle
    from ...apc.lower import Step, _compile_steps
    compiled = _compile_steps(tuple(
        Step(keys=k, compare_cols=c, write_cols=w, write_vals=v,
             in_hist=bool(k)) for k, c, w, v in sched))
    if compiled.min_cols > padded.shape[1]:
        raise ValueError(f"schedule touches a column >= {padded.shape[1]}")
    tensors, _, pack = device_schedule(compiled, kernel_variant,
                                       padded.device)
    out, _ = tap_run_program(padded, *tensors, rows, block_rows=block_rows,
                             pack=pack)
    return out[:rows]


def tap_apply_lut(arr, lut: LUT, col_map: tuple[int, ...],
                  block_rows: int = BLOCK_ROWS,
                  kernel_variant: str | None = None,
                  device=None) -> torch.Tensor:
    """One LUT application (single digit position) on the kernel path."""
    sched = schedule_from_lut(lut, col_map)
    return _run_schedule(as_digits(arr, device), sched, block_rows,
                         kernel_variant)


def tap_ripple_add(arr, lut: LUT, width: int, carry_col: int,
                   a_base: int = 0, b_base: int | None = None,
                   block_rows: int = BLOCK_ROWS,
                   kernel_variant: str | None = None,
                   device=None) -> torch.Tensor:
    """Fused p-digit in-place add: B <- A + B in ONE kernel launch.

    A 20-trit non-blocked add is 441 compare + 441 write passes; the naive
    path moves the array to and from device memory for each, while this
    launch reads and writes each row once.  Wide adds route through the
    program kernel (see ``UNROLL_STEP_LIMIT``).
    """
    sched = ripple_add_schedule(lut, width, carry_col, a_base, b_base)
    return _run_schedule(as_digits(arr, device), sched, block_rows,
                         kernel_variant)


def hbm_traffic_model(n_rows: int, n_cols: int, lut: LUT, width: int
                      ) -> dict[str, float]:
    """Analytical device-memory bytes: fused kernel vs per-pass replay.

    The per-pass path reads the compare columns and rewrites the write
    columns for every pass; the fused path reads + writes the array once.
    """
    bytes_array = n_rows * n_cols                       # int8
    naive = 0
    for blk in lut.blocks:
        naive += len(blk.keys) * n_rows * lut.width     # compare reads
        naive += n_rows * len(blk.write_cols) * 2       # write read+write
    naive *= width                                      # per digit position
    fused = 2 * bytes_array                             # one read + one write
    # n_rows == 0 moves no bytes either way: report no reduction (1x)
    return {"naive_bytes": float(naive), "fused_bytes": float(fused),
            "reduction_x": naive / fused if fused else 1.0}
