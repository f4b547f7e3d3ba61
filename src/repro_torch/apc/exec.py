"""Fused executor for compiled AP programs.

One program launch replays the ENTIRE flattened program against every row
— a 20-trit add (421 steps) or a shift-and-add multiply (thousands of
steps) costs one device-memory read + one write per row instead of one
round-trip per pass.  The program kernel
(:func:`repro_torch.kernels.tap_pass.kernel.tap_run_program`) loops over
the dense schedule tensors of a :class:`~repro_torch.apc.lower.CompiledProgram`.

Kernel variants (``kernel_variant=``, default ``"gather"``, see
:func:`~repro_torch.apc.lower.default_kernel_variant`):

- ``"gather"`` and ``"onehot"`` — the flat schedule.
- ``"onehot_packed"`` — the VLIW-packed schedule
  (:func:`~repro_torch.apc.lower.pack_steps`): groups of independent slots,
  same digits and APStats.

Rows are the data-parallel axis.  :func:`execute` runs on ``device``
(``None`` = ``cuda:0``, see :mod:`repro_torch.device`); row sharding over
several devices (``mesh=``) and the bounded array bank (``pool=``) come
with later parts of the port.
"""
from __future__ import annotations

import weakref

import torch

from ..core.ap import APStats
from ..device import as_digits
from ..kernels.tap_pass.kernel import program_tensors_on, tap_run_program
from ..kernels.tap_pass.ops import _pad_rows
from . import trace
from .ir import Program
from .lower import CompiledProgram, compile_program, resolve_schedule
from .stats import HIST_BINS, TracedStats, accumulate

BLOCK_ROWS = 4096        # fused-program default: fewer, fatter row-blocks

# compiled program -> {(resolved variant, device): (tensors, variant, pack)}
_on_device: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def device_schedule(compiled: CompiledProgram, kernel_variant: str | None,
                    device: torch.device):
    """The program's schedule tensors for ``kernel_variant`` on ``device``
    (copied there once per program), with the kernel's variant and pack."""
    tensors, variant, pack, name = resolve_schedule(compiled, kernel_variant)
    per_prog = _on_device.setdefault(compiled, {})
    key = (name, str(device))
    hit = per_prog.get(key)
    if hit is None:
        hit = per_prog[key] = (program_tensors_on(tensors, device), variant,
                               pack)
    return hit


def execute(arr, compiled: CompiledProgram, *, collect_stats: bool = False,
            block_rows: int | None = None,
            kernel_variant: str | None = None, device=None
            ) -> tuple[torch.Tensor, TracedStats | None]:
    """Run a compiled program on [rows, cols] int8 digits.

    Returns ``(out, traced)``; ``traced`` is ``None`` unless
    ``collect_stats`` — stats cost extra in-kernel reductions, so the pure
    path skips them entirely (a separate kernel instantiation).
    """
    arr = as_digits(arr, device)
    rows, cols = arr.shape
    if cols < compiled.min_cols:
        raise ValueError(
            f"array has {cols} columns, program touches {compiled.min_cols}")
    if rows == 0:                       # empty batch: no launch, zero counts
        traced = TracedStats(torch.zeros((1, 2 + HIST_BINS),
                                         dtype=torch.int32,
                                         device=arr.device))
        return arr, traced if collect_stats else None
    sched, variant, pack = device_schedule(compiled, kernel_variant,
                                           arr.device)
    block_rows = block_rows or min(BLOCK_ROWS, max(8, rows))
    padded, _ = _pad_rows(arr, block_rows)
    with trace.span("execute", cat="execute", rows=rows,
                    steps=compiled.n_steps, variant=variant, pack=pack):
        out, raw = tap_run_program(
            padded, *sched, rows, block_rows=block_rows,
            collect_stats=collect_stats, pack=pack)
    out = out[:rows]
    return out, (TracedStats(block_counts=raw) if collect_stats else None)


# ---------------------------------------------------------------------------
# Driver-style front door (what core/ap.py routes through)
# ---------------------------------------------------------------------------

def run(arr, program: Program | CompiledProgram, *,
        stats: APStats | None = None, mesh=None, pool=None,
        block_rows: int | None = None, kernel_variant: str | None = None,
        device=None) -> torch.Tensor:
    """Compile (cached) + execute; optionally merge traced counters into an
    existing :class:`APStats` (one host sync, after the run completes)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (rows sharded over devices) is not ported yet: it comes "
            "with the graph runtime")
    if pool is not None:
        raise NotImplementedError(
            "pool= (the bounded array bank) is not ported yet: it comes "
            "with the array pool")
    compiled = (program if isinstance(program, CompiledProgram)
                else compile_program(program))
    out, traced = execute(arr, compiled, collect_stats=stats is not None,
                          block_rows=block_rows,
                          kernel_variant=kernel_variant, device=device)
    if stats is not None:
        accumulate(stats, traced, compiled, n_rows=arr.shape[0])
    return out
