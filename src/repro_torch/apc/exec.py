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
(``None`` = ``cuda:0``, see :mod:`repro_torch.device`);
:func:`execute_sharded` splits row blocks over a *mesh*, a sequence of
torch devices that stands in for the reference's data axes (``[cuda:0]``
on one card; a device may repeat), and sums the per-shard counter tensors
elementwise, as the reference's ``psum`` does, so every shard's counts are
global; :func:`run` with ``pool=`` streams row blocks over a bank of
bounded MvCAM arrays (:mod:`repro_torch.apc.pool`) instead of assuming one
unbounded array — a :class:`repro_torch.apc.runtime.DevicePool` there
spans the bank over a mesh, and whole dependency DAGs of programs schedule
through :class:`repro_torch.apc.runtime.Runtime` rather than this
single-program door.
"""
from __future__ import annotations

import weakref

import torch

from ..core.ap import APStats
from ..device import as_digits, resolve_device
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


def mesh_devices(mesh) -> list[torch.device]:
    """The devices of a mesh (a sequence of devices or device names), in
    shard order; raises on an empty one."""
    devices = [resolve_device(d) for d in mesh]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def sharded_program_run(padded: torch.Tensor, scheds, mesh, rows: int,
                        block_rows: int, *, collect_stats: bool,
                        pack: int = 1
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Scaffolding shared by :func:`execute_sharded` and
    :class:`repro_torch.apc.runtime.DevicePool`: split ``padded`` (rows
    already a multiple of shards x block_rows) into one contiguous shard
    per device of ``mesh``, run each device's schedule tensors
    (``scheds[i]`` on ``mesh[i]``) over its shard with its padding rows
    masked via the shard's global row offset, and sum the raw counter
    tensors elementwise across shards so the result holds the GLOBAL counts
    of each shard-local block.  Returns ``(out, raw)`` on ``mesh[0]``, with
    ``out`` still padded (caller slices) and ``raw`` ``None`` unless
    ``collect_stats``."""
    n_shards = len(mesh)
    shard_rows = padded.shape[0] // n_shards
    home = mesh[0]
    outs, raw = [], None
    for i, (dev, sched) in enumerate(zip(mesh, scheds)):
        # global row index of this shard's first row -> how many of its rows
        # are real (the tail shards see the padding)
        n_local = min(max(rows - i * shard_rows, 0), shard_rows)
        shard = padded[i * shard_rows:(i + 1) * shard_rows].to(dev)
        out, counts = tap_run_program(
            shard, *sched, n_local, block_rows=block_rows,
            collect_stats=collect_stats, pack=pack)
        outs.append(out.to(home))
        if collect_stats:
            counts = counts.to(home)
            raw = counts if raw is None else raw + counts
    return torch.cat(outs, dim=0), raw


def execute_sharded(arr, compiled: CompiledProgram, mesh, *,
                    collect_stats: bool = False,
                    block_rows: int | None = None,
                    kernel_variant: str | None = None
                    ) -> tuple[torch.Tensor, TracedStats | None]:
    """Shard rows over the mesh's devices and run the fused kernel
    per shard; traced counters are summed across shards so the returned
    stats are global.  The digits come back on ``mesh[0]``."""
    devices = mesh_devices(mesh)
    n_shards = len(devices)
    arr = as_digits(arr, devices[0])
    rows, cols = arr.shape
    if rows == 0:                       # empty batch: no shards
        return execute(arr, compiled, collect_stats=collect_stats,
                       block_rows=block_rows, kernel_variant=kernel_variant,
                       device=devices[0])
    if cols < compiled.min_cols:
        raise ValueError(
            f"array has {cols} columns, program touches {compiled.min_cols}")
    block_rows = block_rows or min(BLOCK_ROWS,
                                   max(8, -(-rows // n_shards)))
    padded, _ = _pad_rows(arr, n_shards * block_rows)
    scheds = []
    for dev in devices:
        sched, variant, pack = device_schedule(compiled, kernel_variant,
                                               dev)
        scheds.append(sched)
    with trace.span("execute_sharded", cat="execute", rows=rows,
                    steps=compiled.n_steps, variant=variant, pack=pack,
                    shards=n_shards):
        out, raw = sharded_program_run(padded, scheds, devices, rows,
                                       block_rows,
                                       collect_stats=collect_stats,
                                       pack=pack)
    out = out[:rows]
    return out, (TracedStats(raw) if collect_stats else None)


# ---------------------------------------------------------------------------
# Driver-style front door (what core/ap.py routes through)
# ---------------------------------------------------------------------------

def run(arr, program: Program | CompiledProgram, *,
        stats: APStats | None = None, mesh=None, pool=None,
        block_rows: int | None = None, kernel_variant: str | None = None,
        device=None) -> torch.Tensor:
    """Compile (cached) + execute; optionally merge traced counters into an
    existing :class:`APStats` (one host sync, after the run completes).

    ``pool`` (an :class:`~repro_torch.apc.pool.ArrayPool`) streams row
    blocks over a bank of bounded arrays on the pool's device instead of
    the single resident array; ``mesh`` (a sequence of devices) shards the
    rows over them; the two are mutually exclusive.  ``device`` applies to
    neither route.
    """
    compiled = (program if isinstance(program, CompiledProgram)
                else compile_program(program))
    if pool is not None:
        if mesh is not None:
            raise ValueError("pass either mesh= or pool=, not both")
        if block_rows is not None:
            raise ValueError("block_rows only applies without pool=; the "
                             "pool's own rows govern block streaming")
        from .pool import run_pooled                # lazy: import cycle
        return run_pooled(arr, compiled, pool, stats=stats,
                          kernel_variant=kernel_variant)
    kw = dict(collect_stats=stats is not None, block_rows=block_rows,
              kernel_variant=kernel_variant)
    if mesh is not None:
        out, traced = execute_sharded(arr, compiled, mesh, **kw)
    else:
        out, traced = execute(arr, compiled, device=device, **kw)
    if stats is not None:
        accumulate(stats, traced, compiled, n_rows=arr.shape[0])
    return out
