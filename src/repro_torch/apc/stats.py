"""Traced execution counters: kernel-side reductions, no per-pass syncs.

The pass-by-pass simulator (:func:`repro_torch.core.ap.apply_lut`) calls
``int()`` on every block's set/reset counts — one host round-trip per write
cycle.  The fused executor instead accumulates everything inside the
program kernel and returns a :class:`TracedStats` alongside the digit
array: ONE device->host transfer when (and only when) the caller converts
to :class:`~repro_torch.core.ap.APStats` for the Table XI energy model.

Counter semantics are bit-identical to the simulator:

- ``sets``/``resets`` follow the nTnR write rules (Table V): a changed digit
  is one SET (+ one RESET unless the old cell was don't-care).
- ``mismatch_hist[k]`` counts row-compares with exactly k mismatching
  masked cells, only for compares the simulator histograms (LUT passes, not
  repair sweeps).
- compare/write cycle counts are schedule-static and live on the
  :class:`~repro_torch.apc.lower.CompiledProgram`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.ap import APStats
from ..kernels.tap_pass.ref import HIST_BINS
from . import trace
from .lower import CompiledProgram

__all__ = ["HIST_BINS", "TracedStats", "accumulate", "to_ap_stats"]


class TracedStats(NamedTuple):
    """Kernel counters, one row per ``block_rows`` block.

    ``block_counts`` is (n_blocks, 2 + HIST_BINS) int32 laid out as
    [sets, resets, hist[0..HIST_BINS)].  Per-block values sit far from int32
    range; the *total* may not at extreme scale (mismatch-hist events =
    rows x histogrammed compares), so the cross-block reduction happens in
    int64 on the host at APStats-conversion time.  The convenience
    properties below give on-device int64 totals for interactive use.
    """
    block_counts: torch.Tensor    # (n_blocks, 2 + HIST_BINS) int32

    @property
    def sets(self) -> torch.Tensor:
        return self.block_counts[:, 0].sum()

    @property
    def resets(self) -> torch.Tensor:
        return self.block_counts[:, 1].sum()

    @property
    def mismatch_hist(self) -> torch.Tensor:
        return self.block_counts[:, 2:].sum(dim=0)


def to_ap_stats(traced: TracedStats, compiled: CompiledProgram,
                n_rows: int, radix: int) -> APStats:
    """One host sync: materialize the traced counters as an APStats."""
    out = APStats(radix=radix, n_rows=n_rows)
    accumulate(out, traced, compiled, n_rows)
    return out


def accumulate(stats: APStats, traced: TracedStats,
               compiled: CompiledProgram, n_rows: int,
               label: str = "") -> APStats:
    """Merge a traced run into an existing APStats (driver-style, in place).

    This is the single chokepoint every execution path's counters flow
    through, so it is also where per-program trace attribution is emitted
    (:meth:`repro_torch.apc.trace.Tracer.attribute`): the event carries
    exactly the integers merged here, which is what makes the tracer's
    per-phase totals sum bit-identically to the aggregated APStats.
    """
    # the one host sync
    counts = traced.block_counts.cpu().numpy().astype(np.int64)
    sets = int(counts[:, 0].sum())
    resets = int(counts[:, 1].sum())
    stats.sets += sets
    stats.resets += resets
    stats.n_compare_cycles += compiled.n_compare_cycles
    stats.n_write_cycles += compiled.n_write_cycles
    stats.n_rows = max(stats.n_rows, n_rows)
    hist = counts[:, 2:].sum(axis=0)
    nb = len(stats.mismatch_hist)
    if len(hist) > nb:
        # never drop histogram mass: the final APStats bin is ">= nb-1
        # mismatches", matching the kernel's own top-bin fold
        hist = np.concatenate([hist[:nb - 1], [hist[nb - 1:].sum()]])
    stats.mismatch_hist[:len(hist)] += hist
    tr = trace.current_tracer()
    if tr is not None:
        tr.attribute(sets=sets, resets=resets,
                     compare_cycles=compiled.n_compare_cycles,
                     write_cycles=compiled.n_write_cycles, n_rows=n_rows,
                     mismatch_hist=tuple(int(h) for h in hist), label=label)
    return stats
