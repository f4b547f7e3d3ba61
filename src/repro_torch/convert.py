"""Carry programs and counters over from the reference's plain arrays.

The JAX package compiles programs the port cannot compile yet (the MAC
family).  Its :class:`CompiledProgram` is plain numpy underneath, so
:func:`compiled_from_arrays` rebuilds the port's program from the six
schedule tensors, and :func:`ap_stats_from_fields` rebuilds an
:class:`APStats` from the reference's fields: the two are what a test needs
to run the same program through both executors and compare the results.
"""
from __future__ import annotations

import numpy as np

from .apc.lower import CompiledProgram, Step
from .core.ap import APStats


def compiled_from_arrays(cmp_cols, keys, key_valid, hist_flag, wr_cols,
                         wr_vals, min_cols: int = 0) -> CompiledProgram:
    """Rebuild a program from its dense schedule tensors (the inverse of
    :class:`CompiledProgram`'s constructor): -1-padded columns and invalid
    keys are dropped, ``hist_flag`` becomes each step's ``in_hist``."""
    cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals = (
        np.asarray(t) for t in (cmp_cols, keys, key_valid, hist_flag,
                                wr_cols, wr_vals))
    steps = []
    for s in range(cmp_cols.shape[0]):
        c_ok = cmp_cols[s] >= 0
        w_ok = wr_cols[s] >= 0
        steps.append(Step(
            keys=tuple(tuple(int(v) for v in keys[s, k][c_ok])
                       for k in np.flatnonzero(key_valid[s])),
            compare_cols=tuple(int(c) for c in cmp_cols[s][c_ok]),
            write_cols=tuple(int(c) for c in wr_cols[s][w_ok]),
            write_vals=tuple(int(v) for v in wr_vals[s][w_ok]),
            in_hist=bool(hist_flag[s])))
    return CompiledProgram(tuple(steps), min_cols=min_cols)


def ap_stats_from_fields(radix: int, n_rows: int = 0,
                         n_compare_cycles: int = 0, n_write_cycles: int = 0,
                         sets: int = 0, resets: int = 0,
                         mismatch_hist=None) -> APStats:
    """An :class:`APStats` with the given fields (ints, int64 histogram)."""
    stats = APStats(radix=int(radix), n_rows=int(n_rows),
                    n_compare_cycles=int(n_compare_cycles),
                    n_write_cycles=int(n_write_cycles), sets=int(sets),
                    resets=int(resets))
    if mismatch_hist is not None:
        stats.mismatch_hist = np.asarray(mismatch_hist, np.int64).copy()
    return stats
