"""Carry programs, counters and weights over from the reference's arrays.

The reference's :class:`CompiledProgram` is plain numpy underneath, so
:func:`compiled_from_arrays` rebuilds the port's program from the six
schedule tensors, and :func:`ap_stats_from_fields` rebuilds an
:class:`APStats` from the reference's fields: the two are what a test needs
to run the same program through both executors and compare the results.
:func:`packed_mlp_from_arrays` carries packed ternary MLP weights across,
so both packages multiply by the same words and scales,
:func:`params_from_arrays` a whole model's parameter tree, and
:func:`train_state_from_arrays` a train state (params and AdamW state).
"""
from __future__ import annotations

import numpy as np
import torch

from .apc.lower import CompiledProgram, Step
from .core.ap import APStats
from .device import resolve_device


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


def packed_mlp_from_arrays(params: dict, device=None) -> dict:
    """The reference's packed MLP parameters as the port's tensors.

    ``params`` is the dict :func:`repro.models.quant.pack_mlp_params`
    returns (``w1_packed``, ``w1_scale``, ...), each leaf converted to numpy
    by the caller.  Returns the same keys as tensors on ``device``
    (``None`` = ``cuda:0``): ``*_packed`` int32 words, ``*_scale`` fp32.
    """
    dev = resolve_device(device)
    out = {}
    for key, val in params.items():
        dtype = torch.int32 if key.endswith("_packed") else torch.float32
        out[key] = torch.from_numpy(np.array(val)).to(
            device=dev, dtype=dtype)
    return out


def params_from_arrays(tree: dict, device=None) -> dict:
    """The reference's ``init_params`` tree as the port's tensors.

    ``tree`` is the nested dict, each leaf converted to numpy by the caller
    (bf16 leaves through fp32).  int32 leaves (packed words) stay int32,
    floating leaves become fp32 tensors, on ``device`` (``None`` =
    ``cuda:0``).  The port's :func:`~repro_torch.models.model.init_params`
    makes the same tree.
    """
    dev = resolve_device(device)

    def leaf(val):
        arr = np.asarray(val)
        if arr.dtype == np.int32:
            dtype = torch.int32
        elif np.issubdtype(arr.dtype, np.floating):
            arr, dtype = arr.astype(np.float32), torch.float32
        else:
            raise TypeError(f"params_from_arrays: leaf of dtype {arr.dtype}")
        return torch.from_numpy(np.array(arr)).to(device=dev, dtype=dtype)

    return {k: params_from_arrays(v, dev) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def train_state_from_arrays(state: dict, device=None) -> dict:
    """The reference's train state (``init_train_state`` or a step's
    output) as the port's: ``params``, ``opt/m`` and ``opt/v`` through
    :func:`params_from_arrays` (fp32), ``opt/step`` an int32 scalar, on
    ``device`` (``None`` = ``cuda:0``).  Leaves are numpy arrays (bf16
    leaves through fp32)."""
    dev = resolve_device(device)
    opt = state["opt"]
    return {"params": params_from_arrays(state["params"], dev),
            "opt": {"m": params_from_arrays(opt["m"], dev),
                    "v": params_from_arrays(opt["v"], dev),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=dev)}}
