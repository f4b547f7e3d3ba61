"""Plain PyTorch versions of the TAP kernels: the oracles the CUDA kernels
are held against, and what the wrappers run for tensors on the CPU.

A *schedule* is the flattened, hardware-agnostic form of one or more LUT
applications: a tuple of steps, each step being

    (keys, compare_cols, write_cols, write_vals)   # one block

where the compare is the OR over the keys of the AND over (cols, key)
pairs — i.e. a blocked LUT step carries several keys sharing one write
action.  Don't-care stored digits (-1) match any key digit.

:func:`apply_schedule` replays such a tuple (the plain version of the
schedule kernel); :func:`run_program_plain` replays the six dense schedule
tensors of a compiled program with per-block counters (the plain version of
the program kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.lut import LUT

DONT_CARE = -1
HIST_BINS = 8                     # mismatch-histogram bins, top bin saturates

# step = (keys, compare_cols, write_cols, write_vals)
Step = tuple[tuple[tuple[int, ...], ...], tuple[int, ...],
             tuple[int, ...], tuple[int, ...]]


def schedule_from_lut(lut: LUT, col_map: tuple[int, ...]) -> tuple[Step, ...]:
    """Flatten one LUT application into kernel steps (one per block)."""
    steps = []
    for blk in lut.blocks:
        ccols = tuple(col_map[i] for i in range(lut.width))
        keys = tuple(tuple(k) for k in blk.keys)
        wcols = tuple(col_map[c] for c in blk.write_cols)
        steps.append((keys, ccols, wcols, tuple(blk.write_vals)))
    return tuple(steps)


def ripple_add_schedule(lut: LUT, width: int, carry_col: int,
                        a_base: int = 0, b_base: int | None = None
                        ) -> tuple[Step, ...]:
    """Full p-digit in-place add as a single fused schedule.

    Includes the initial carry-zeroing write (empty key set = unconditional).
    """
    b_base = width if b_base is None else b_base
    steps: list[Step] = [((), (), (carry_col,), (0,))]
    for i in range(width):
        steps.extend(schedule_from_lut(
            lut, (a_base + i, b_base + i, carry_col)))
    return tuple(steps)


def apply_schedule(arr: torch.Tensor, schedule: tuple[Step, ...]
                   ) -> torch.Tensor:
    """Reference replay of a schedule on [rows, cols] int8 digits."""
    for keys, ccols, wcols, wvals in schedule:
        if not keys:                                  # unconditional write
            tag = torch.ones(arr.shape[0], dtype=torch.bool,
                             device=arr.device)
        else:
            tag = torch.zeros(arr.shape[0], dtype=torch.bool,
                              device=arr.device)
            for key in keys:
                m = torch.ones(arr.shape[0], dtype=torch.bool,
                               device=arr.device)
                for c, k in zip(ccols, key):
                    cell = arr[:, c]
                    m &= (cell == k) | (cell == DONT_CARE)
                tag |= m
        new = arr.clone()
        for c, v in zip(wcols, wvals):
            new[:, c] = arr[:, c].masked_fill(tag, v)
        arr = new
    return arr


def run_program_plain(arr: torch.Tensor, cmp_cols: torch.Tensor,
                      keys: torch.Tensor, key_valid: torch.Tensor,
                      hist_flag: torch.Tensor, wr_cols: torch.Tensor,
                      wr_vals: torch.Tensor, n_valid_rows: int, *,
                      block_rows: int, collect_stats: bool = False,
                      pack: int = 1, block_valid=None
                      ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Replay dense schedule tensors on [rows, cols] int8 digits.

    Slots run in groups of ``pack``: every slot of a group takes its tag
    against the pre-group array, then the slots' writes land in order
    (``pack == 1`` is the flat serial schedule: duplicate write columns
    apply one after another and each change is charged).  Rows at or past
    ``n_valid_rows`` get no writes and no counts; with ``block_valid``
    (rows / block_rows counts, a sequence or a tensor) it is rows of block
    ``b`` at or past ``block_valid[b]`` within it instead, and
    ``n_valid_rows`` is not read.  Returns the new digits
    and, with ``collect_stats``, one int32 counter row per ``block_rows``
    block laid out [sets, resets, hist[0..HIST_BINS)], the top bin
    saturating at ``HIST_BINS - 1`` mismatches.  CPU tensors replay in
    NumPy, tensors on another device in PyTorch ops there (the plain
    version the program kernel is held against on the card).
    """
    rows = arr.shape[0]
    if rows % block_rows:
        raise ValueError(f"rows={rows} not a multiple of {block_rows}")
    n_slots = cmp_cols.shape[0]
    if n_slots % pack:
        raise ValueError(f"{n_slots} schedule slots not a multiple of "
                         f"pack={pack}")
    if block_valid is not None:
        bv = torch.as_tensor(block_valid).to(dtype=torch.int64)
        if tuple(bv.shape) != (rows // block_rows,):
            raise ValueError(f"block_valid has {bv.numel()} counts for "
                             f"{rows // block_rows} blocks")
    if arr.device.type == "cpu":
        return _run_program_numpy(
            arr, cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals,
            n_valid_rows, block_rows=block_rows,
            collect_stats=collect_stats, pack=pack, block_valid=block_valid)
    return _run_program_torch(
        arr, cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals,
        n_valid_rows, block_rows=block_rows, collect_stats=collect_stats,
        pack=pack, block_valid=block_valid)


def _row_ok_numpy(rows: int, n_valid_rows: int, block_rows: int,
                  block_valid) -> np.ndarray:
    if block_valid is None:
        return np.arange(rows) < n_valid_rows
    bv = torch.as_tensor(block_valid).cpu().numpy().astype(np.int64)
    return (np.arange(block_rows)[None, :] < bv[:, None]).reshape(rows)


def _run_program_numpy(arr, cmp_cols, keys, key_valid, hist_flag, wr_cols,
                       wr_vals, n_valid_rows: int, *, block_rows: int,
                       collect_stats: bool, pack: int, block_valid
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`run_program_plain` for a CPU tensor, in NumPy: the same
    slots, tags, writes and counters, with less per-operation overhead
    (a slot is a few operations on short row vectors).  Counters are
    summed per block as they are counted."""
    rows = arr.shape[0]
    n_blocks = rows // block_rows
    host = [torch.as_tensor(t).cpu().numpy()
            for t in (cmp_cols, keys, key_valid, hist_flag, wr_cols,
                      wr_vals)]
    cc, ks, kv, hf, wc, wv = host
    kv, hf = kv.astype(bool), hf.astype(bool)
    out = arr.numpy().copy()
    row_ok = _row_ok_numpy(rows, n_valid_rows, block_rows, block_valid)
    block_of = np.arange(rows) // block_rows
    sets = np.zeros(rows, np.int64)
    resets = np.zeros(rows, np.int64)
    hist = np.zeros(n_blocks * HIST_BINS, np.int64)
    # per slot, once: the valid compare columns and the valid keys on them
    slots = []
    for s in range(cc.shape[0]):
        cmask = cc[s] >= 0
        cols = cc[s][cmask]
        slots.append((kv[s].any(), cols, ks[s][kv[s]][:, cmask],
                      collect_stats and hf[s],
                      [(int(c), int(v)) for c, v in zip(wc[s], wv[s])
                       if c >= 0]))
    hist_base = (block_of * HIST_BINS)[row_ok]
    for g in range(len(slots) // pack):
        group = slots[g * pack:(g + 1) * pack]
        tags = []
        for any_key, cols, kk, count, _ in group:
            if not any_key:                                # unconditional
                tags.append(row_ok)
                continue
            sub = out[:, cols]                             # (rows, C)
            if len(kk) == 1 and not count:
                hit = ((sub == kk[0]) | (sub == DONT_CARE)).all(axis=1)
                tags.append(hit & row_ok)
                continue
            sub = sub[:, None, :]
            miss = (sub != kk[None]) & (sub != DONT_CARE)
            mm = miss.sum(axis=2)                          # (rows, K)
            tags.append((mm == 0).any(axis=1) & row_ok)
            if count:
                bins = np.minimum(mm[row_ok], HIST_BINS - 1)
                hist += np.bincount(
                    (hist_base[:, None] + bins).ravel(),
                    minlength=n_blocks * HIST_BINS)
        for tag, (_, _, _, _, writes) in zip(tags, group):
            for col, v in writes:
                old = out[:, col]                          # a view
                changed = tag & (old != v)
                if collect_stats:
                    sets += changed
                    resets += changed & (old != DONT_CARE)
                np.copyto(old, v, where=changed)
    res = torch.from_numpy(out)
    if not collect_stats:
        return res, None
    counts = np.concatenate([
        sets.reshape(n_blocks, block_rows).sum(axis=1)[:, None],
        resets.reshape(n_blocks, block_rows).sum(axis=1)[:, None],
        hist.reshape(n_blocks, HIST_BINS)], axis=1)
    return res, torch.from_numpy(counts.astype(np.int32))


def _run_program_torch(arr, cmp_cols, keys, key_valid, hist_flag, wr_cols,
                       wr_vals, n_valid_rows: int, *, block_rows: int,
                       collect_stats: bool, pack: int, block_valid
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`run_program_plain` in PyTorch ops on the tensors' device."""
    rows = arr.shape[0]
    n_slots = cmp_cols.shape[0]
    dev = arr.device
    cmp_cols, keys, key_valid, wr_cols, wr_vals = (
        torch.as_tensor(t).to(dev) for t in (cmp_cols, keys, key_valid,
                                             wr_cols, wr_vals))
    key_valid = key_valid.to(torch.bool)
    # host copies drive the per-slot control flow; device copies the math
    kv_host = key_valid.cpu().tolist()
    hf_host = torch.as_tensor(hist_flag).to(torch.bool).cpu().tolist()
    wc_host = wr_cols.cpu().tolist()
    wv_host = wr_vals.cpu().tolist()
    c_ok = cmp_cols >= 0                                   # (S, C)
    c_idx = cmp_cols.clamp(min=0).long()
    out = arr.clone()
    if block_valid is None:
        row_ok = torch.arange(rows, device=dev) < n_valid_rows
    else:
        bv = torch.as_tensor(block_valid).to(device=dev, dtype=torch.int64)
        local = torch.arange(block_rows, device=dev)
        row_ok = (local[None, :] < bv[:, None]).reshape(rows)
    per_row = (torch.zeros((rows, 2 + HIST_BINS), dtype=torch.int32,
                           device=dev) if collect_stats else None)
    for g in range(n_slots // pack):
        tags = []
        for s in range(g * pack, (g + 1) * pack):
            if not any(kv_host[s]):                        # unconditional
                tags.append(row_ok)
                continue
            sub = out[:, c_idx[s]]                         # (rows, C)
            miss = ((sub[:, None, :] != keys[s][None]) &
                    (sub[:, None, :] != DONT_CARE) & c_ok[s][None, None, :])
            mm = miss.sum(dim=2, dtype=torch.int32)        # (rows, K)
            tags.append(((mm == 0) & key_valid[s][None]).any(dim=1) & row_ok)
            if collect_stats and hf_host[s]:
                counted = key_valid[s][None] & row_ok[:, None]
                bins = mm.clamp(max=HIST_BINS - 1).long() + 2
                per_row.scatter_add_(1, bins, counted.to(torch.int32))
        for p, s in enumerate(range(g * pack, (g + 1) * pack)):
            for col, v in zip(wc_host[s], wv_host[s]):
                if col < 0:
                    continue
                old = out[:, col]
                changed = tags[p] & (old != v)
                if collect_stats:
                    per_row[:, 0] += changed
                    per_row[:, 1] += changed & (old != DONT_CARE)
                out[:, col] = old.masked_fill(changed, v)
    if not collect_stats:
        return out, None
    counts = per_row.view(rows // block_rows, block_rows, 2 + HIST_BINS)
    return out, counts.sum(dim=1, dtype=torch.int64).to(torch.int32)
