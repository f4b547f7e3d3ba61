"""The TAP kernels: CUDA for Hopper, with their plain PyTorch versions.

Two kernels, each behind one wrapper:

- :func:`tap_run_program` replays a whole compiled program (the six dense
  schedule tensors of :class:`repro_torch.apc.lower.CompiledProgram`) over
  row-blocks of int8 digits, with one (2 + 8) int32 counter row per
  ``block_rows`` block.  CUDA source ``csrc/tap_program.cu``: four rows per
  thread, the schedule as one slot record per step
  (:mod:`.records`, encoded once per program and column count), and
  unrolled instantiations for the programs of the main paths.
- :func:`tap_apply_schedule` applies a short static schedule (a tuple of
  ``(keys, compare_cols, write_cols, write_vals)`` steps), no counters and
  no row mask.  CUDA source ``csrc/tap_schedule.cu``: the program kernel's
  four-rows-per-thread slots without counters, the schedule encoded once
  into slot records (:func:`schedule_plan`, cached per schedule object,
  column count and device) and staged whole into shared memory.

A wrapper given a tensor on the CPU runs the plain version from
:mod:`.ref`; given a CUDA tensor it launches its kernel, or raises.
``launch_counts`` counts kernel launches per wrapper (plain runs do not
count).

Both build through :mod:`repro_torch.kernels.cuda_lib`: ``nvcc`` for
``sm_90a`` at first use, loaded with ``ctypes``.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_lib
from ..cuda_lib import I32 as _I, I64 as _LL, VP as _VP
from .records import (Layout, Records, build_records, choose_layout,
                      encode_records)
from .ref import HIST_BINS, Step, apply_schedule, run_program_plain

BLOCK_ROWS = 1024

MAX_PACK = 32                    # slot tags of a group live in one uint32
MAX_SMEM_BYTES = 232448          # dynamic shared memory a Hopper CTA may use
MAX_THREADS = 256
MIN_CTA_ROWS = 16                # program kernel: rows of the smallest CTA
MAX_CTA_ROWS = 4 * MAX_THREADS   # four rows per thread
MAX_SCHEDULE_PLANS = 64          # schedules whose records are kept

launch_counts = {"tap_run_program": 0, "tap_apply_schedule": 0}

_CSRC = Path(__file__).resolve().with_name("csrc")
_HEADERS = ("tap_common.cuh",)
cuda_lib.register(cuda_lib.CudaLibrary(
    "tap_program", _CSRC, "tap_program.cu", _HEADERS,
    "tap_run_program_launch",
    (_VP, _VP, _LL, _I, _I, _LL, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I,
     _I, _VP, _I, _I, _VP)))
cuda_lib.register(cuda_lib.CudaLibrary(
    "tap_schedule", _CSRC, "tap_schedule.cu", _HEADERS,
    "tap_apply_schedule_launch",
    (_VP, _VP, _LL, _I, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _VP)))


_PROGRAM_DTYPES = (torch.int32, torch.int8, torch.uint8, torch.uint8,
                   torch.int32, torch.int8)


def program_tensors_on(sched, device) -> tuple[torch.Tensor, ...]:
    """The six schedule tensors (numpy or torch) contiguous on ``device`` in
    the dtypes the program kernel reads (bool masks as uint8)."""
    out = []
    for t, dtype in zip(sched, _PROGRAM_DTYPES):
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        out.append(t.to(device=device, dtype=dtype).contiguous())
    return tuple(out)


def _check_columns(cmp_cols: np.ndarray, wr_cols: np.ndarray, cols: int
                   ) -> None:
    """Reject a host schedule that touches a column past ``cols``."""
    if cmp_cols.size and max(cmp_cols.max(), wr_cols.max()) >= cols:
        raise ValueError(f"schedule touches a column >= {cols}")


def _check_cuda_digits(arr: torch.Tensor, what: str) -> None:
    if not arr.is_cuda:
        raise ValueError(f"{what}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {arr.device}")
    if arr.dtype != torch.int8 or arr.dim() != 2:
        raise ValueError(f"{what}: digits must be a 2-D int8 tensor, got "
                         f"{arr.dtype} of shape {tuple(arr.shape)}")


# ---------------------------------------------------------------------------
# Program kernel
# ---------------------------------------------------------------------------

def tap_run_program(arr: torch.Tensor, cmp_cols, keys, key_valid, hist_flag,
                    wr_cols, wr_vals, n_valid_rows: int, *,
                    block_rows: int = BLOCK_ROWS,
                    collect_stats: bool = False, pack: int = 1,
                    block_valid: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Run a whole program over ``arr`` [rows, cols] int8, rows a multiple
    of ``block_rows``.

    Returns the new digits and, with ``collect_stats``, a (rows /
    block_rows, 2 + 8) int32 counter tensor [sets, resets, hist[0..8)].
    Rows at or past ``n_valid_rows`` are padding: no writes, no counts.
    ``block_valid`` (an int32 tensor of rows / block_rows counts on
    ``arr``'s device, or ``None``) marks a row-concatenated launch instead:
    rows of block ``b`` at or past ``block_valid[b]`` within it are the
    padding, and ``n_valid_rows`` is not read.
    ``pack`` is the schedule form
    (:func:`repro_torch.apc.lower.resolve_schedule`): 1 replays the flat
    schedule serially, ``pack`` > 1 replays group-major VLIW slots, every
    slot of a group compared against the pre-group row.  The schedule
    tensors may be numpy arrays, whose columns are checked against
    ``cols`` here, or tensors, whose columns the caller has checked
    (:func:`repro_torch.apc.exec.execute` checks ``min_cols``); the CUDA
    kernel skips a column outside ``[0, cols)`` as it skips -1 padding.
    """
    if pack < 1:
        raise ValueError(f"pack must be >= 1, got {pack}")
    sched = (cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals)
    if isinstance(cmp_cols, np.ndarray):
        _check_columns(cmp_cols, np.asarray(wr_cols), arr.shape[1])
    if arr.device.type == "cpu":
        return run_program_plain(arr, *sched, int(n_valid_rows),
                                 block_rows=block_rows,
                                 collect_stats=collect_stats, pack=pack,
                                 block_valid=block_valid)
    return _launch_program(arr, sched, int(n_valid_rows), block_rows,
                           collect_stats, pack, block_valid)


def _launch_program(arr, sched, n_valid, block_rows, collect_stats, pack,
                    block_valid=None):
    _check_cuda_digits(arr, "tap_run_program")
    rows, cols = arr.shape
    if rows % block_rows:
        raise ValueError(f"rows={rows} not a multiple of {block_rows}")
    if block_valid is not None and (
            block_valid.device != arr.device
            or block_valid.dtype != torch.int32
            or tuple(block_valid.shape) != (rows // block_rows,)
            or not block_valid.is_contiguous()):
        raise ValueError(
            f"block_valid must be a contiguous int32 tensor of "
            f"{rows // block_rows} counts on {arr.device}, got "
            f"{block_valid.dtype} of shape {tuple(block_valid.shape)} on "
            f"{block_valid.device}")
    if pack > MAX_PACK:
        raise ValueError(f"pack={pack} exceeds {MAX_PACK}")
    dev = arr.device
    cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals = sched
    n_slots, C = cmp_cols.shape
    K = keys.shape[1]
    W = wr_cols.shape[1]
    if n_slots % pack:
        raise ValueError(f"{n_slots} schedule slots not a multiple of "
                         f"pack={pack}")
    if (tuple(keys.shape) != (n_slots, K, C)
            or tuple(key_valid.shape) != (n_slots, K)
            or tuple(hist_flag.shape) != (n_slots,)
            or tuple(wr_vals.shape) != (n_slots, W)):
        raise ValueError("schedule tensors disagree on their shapes")
    arr = arr.contiguous()
    out = torch.empty_like(arr)
    n_blocks = rows // block_rows
    counts = (torch.zeros((n_blocks, 2 + HIST_BINS), dtype=torch.int32,
                          device=dev) if collect_stats else None)
    if rows == 0:
        return out, counts
    rec = program_records(sched, cols, pack, dev)
    lay = rec.layout
    cta_rows, threads = cta_shape(cols, block_rows, n_blocks,
                                  4 * (2 * rec.chunk_slots + 1) * lay.words,
                                  _sm_count(dev.index))
    if -(-block_rows // cta_rows) > 65535:
        raise ValueError(f"block_rows={block_rows} needs more than 65535 "
                         f"CTAs per block")
    launch = cuda_lib.entry("tap_program")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            arr.data_ptr(), out.data_ptr(), rows, cols, block_rows, n_valid,
            None if block_valid is None else block_valid.data_ptr(),
            rec.records.data_ptr(), rec.n_slots, lay.words, rec.chunk_slots,
            pack, rec.kind, lay.K, lay.C, lay.W, rec.n_hist_keys,
            counts.data_ptr() if collect_stats else None, cta_rows, threads,
            stream)
    cuda_lib.check_status(err, "tap_run_program")
    launch_counts["tap_run_program"] += 1
    return out, counts


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cta_shape(cols: int, block_rows: int, n_blocks: int, record_bytes: int,
              n_sm: int, min_rows: int = MIN_CTA_ROWS) -> tuple[int, int]:
    """Rows and threads of a CTA of either TAP kernel (four rows per
    thread).

    The most rows (a multiple of 4, at most :data:`MAX_CTA_ROWS` and the
    block) whose column-major tile, one dummy column included, fits in
    shared memory beside the ``record_bytes`` of staged records; halved
    while the grid gives fewer than two CTAs per SM, down to ``min_rows``.
    Threads: a whole number of warps covering the rows, at least four
    warps, which share the copies in and out."""
    # (cols + 1) columns of rows / 4 words, rounded up to an odd count
    fit = ((MAX_SMEM_BYTES - record_bytes) // (cols + 1) - 4) // 4 * 4
    rows = min(MAX_CTA_ROWS, fit, -(-block_rows // 4) * 4)
    if rows < 4:
        raise ValueError(f"{cols} columns do not fit a 4-row tile in "
                         f"{MAX_SMEM_BYTES} bytes of shared memory")
    while (rows > min_rows
           and n_blocks * -(-block_rows // rows) < 2 * n_sm):
        rows = max(min_rows, -(-rows // 8) * 4)
    return rows, max(128, -(-rows // 128) * 32)


# id of a live schedule tensor -> {(identities, versions, cols, pack,
# device): Records}; an entry goes when its tensor does
_records_on: dict[int, dict] = {}


def program_records(sched, cols: int, pack: int, device) -> Records:
    """The slot records of a schedule for a ``cols``-column tile, on
    ``device``.  Cached while the schedule's tensors live and are not
    modified in place (their ``_version``); numpy schedules are encoded
    at each call."""
    key = (tuple(id(t) for t in sched),
           tuple(getattr(t, "_version", None) for t in sched), cols, pack,
           str(device))
    per = {}
    if isinstance(sched[0], torch.Tensor):
        per = _records_on.get(id(sched[0]))
        if per is None:
            per = _records_on[id(sched[0])] = {}
            weakref.finalize(sched[0], _records_on.pop, id(sched[0]), None)
    hit = per.get(key)
    if hit is None:
        host = build_records(sched, cols, pack)
        hit = dataclasses.replace(
            host, records=torch.from_numpy(host.records).to(device))
        if len(per) >= 8:
            per.pop(next(iter(per)))
        per[key] = hit
    return hit


# ---------------------------------------------------------------------------
# Short-schedule kernel
# ---------------------------------------------------------------------------

def schedule_tensors(schedule: tuple[Step, ...]) -> tuple[np.ndarray, ...]:
    """Dense (cmp_cols, keys, key_valid, wr_cols, wr_vals) of a step tuple,
    -1-padded columns and masked pad keys as in the program kernel."""
    if not schedule:
        raise ValueError("empty schedule")
    S = len(schedule)
    K = max(1, max(len(k) for k, _, _, _ in schedule))
    C = max(1, max(len(c) for _, c, _, _ in schedule))
    W = max(1, max(len(w) for _, _, w, _ in schedule))
    cmp_cols = np.full((S, C), -1, np.int32)
    keys = np.zeros((S, K, C), np.int8)
    key_valid = np.zeros((S, K), np.uint8)
    wr_cols = np.full((S, W), -1, np.int32)
    wr_vals = np.zeros((S, W), np.int8)
    for s, (ks, cc, wc, wv) in enumerate(schedule):
        cmp_cols[s, :len(cc)] = cc
        for k, key in enumerate(ks):
            if len(key) != len(cc):
                raise ValueError(f"step {s}: key {key} does not cover the "
                                 f"compare columns {cc}")
            keys[s, k, :len(cc)] = key
            key_valid[s, k] = 1
        if len(wc) != len(wv):
            raise ValueError(f"step {s}: {len(wc)} write columns, "
                             f"{len(wv)} values")
        wr_cols[s, :len(wc)] = wc
        wr_vals[s, :len(wv)] = wv
    return cmp_cols, keys, key_valid, wr_cols, wr_vals


def tap_apply_schedule(arr: torch.Tensor, schedule: tuple[Step, ...],
                       block_rows: int = BLOCK_ROWS) -> torch.Tensor:
    """Apply a fused LUT schedule to ``arr`` [rows, cols] int8, rows a
    multiple of ``block_rows`` (pad with don't-care rows if needed)."""
    rows, cols = arr.shape
    if rows % block_rows:
        raise ValueError(f"rows={rows} not a multiple of {block_rows}")
    if arr.device.type == "cpu":
        return apply_schedule(arr, schedule)
    return _launch_schedule(arr, schedule)


class SchedulePlan(NamedTuple):
    """A short schedule encoded for one column count and device: its slot
    records (pack 1) and their kernel kind and layout."""
    records: torch.Tensor        # int32 [steps, layout.words]
    kind: int                    # records.KIND_*
    layout: Layout


def schedule_shape(cols: int, rows: int, n_slots: int, rec_words: int,
                   n_sm: int) -> tuple[int, int]:
    """Rows and threads of a schedule-kernel CTA: :func:`cta_shape` over
    the rows as one block, beside the whole schedule's records (and one
    more, read ahead), halved down to 4 rows while the grid gives fewer
    than two CTAs per SM."""
    return cta_shape(cols, rows, 1, 4 * (n_slots + 1) * rec_words, n_sm,
                     min_rows=4)


# id(schedule) -> (schedule, {(cols, device): SchedulePlan}); the entry
# holds the schedule itself, so its id is not reused while it is cached
_plans: dict[int, tuple[tuple, dict]] = {}


def schedule_plan(schedule: tuple[Step, ...], cols: int, device
                  ) -> SchedulePlan:
    """The slot records of a step tuple for a ``cols``-column array on
    ``device``, encoded at the first call for this schedule object and
    kept (for the last :data:`MAX_SCHEDULE_PLANS` schedules): a later call
    with the same object hashes nothing of it.  An equal schedule that is
    another object is encoded anew.  Raises ``ValueError`` if a step
    touches a column at or past ``cols``."""
    entry = _plans.get(id(schedule))
    if entry is None or entry[0] is not schedule:
        if len(_plans) >= MAX_SCHEDULE_PLANS:
            _plans.pop(next(iter(_plans)))
        entry = _plans[id(schedule)] = (schedule, {})
    plan = entry[1].get((cols, device))
    if plan is None:
        if any(c >= cols for _, cc, wc, _ in schedule for c in (*cc, *wc)):
            raise ValueError(f"schedule touches a column >= {cols}")
        cmp_cols, keys, key_valid, wr_cols, wr_vals = \
            schedule_tensors(schedule)
        sched = (cmp_cols, keys, key_valid, np.zeros(len(schedule), bool),
                 wr_cols, wr_vals)
        kind, layout = choose_layout(sched, 1)
        recs = torch.from_numpy(encode_records(sched, cols, layout))
        plan = entry[1][(cols, device)] = SchedulePlan(
            recs.to(device), kind, layout)
    return plan


def _launch_schedule(arr, schedule):
    _check_cuda_digits(arr, "tap_apply_schedule")
    rows, cols = arr.shape
    dev = arr.device
    plan = schedule_plan(schedule, cols, dev)
    arr = arr.contiguous()
    out = torch.empty_like(arr)
    if rows == 0:
        return out
    lay = plan.layout
    cta_rows, threads = schedule_shape(cols, rows, plan.records.shape[0],
                                       lay.words, _sm_count(dev.index))
    launch = cuda_lib.entry("tap_schedule")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            arr.data_ptr(), out.data_ptr(), rows, cols,
            plan.records.data_ptr(), plan.records.shape[0], lay.words,
            plan.kind, lay.K, lay.C, lay.W, cta_rows, threads, stream)
    cuda_lib.check_status(err, "tap_apply_schedule")
    launch_counts["tap_apply_schedule"] += 1
    return out
