"""The TAP kernels: CUDA for Hopper, with their plain PyTorch versions.

Two kernels, each behind one wrapper:

- :func:`tap_run_program` replays a whole compiled program (the six dense
  schedule tensors of :class:`repro_torch.apc.lower.CompiledProgram`) over
  row-blocks of int8 digits, with one (2 + 8) int32 counter row per
  ``block_rows`` block.  CUDA source ``csrc/tap_program.cu``.
- :func:`tap_apply_schedule` applies a short static schedule (a tuple of
  ``(keys, compare_cols, write_cols, write_vals)`` steps), no counters and
  no row mask.  CUDA source ``csrc/tap_schedule.cu``; it stages the whole
  schedule in shared memory.

A wrapper given a tensor on the CPU runs the plain version from
:mod:`.ref`; given a CUDA tensor it launches its kernel, or raises.
``launch_counts`` counts kernel launches per wrapper (plain runs do not
count).

Build: at first use each source is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface under ``build/repro_torch/`` at the
root of the checkout (named by a hash of the sources and flags, so a stale
build is never loaded), then loaded with ``ctypes``.  :func:`build` compiles
several at once, one ``nvcc`` process per source.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from .ref import HIST_BINS, Step, apply_schedule, run_program_plain

BLOCK_ROWS = 1024

MAX_PACK = 32                    # slot tags of a group live in one uint32
MAX_SMEM_BYTES = 232448          # dynamic shared memory a Hopper CTA may use
MAX_THREADS = 256

launch_counts = {"tap_run_program": 0, "tap_apply_schedule": 0}

_CSRC = Path(__file__).resolve().with_name("csrc")
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
_SOURCES = {"tap_program": "tap_program.cu",
            "tap_schedule": "tap_schedule.cu"}
_HEADERS = ("tap_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "tap_program": ("tap_run_program_launch",
                    [_VP, _VP, _LL, _I, _I, _LL, _VP, _VP, _VP, _VP, _VP,
                     _VP, _I, _I, _I, _I, _I, _VP, _I, _VP]),
    "tap_schedule": ("tap_apply_schedule_launch",
                     [_VP, _VP, _LL, _I, _VP, _VP, _VP, _VP, _VP, _I, _I,
                      _I, _I, _I, _I, _VP]),
}
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}   # nvcc's output (ptxas -v) per library


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (_SOURCES[name],) + _HEADERS:
        h.update((_CSRC / fname).read_bytes())
    return _BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: nvcc is needed to build "
                           "the TAP kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(names=tuple(_SOURCES)) -> dict[str, Path]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the library paths."""
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(_CSRC / _SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            build_logs[n] = log
            if proc.returncode:
                failed.append(f"{n}: nvcc exit {proc.returncode}\n{log}")
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("TAP kernel build failed:\n" +
                               "\n".join(failed))
    return paths


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _threads(cols: int, rows_per_cta: int, extra_smem: int = 0) -> int:
    """Threads per CTA (one per row): at most MAX_THREADS, fewer when the
    CTA has fewer rows, halved until the row tile fits in shared memory."""
    t = MAX_THREADS
    while t > 32 and (t // 2 >= rows_per_cta
                      or extra_smem + cols * t > MAX_SMEM_BYTES):
        t //= 2
    if extra_smem + cols * t > MAX_SMEM_BYTES:
        raise ValueError(f"{cols} columns do not fit a {t}-row tile in "
                         f"{MAX_SMEM_BYTES} bytes of shared memory")
    return t


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


def _check_status(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


# ---------------------------------------------------------------------------
# Program kernel
# ---------------------------------------------------------------------------

def tap_run_program(arr: torch.Tensor, cmp_cols, keys, key_valid, hist_flag,
                    wr_cols, wr_vals, n_valid_rows: int, *,
                    block_rows: int = BLOCK_ROWS,
                    collect_stats: bool = False, pack: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Run a whole program over ``arr`` [rows, cols] int8, rows a multiple
    of ``block_rows``.

    Returns the new digits and, with ``collect_stats``, a (rows /
    block_rows, 2 + 8) int32 counter tensor [sets, resets, hist[0..8)].
    Rows at or past ``n_valid_rows`` are padding: no writes, no counts.
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
                                 collect_stats=collect_stats, pack=pack)
    return _launch_program(arr, sched, int(n_valid_rows), block_rows,
                           collect_stats, pack)


def _launch_program(arr, sched, n_valid, block_rows, collect_stats, pack):
    _check_cuda_digits(arr, "tap_run_program")
    rows, cols = arr.shape
    if rows % block_rows:
        raise ValueError(f"rows={rows} not a multiple of {block_rows}")
    if pack > MAX_PACK:
        raise ValueError(f"pack={pack} exceeds {MAX_PACK}")
    dev = arr.device
    cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals = (
        program_tensors_on(sched, dev))
    n_slots, C = cmp_cols.shape
    K = keys.shape[1]
    W = wr_cols.shape[1]
    if n_slots % pack:
        raise ValueError(f"{n_slots} schedule slots not a multiple of "
                         f"pack={pack}")
    if (keys.shape != (n_slots, K, C) or key_valid.shape != (n_slots, K)
            or hist_flag.shape != (n_slots,)
            or wr_vals.shape != (n_slots, W)):
        raise ValueError("schedule tensors disagree on their shapes")
    arr = arr.contiguous()
    out = torch.empty_like(arr)
    n_blocks = rows // block_rows
    counts = (torch.zeros((n_blocks, 2 + HIST_BINS), dtype=torch.int32,
                          device=dev) if collect_stats else None)
    if rows == 0:
        return out, counts
    threads = _threads(cols, block_rows)
    if -(-block_rows // threads) > 65535:
        raise ValueError(f"block_rows={block_rows} needs more than 65535 "
                         f"CTAs per block")
    lib = _library("tap_program")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tap_run_program_launch(
            arr.data_ptr(), out.data_ptr(), rows, cols, block_rows, n_valid,
            cmp_cols.data_ptr(), keys.data_ptr(), key_valid.data_ptr(),
            hist_flag.data_ptr(), wr_cols.data_ptr(), wr_vals.data_ptr(),
            n_slots // pack, pack, K, C, W,
            counts.data_ptr() if collect_stats else None, threads, stream)
    _check_status(err, "tap_run_program")
    launch_counts["tap_run_program"] += 1
    return out, counts


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


@functools.lru_cache(maxsize=64)
def _schedule_on(schedule: tuple[Step, ...], device: torch.device
                 ) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(t).to(device)
                 for t in schedule_tensors(schedule))


def _launch_schedule(arr, schedule):
    _check_cuda_digits(arr, "tap_apply_schedule")
    rows, cols = arr.shape
    if any(c >= cols for _, cc, wc, _ in schedule for c in (*cc, *wc)):
        raise ValueError(f"schedule touches a column >= {cols}")
    dev = arr.device
    cmp_cols, keys, key_valid, wr_cols, wr_vals = _schedule_on(schedule, dev)
    S, K, C = keys.shape
    W = wr_cols.shape[1]
    sched_bytes = -(-sum(t.numel() * t.element_size() for t in (
        cmp_cols, keys, key_valid, wr_cols, wr_vals)) // 16) * 16
    arr = arr.contiguous()
    out = torch.empty_like(arr)
    if rows == 0:
        return out
    threads = _threads(cols, rows, sched_bytes)
    lib = _library("tap_schedule")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tap_apply_schedule_launch(
            arr.data_ptr(), out.data_ptr(), rows, cols, cmp_cols.data_ptr(),
            keys.data_ptr(), key_valid.data_ptr(), wr_cols.data_ptr(),
            wr_vals.data_ptr(), S, K, C, W, sched_bytes, threads, stream)
    _check_status(err, "tap_apply_schedule")
    launch_counts["tap_apply_schedule"] += 1
    return out
