#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout with one card: ``python3 chip_smoke.py``.

1. Setup: build the CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, in parallel), print versions and the card.
2. Every kernel against its plain PyTorch version on the card, on the same
   inputs: digits and every per-block counter row equal (tolerance: none,
   integer results must match exactly, max_abs_err 0), over the program
   matrix below.
3. The main path at full size, with every kernel's launch count set to 0
   before and read after: ``compile_named("add", 3, 20)`` + ``run`` at 2^20
   rows against numpy, ``multiply`` and ``ripple_sub`` through
   ``engine="apc"`` against numpy, ``APStats`` of
   ``engine="apc"`` equal to ``engine="replay"``, ``tap_apply_lut`` /
   ``tap_ripple_add``, and Table XI (all six width pairs, each against
   ``engine="replay"`` on the same digits, digits and ``APStats`` equal)
   priced by the energy model.
4. Times: CUDA-event medians of each kernel and its plain version at the
   benchmark shapes, beside each kernel's bound.

Prints the kernels line (one JSON object) and the card's ``nvidia-smi``
name and power limit before the last line, which is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
that line.  ``--json PATH`` also writes every measurement to ``PATH``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
FULL_ROWS = 1 << 20                  # the main path's row count
STATS_ROWS = 65536                   # APStats parity and Table XI rows
CHECK_ROWS = (333, 65536, FULL_ROWS)
TIMING_ROWS = (4096, 65536, FULL_ROWS)
TIMING_PROGRAMS = (("add", 3, 20), ("mul", 3, 5), ("max", 3, 8))
VARIANTS = ("gather", "onehot", "onehot_packed")
PAPER_TABLE_XI = {"energy": 12.25, "setreset": 12.6, "area": 6.2}

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): device memory
# 3.35 TB/s; INT32 issue 64 lanes per SM x 132 SMs x 1.98 GHz boost clock
# (the clock behind the 67 TFLOP/s fp32 figure)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9

KERNELS = {
    "tap_run_program": {
        "source": "src/repro_torch/kernels/tap_pass/csrc/tap_program.cu",
        "replaces": "src/repro/kernels/tap_pass/kernel.py:373"},
    "tap_apply_schedule": {
        "source": "src/repro_torch/kernels/tap_pass/csrc/tap_schedule.cu",
        "replaces": "src/repro/kernels/tap_pass/kernel.py:396"},
}


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def named_operands(fn: str, radix: int, width: int, rows: int, rng):
    """Random operands and their digit rows in ``compile_named``'s layout."""
    a = rng.integers(0, radix ** width, rows)
    b = rng.integers(0, radix ** width, rows)
    if fn == "mul":
        arr = np.zeros((rows, 5 * width + 1), np.int8)
        for i in range(width):
            arr[:, i] = arr[:, width + i] = (a // radix ** i) % radix
            arr[:, 2 * width + i] = (b // radix ** i) % radix
        return a, b, arr
    from repro_torch.core import ap
    extra = 0 if fn in ("min", "max", "modsum", "nor", "nand") else 1
    return a, b, ap.encode_operands(a, b, radix, width, extra_cols=extra)


def raw_digits(rows: int, cols: int, radix: int, rng) -> np.ndarray:
    """Any digit a cell can hold: don't-care (-1), 0..radix-1, and radix
    (the fault model's stuck-between-levels value)."""
    return rng.integers(-1, radix + 1, (rows, cols)).astype(np.int8)


def check_programs():
    from repro_torch import apc
    dup = apc.compile_program((
        apc.CompareWrite(compare_cols=(0,), key=(1,), write_cols=(2, 2),
                         write_vals=(1, 2)),
        apc.CompareWrite(compare_cols=(1, 1), key=(0, 0), write_cols=(3,),
                         write_vals=(2,))))
    return [("add3x20", 3, apc.compile_named("add", 3, 20)),
            ("add3x20_blocked", 3,
             apc.compile_named("add", 3, 20, blocked=True)),
            ("mul3x5", 3, apc.compile_named("mul", 3, 5)),
            ("max3x8", 3, apc.compile_named("max", 3, 8)),
            ("sub5x8_blocked", 5,
             apc.compile_named("sub", 5, 8, blocked=True)),
            ("dup_write_cols", 3, dup),
            # the widest Table XI adds: 257 and 161 columns, so the row
            # tile takes more than 48 KB of shared memory
            ("add2x128", 2, apc.compile_named("add", 2, 128)),
            ("add3x80", 3, apc.compile_named("add", 3, 80))]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels_vs_plain(dev, log) -> dict[str, int]:
    import torch
    from repro_torch.apc.exec import BLOCK_ROWS, device_schedule
    from repro_torch.core import build_lut_blocked, build_lut_nonblocked
    from repro_torch.core import truth_tables as tt
    from repro_torch.kernels.tap_pass import kernel, ref
    from repro_torch.kernels.tap_pass.ops import _pad_rows

    rng = np.random.default_rng(SEED)
    err = {"tap_run_program": 0, "tap_apply_schedule": 0}
    for name, radix, compiled in check_programs():
        for rows in CHECK_ROWS:
            arr = torch.from_numpy(
                raw_digits(rows, compiled.min_cols + 1, radix, rng)).to(dev)
            block_rows = min(BLOCK_ROWS, max(8, rows))
            padded, _ = _pad_rows(arr, block_rows)
            plain = {}
            for kv in VARIANTS:
                sched, variant, pack = device_schedule(compiled, kv, dev)
                for stats in (True, False):
                    out, counts = kernel.tap_run_program(
                        padded, *sched, rows, block_rows=block_rows,
                        collect_stats=stats, pack=pack)
                    key = (pack, stats)
                    if key not in plain:       # flat variants share one
                        plain[key] = ref.run_program_plain(
                            padded, *sched, rows, block_rows=block_rows,
                            collect_stats=stats, pack=pack)
                    want, want_counts = plain[key]
                    e = int((out.int() - want.int()).abs().max())
                    if stats:
                        e = max(e, int((counts.long() -
                                        want_counts.long()).abs().max()))
                    err["tap_run_program"] = max(err["tap_run_program"], e)
                    log(f"  tap_run_program {name} rows={rows} "
                        f"variant={kv}->{variant}/pack{pack} stats={stats} "
                        f"max_abs_err={e}")
                    check(e == 0, f"tap_run_program {name} rows={rows} "
                                  f"{kv} stats={stats} disagrees")
    lut_b = build_lut_blocked(tt.full_adder(3))
    lut_n = build_lut_nonblocked(tt.full_adder(3))
    cases = [("blocked_full_adder", ref.schedule_from_lut(lut_b, (0, 1, 2)),
              3),
             ("ripple_add_w3", ref.ripple_add_schedule(lut_n, 3, 6), 7)]
    for name, sched, cols in cases:
        arr = torch.from_numpy(raw_digits(FULL_ROWS, cols, 3, rng)).to(dev)
        out = kernel.tap_apply_schedule(arr, sched)
        want = ref.apply_schedule(arr, sched)
        e = int((out.int() - want.int()).abs().max())
        err["tap_apply_schedule"] = max(err["tap_apply_schedule"], e)
        log(f"  tap_apply_schedule {name} rows={FULL_ROWS} steps="
            f"{len(sched)} max_abs_err={e}")
        check(e == 0, f"tap_apply_schedule {name} disagrees")
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def ripple_oracle(a_d: np.ndarray, b_d: np.ndarray, radix: int):
    """numpy ripple-carry add of little-endian digit matrices."""
    carry = np.zeros(a_d.shape[0], np.int32)
    out = np.zeros_like(a_d)
    for i in range(a_d.shape[1]):
        s = a_d[:, i].astype(np.int32) + b_d[:, i] + carry
        out[:, i] = (s % radix).astype(np.int8)
        carry = s // radix
    return out, carry


def stats_fields(s) -> tuple:
    return (s.radix, s.n_rows, s.n_compare_cycles, s.n_write_cycles,
            s.sets, s.resets, tuple(int(h) for h in s.mismatch_hist))


def phase_main_path(dev, log) -> dict:
    import torch
    from repro_torch import apc
    from repro_torch.core import ap, build_lut_blocked, build_lut_nonblocked
    from repro_torch.core import truth_tables as tt
    from repro_torch.core.circuit import CellParams
    from repro_torch.core.energy import (EQUIV_WIDTHS, energy_from_stats,
                                         row_area_units)
    from repro_torch.kernels.tap_pass import tap_apply_lut, tap_ripple_add

    rng = np.random.default_rng(SEED + 1)
    res = {}

    # the paper's headline: 20-trit in-place add at 2^20 rows
    r, w = 3, 20
    a, b, arr = named_operands("add", r, w, FULL_ROWS, rng)
    compiled = apc.compile_named("add", r, w)
    stats = ap.APStats(radix=r)
    t0 = time.perf_counter()
    out = apc.run(arr, compiled, stats=stats)
    torch.cuda.synchronize()
    res["add3x20_run_ms"] = (time.perf_counter() - t0) * 1e3
    out = out.cpu().numpy()
    got = ap.decode_digits(out, list(range(w, 2 * w)), r)
    check(np.array_equal(got, (a + b) % r ** w), "add 3x20 digits wrong")
    check(np.array_equal(out[:, 2 * w], (a + b) // r ** w),
          "add 3x20 carry wrong")
    log(f"  add 3x20 rows={FULL_ROWS} bit-exact vs numpy, "
        f"run {res['add3x20_run_ms']:.3f} ms (host clock, first call), "
        f"sets={stats.sets}")

    # multiply and subtract through engine="apc"
    lut_add = build_lut_nonblocked(tt.full_adder(r))
    lut_half = build_lut_nonblocked(tt.half_adder(r))
    mw = 5
    a, b, arr = named_operands("mul", r, mw, FULL_ROWS, rng)
    out = ap.multiply(arr, lut_add, lut_half, mw, r, 0, mw, 2 * mw, 3 * mw,
                      5 * mw, engine="apc")
    got = ap.decode_digits(out, list(range(3 * mw, 5 * mw)), r)
    check(np.array_equal(got, a * b), "multiply 3x5 wrong")
    log(f"  multiply 3x5 rows={FULL_ROWS} engine=apc bit-exact vs numpy")
    lut_sub = build_lut_nonblocked(tt.full_subtractor(r))
    a, b, arr = named_operands("sub", r, w, FULL_ROWS, rng)
    out = ap.ripple_sub(arr, lut_sub, w, 2 * w, engine="apc")
    got = ap.decode_digits(out, list(range(w, 2 * w)), r)
    check(np.array_equal(got, (a - b) % r ** w), "ripple_sub 3x20 wrong")
    log(f"  ripple_sub 3x20 rows={FULL_ROWS} engine=apc bit-exact vs numpy")

    # APStats: engine="apc" equal to engine="replay" on the card
    for name, run_both in (
            ("add3x20", lambda arr, s, e: ap.ripple_add(
                arr, lut_add, w, 2 * w, stats=s, engine=e)),
            ("mul3x5", lambda arr, s, e: ap.multiply(
                arr, lut_add, lut_half, mw, r, 0, mw, 2 * mw, 3 * mw,
                5 * mw, stats=s, engine=e))):
        fn, width = ("mul", mw) if name == "mul3x5" else ("add", w)
        _, _, arr = named_operands(fn, r, width, STATS_ROWS, rng)
        s_rep, s_apc = ap.APStats(radix=r), ap.APStats(radix=r)
        o_rep = run_both(arr, s_rep, "replay")
        o_apc = run_both(arr, s_apc, "apc")
        check(torch.equal(o_rep, o_apc), f"{name} apc digits != replay")
        check(stats_fields(s_rep) == stats_fields(s_apc),
              f"{name} APStats apc {s_apc} != replay {s_rep}")
        log(f"  {name} rows={STATS_ROWS} APStats apc == replay: "
            f"{stats_fields(s_apc)}")

    # the short-schedule entry points
    lut_b = build_lut_blocked(tt.full_adder(r))
    digits = rng.integers(0, r, (FULL_ROWS, 3)).astype(np.int8)
    out = tap_apply_lut(digits, lut_b, (0, 1, 2))
    want = ap.apply_lut_pure(torch.from_numpy(digits).to(dev), lut_b,
                             (0, 1, 2))
    check(torch.equal(out, want), "tap_apply_lut != apply_lut_pure")
    a, b, arr = named_operands("add", r, 3, FULL_ROWS, rng)
    out = tap_ripple_add(arr, lut_add, 3, 6).cpu().numpy()
    got = ap.decode_digits(out, [3, 4, 5], r)
    check(np.array_equal(got, (a + b) % r ** 3), "tap_ripple_add wrong")
    log(f"  tap_apply_lut / tap_ripple_add w3 rows={FULL_ROWS} bit-exact")

    # Table XI: ternary vs binary AP adders, engine="apc"
    rows = []
    for p_t, q_b in EQUIV_WIDTHS.items():
        row = {"pair": f"{q_b}b/{p_t}t"}
        for radix, width, tag in ((3, p_t, "t"), (2, q_b, "b")):
            lut = build_lut_nonblocked(tt.full_adder(radix))
            a_d = rng.integers(0, radix, (STATS_ROWS, width)).astype(np.int8)
            b_d = rng.integers(0, radix, (STATS_ROWS, width)).astype(np.int8)
            arr = np.concatenate(
                [a_d, b_d, np.zeros((STATS_ROWS, 1), np.int8)], axis=1)
            st, st_rep = ap.APStats(radix=radix), ap.APStats(radix=radix)
            out = ap.ripple_add(arr, lut, width, 2 * width, stats=st,
                                engine="apc")
            out_rep = ap.ripple_add(arr, lut, width, 2 * width,
                                    stats=st_rep, engine="replay")
            check(torch.equal(out, out_rep),
                  f"Table XI r{radix} w{width} apc digits != replay")
            check(stats_fields(st) == stats_fields(st_rep),
                  f"Table XI r{radix} w{width} APStats apc {st} != "
                  f"replay {st_rep}")
            out = out.cpu().numpy()
            want, carry = ripple_oracle(a_d, b_d, radix)
            check(np.array_equal(out[:, width:2 * width], want)
                  and np.array_equal(out[:, 2 * width], carry),
                  f"Table XI r{radix} w{width} add wrong")
            rep = energy_from_stats(st, n_masked=3,
                                    params=CellParams(radix=radix))
            row[f"sets_{tag}"] = st.sets / STATS_ROWS
            row[f"total_nJ_{tag}"] = rep.total_j / STATS_ROWS * 1e9
            row[f"area_{tag}"] = row_area_units(width, radix)
        rows.append(row)
        log(f"  table_xi {row['pair']}: digits and APStats apc == replay; "
            f"sets/row b={row['sets_b']:.4f} "
            f"t={row['sets_t']:.4f}, nJ/row b={row['total_nJ_b']:.4f} "
            f"t={row['total_nJ_t']:.4f}, area b={row['area_b']:.2f} "
            f"t={row['area_t']:.2f}")

    def mean_red(key):
        return float(np.mean([(x[f"{key}_b"] - x[f"{key}_t"]) / x[f"{key}_b"]
                              for x in rows]) * 100)
    derived = {"energy": mean_red("total_nJ"), "setreset": mean_red("sets"),
               "area": mean_red("area")}
    log(f"  table_xi reductions (ternary vs binary, %): energy "
        f"{derived['energy']:.4f} set/reset {derived['setreset']:.4f} area "
        f"{derived['area']:.4f}; paper {PAPER_TABLE_XI['energy']} / "
        f"{PAPER_TABLE_XI['setreset']} / {PAPER_TABLE_XI['area']}")
    res["table_xi"] = {"rows": rows, "reductions_pct": derived,
                       "paper_pct": PAPER_TABLE_XI}
    return res


# ---------------------------------------------------------------------------
# Phase 4: times and bounds
# ---------------------------------------------------------------------------

def event_ms(fn, reps: int, inner: int) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call, after one warm-up call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def program_bound(sched, rows: int, cols: int, sets: int) -> dict:
    """Least time of one program launch with counters on: each digit read
    and written once (plus the schedule and counters), against every cell
    compare of every valid key (all feed the histogram) plus every cell the
    data changed (``sets``), at the INT32 issue rate."""
    cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals = sched
    n_bytes = 2 * rows * cols + sum(int(t.numel() * t.element_size())
                                    for t in sched)
    n_bytes += 4 * 10 * max(1, rows // 4096)
    per_row = int(((cmp_cols >= 0).sum(dim=1) *
                   key_valid.to(bool).sum(dim=1)).sum())
    ops = rows * per_row + sets
    return bound(n_bytes, ops)


def bound(n_bytes: int, ops: int) -> dict:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bytes": n_bytes, "int_ops": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_times(dev, card: str, log) -> list[dict]:
    import torch
    from repro_torch import apc
    from repro_torch.apc.exec import BLOCK_ROWS, device_schedule
    from repro_torch.core import build_lut_nonblocked
    from repro_torch.core import truth_tables as tt
    from repro_torch.kernels.tap_pass import kernel, ref
    from repro_torch.kernels.tap_pass.ops import _pad_rows

    rng = np.random.default_rng(SEED + 2)
    rows_out = []
    for fn, radix, width in TIMING_PROGRAMS:
        compiled = apc.compile_named(fn, radix, width)
        sched, variant, pack = device_schedule(compiled, None, dev)
        for rows in TIMING_ROWS:
            _, _, arr = named_operands(fn, radix, width, rows, rng)
            arr = torch.from_numpy(arr).to(dev)
            block_rows = min(BLOCK_ROWS, max(8, rows))
            padded, _ = _pad_rows(arr, block_rows)

            def run_kernel():
                return kernel.tap_run_program(
                    padded, *sched, rows, block_rows=block_rows,
                    collect_stats=True, pack=pack)

            def run_plain():
                return ref.run_program_plain(
                    padded, *sched, rows, block_rows=block_rows,
                    collect_stats=True, pack=pack)
            _, counts = run_kernel()
            sets = int(counts[:, 0].long().sum())
            ms = event_ms(run_kernel, reps=5, inner=20)
            plain_ms = event_ms(run_plain, reps=3 if rows < FULL_ROWS else 1,
                                inner=1)
            b = program_bound(sched, rows, padded.shape[1], sets)
            row = {"kernel": "tap_run_program", "program": f"{fn}{radix}x"
                   f"{width}", "steps": compiled.n_steps, "rows": rows,
                   "cols": padded.shape[1], "variant": variant, "pack": pack,
                   "collect_stats": True, "ms": ms, "plain_ms": plain_ms,
                   **b, "card": card}
            rows_out.append(row)
            log(f"  time tap_run_program {row['program']} rows={rows} "
                f"kernel {ms:.6f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b['bound_ms']:.6f} ms ({b['bound_by']}: bytes "
                f"{b['bytes_ms']:.6f} ms, int ops {b['ops_ms']:.6f} ms), "
                f"card {card}")
    lut = build_lut_nonblocked(tt.full_adder(3))
    sched = ref.ripple_add_schedule(lut, 3, 6)
    compiled = apc.lower._compile_steps(tuple(
        apc.Step(keys=k, compare_cols=c, write_cols=wc, write_vals=wv)
        for k, c, wc, wv in sched))
    for rows in TIMING_ROWS:
        _, _, arr = named_operands("add", 3, 3, rows, rng)
        arr = torch.from_numpy(arr).to(dev)
        ms = event_ms(lambda: kernel.tap_apply_schedule(arr, sched),
                      reps=5, inner=20)
        plain_ms = event_ms(lambda: ref.apply_schedule(arr, sched), reps=3,
                            inner=1)
        p_sched, _, _ = device_schedule(compiled, "gather", dev)
        _, counts = ref.run_program_plain(arr, *p_sched, rows,
                                          block_rows=rows,
                                          collect_stats=True)
        sets = int(counts[:, 0].long().sum())
        s_bytes = sum(t.nbytes for t in kernel.schedule_tensors(sched))
        per_row = sum(len(k) * len(c) for k, c, _, _ in sched)
        b = bound(2 * rows * 7 + s_bytes, rows * per_row + sets)
        row = {"kernel": "tap_apply_schedule", "program": "ripple_add3x3",
               "steps": len(sched), "rows": rows, "cols": 7, "ms": ms,
               "plain_ms": plain_ms, **b, "card": card}
        rows_out.append(row)
        log(f"  time tap_apply_schedule ripple_add3x3 rows={rows} kernel "
            f"{ms:.6f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b['bound_ms']:.6f} ms ({b['bound_by']}: bytes "
            f"{b['bytes_ms']:.6f} ms, int ops {b['ops_ms']:.6f} ms), "
            f"card {card}")
    return rows_out


# ---------------------------------------------------------------------------

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every measurement here")
    args = parser.parse_args()
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        from repro_torch.kernels.tap_pass import kernel
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    report: dict = {"card": card}

    def log(msg: str) -> None:
        print(msg, flush=True)

    t_start = time.perf_counter()
    try:
        log(f"[setup] python {sys.version.split()[0]} torch "
            f"{torch.__version__} cuda {torch.version.cuda} device "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        log(f"[setup] nvidia-smi: {card}")
        t0 = time.perf_counter()
        kernel.build()
        log(f"[setup] kernels built in {time.perf_counter() - t0:.3f} s")
        for name, text in kernel.build_logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[setup] {name}: {line.strip()}")

        log("[kernels vs plain]")
        max_err = phase_kernels_vs_plain(dev, log)

        log("[main path]")
        for k in kernel.launch_counts:
            kernel.launch_counts[k] = 0
        t0 = time.perf_counter()
        report["main_path"] = phase_main_path(dev, log)
        torch.cuda.synchronize()
        launches = dict(kernel.launch_counts)
        report["main_path"]["seconds"] = time.perf_counter() - t0
        log(f"  launches on the main path: {launches}")
        for k, n in launches.items():
            check(n > 0, f"{k} was not launched on the main path")

        log("[times]")
        report["times"] = phase_times(dev, card, log)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    kernels_line = []
    for name, meta in KERNELS.items():
        t = next(x for x in report["times"] if x["kernel"] == name
                 and x["rows"] == FULL_ROWS)
        kernels_line.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    report["kernels"] = kernels_line
    report["seconds"] = time.perf_counter() - t_start
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
