"""Lowering: microcode IR -> one static flat Step schedule (+ packing).

``lower`` unrolls :class:`~repro_torch.apc.ir.ForDigit` loops, resolves affine
column expressions, and flattens every op into :class:`Step`s — the same
(keys, compare_cols) -> (write_cols, write_vals) shape the tap_pass kernel
replays, plus an ``in_hist`` flag so the traced stats reproduce the
functional simulator's counters exactly (repair compares are charged as
cycles but not histogrammed).

``pack`` turns a Step schedule into dense int tensors (keys / columns padded
to the schedule-wide maxima) so the executor can loop over steps
instead of unrolling hundreds of passes.

``pack_steps`` / :class:`PackedProgram` add a second, VLIW-style packing on
top: dependence-aware list scheduling groups mutually independent steps
(disjoint compare/write column interactions) into wide slots replayed in one
kernel step — digitwise programs pack ~width x, carry-ripple chains stay
serial (the dependence critical path is real).  :func:`resolve_schedule`
maps an executor-level ``kernel_variant`` (gather / onehot / onehot_packed)
onto schedule tensors + kernel statics, falling back whenever a program's
steps violate a formulation's preconditions.

``compile_program`` caches (lower + pack) per program identity;
``compile_named`` caches whole (fn, radix, width) programs — e.g. the 20-trit
adder schedule is built exactly once per process.  Every compilation cache
here (and in the LUT builders) is size-bounded.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np

from ..core import truth_tables as tt
from ..core.blocked import build_lut_blocked
from ..core.lut import LUT
from ..core.nonblocked import build_lut_nonblocked
from . import trace
from .ir import (ApplyLUT, Col, CompareWrite, ForDigit, Op, Program, SetCol,
                 ZeroCol, digit, resolve_col)


@dataclass(frozen=True)
class Step:
    """One flattened compare-block + write: OR of ``keys`` over
    ``compare_cols`` tags the rows, then one write cycle lands.  No keys =
    unconditional write.  ``in_hist`` gates the mismatch histogram."""
    keys: tuple[tuple[int, ...], ...]
    compare_cols: tuple[int, ...]
    write_cols: tuple[int, ...]
    write_vals: tuple[int, ...]
    in_hist: bool = True

    @property
    def n_compares(self) -> int:
        return len(self.keys)


def lower(program: Program, env: dict[str, int] | None = None
          ) -> tuple[Step, ...]:
    """Flatten a program into a static Step schedule."""
    env = env or {}
    steps: list[Step] = []
    for op in program:
        steps.extend(_lower_op(op, env))
    return tuple(steps)


def _lower_op(op: Op, env: dict[str, int]) -> list[Step]:
    if isinstance(op, SetCol):
        return [Step(keys=(), compare_cols=(),
                     write_cols=(resolve_col(op.col, env),),
                     write_vals=(int(op.val),), in_hist=False)]
    if isinstance(op, ApplyLUT):
        cols = tuple(resolve_col(c, env) for c in op.col_map)
        xcols = tuple(resolve_col(c, env) for c, _ in op.extra_key)
        xvals = tuple(int(v) for _, v in op.extra_key)
        out = []
        for blk in op.lut.blocks:
            out.append(Step(
                keys=tuple(tuple(k) + xvals for k in blk.keys),
                compare_cols=cols + xcols,
                write_cols=tuple(cols[c] for c in blk.write_cols),
                write_vals=tuple(blk.write_vals)))
        return out
    if isinstance(op, CompareWrite):
        return [Step(keys=(tuple(op.key),),
                     compare_cols=tuple(resolve_col(c, env)
                                        for c in op.compare_cols),
                     write_cols=tuple(resolve_col(c, env)
                                      for c in op.write_cols),
                     write_vals=tuple(op.write_vals),
                     in_hist=op.count_mismatch)]
    if isinstance(op, ForDigit):
        out = []
        for v in range(op.start, op.stop):
            sub = dict(env)
            sub[op.var] = v
            for body_op in op.body:
                out.extend(_lower_op(body_op, sub))
        return out
    raise TypeError(f"unknown IR op {op!r}")


# ---------------------------------------------------------------------------
# Packing: Step schedule -> dense schedule tensors for the program kernel
# ---------------------------------------------------------------------------

class CompiledProgram:
    """A lowered + packed program, ready for the fused executor.

    Dense layout (S steps, K = max keys/step, C = max compare cols,
    W = max write cols; -1 pads invalid columns, key_valid masks pad keys):

    - ``cmp_cols``  (S, C) int32   - ``keys``     (S, K, C) int8
    - ``key_valid`` (S, K) bool    - ``hist_flag`` (S,) bool
    - ``wr_cols``   (S, W) int32   - ``wr_vals``  (S, W) int8

    Cycle counts are schedule-static: one write cycle per step, one compare
    cycle per valid key — identical to the pass-by-pass simulator's charges.
    """

    def __init__(self, steps: tuple[Step, ...], min_cols: int = 0):
        if not steps:
            raise ValueError("empty program")
        self.steps = steps
        S = len(steps)
        K = max(1, max(s.n_compares for s in steps))
        C = max(1, max(len(s.compare_cols) for s in steps))
        W = max(1, max(len(s.write_cols) for s in steps))
        self.cmp_cols = np.full((S, C), -1, np.int32)
        self.keys = np.zeros((S, K, C), np.int8)
        self.key_valid = np.zeros((S, K), bool)
        self.hist_flag = np.zeros((S,), bool)
        self.wr_cols = np.full((S, W), -1, np.int32)
        self.wr_vals = np.zeros((S, W), np.int8)
        cols_seen = 0
        self.writes_distinct = True
        self.compares_distinct = True
        for s, st in enumerate(steps):
            nc = len(st.compare_cols)
            self.cmp_cols[s, :nc] = st.compare_cols
            for k, key in enumerate(st.keys):
                self.keys[s, k, :nc] = key
                self.key_valid[s, k] = True
            self.hist_flag[s] = st.in_hist and bool(st.keys)
            nw = len(st.write_cols)
            self.wr_cols[s, :nw] = st.write_cols
            self.wr_vals[s, :nw] = st.write_vals
            if len(set(st.write_cols)) != nw:
                # duplicate write columns in one step apply serially (last
                # value wins, every change charged) — only the gather body
                # reproduces that; the one-hot blend needs distinct columns
                self.writes_distinct = False
            if len(set(st.compare_cols)) != nc:
                # duplicate compare columns count one mismatch per position;
                # the one-hot plane holds one key value per column, so only
                # the gather body reproduces the per-position histogram
                self.compares_distinct = False
            cols_seen = max(cols_seen, *(c + 1 for c in st.compare_cols),
                            *(c + 1 for c in st.write_cols), 1)
        self.min_cols = max(min_cols, cols_seen)
        self.n_compare_cycles = int(self.key_valid.sum())
        self.n_write_cycles = S
        self._packed: dict[int, "PackedProgram"] = {}

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    @property
    def schedule_tensors(self) -> tuple[np.ndarray, ...]:
        """The 6 dense tensors the program kernel replays, flat order."""
        return (self.cmp_cols, self.keys, self.key_valid, self.hist_flag,
                self.wr_cols, self.wr_vals)

    def packed(self, max_pack: int | None = None) -> "PackedProgram":
        """The VLIW-packed schedule (cached per program per pack cap)."""
        mp = DEFAULT_MAX_PACK if max_pack is None else max_pack
        hit = self._packed.get(mp)
        if hit is None:
            while len(self._packed) >= 8:             # FIFO-bound the memo
                self._packed.pop(next(iter(self._packed)))
            hit = self._packed.setdefault(mp, PackedProgram(self, mp))
        return hit

    def as_tap_steps(self):
        """Legacy 4-tuple form for kernels.tap_pass.{ref,kernel} oracles."""
        return tuple((s.keys, s.compare_cols, s.write_cols, s.write_vals)
                     for s in self.steps)


# ---------------------------------------------------------------------------
# VLIW step packing: dependence-aware list scheduling of the flat schedule
# ---------------------------------------------------------------------------

DEFAULT_MAX_PACK = 8         # slots per packed group (kernel unrolls them)

KERNEL_VARIANTS = ("gather", "onehot", "onehot_packed")


def default_kernel_variant() -> str:
    """What the executors run when no ``kernel_variant`` is requested.

    ``"gather"`` on every device.  The CUDA program kernel gives each row
    one thread that replays the whole schedule with no barrier between
    steps, so the VLIW-packed schedule saves no trips there and only pads
    the slot grid; the plain CPU path is a step loop either way.
    ``REPRO_AP_KERNEL_VARIANT`` overrides.  All variants are
    bit-identical.
    """
    return os.environ.get("REPRO_AP_KERNEL_VARIANT") or "gather"


def pack_steps(steps: tuple[Step, ...], max_pack: int = DEFAULT_MAX_PACK
               ) -> list[list[int]]:
    """Greedy list scheduling of steps into VLIW groups of independent slots.

    A step conflicts with an earlier step when it reads a column the earlier
    one writes (RAW), writes a column the earlier one writes (WAW), or
    writes a column the earlier one compares (WAR) — conflicting steps land
    in strictly ordered groups, so replaying groups in order with all of a
    group's compares taken against the pre-group array (then all its writes
    landed at once) is step-for-step equivalent to the flat schedule,
    counters included.  Steps with no conflict pack into the earliest group
    with a free slot, which is what shrinks serial tails like the multiply
    repair sweeps (independent per digit) to ``ceil(n / max_pack)`` groups.
    """
    if max_pack < 1:
        raise ValueError(f"max_pack must be >= 1, got {max_pack}")
    groups: list[list[int]] = []
    last_write: dict[int, int] = {}       # col -> newest group writing it
    last_cmp: dict[int, int] = {}         # col -> newest group comparing it
    for idx, st in enumerate(steps):
        g0 = 0
        for c in st.compare_cols:
            g0 = max(g0, last_write.get(c, -1) + 1)             # RAW
        for c in st.write_cols:
            g0 = max(g0, last_write.get(c, -1) + 1,             # WAW
                     last_cmp.get(c, -1) + 1)                   # WAR
        g = g0
        while g < len(groups) and len(groups[g]) >= max_pack:
            g += 1
        if g == len(groups):
            groups.append([])
        groups[g].append(idx)
        for c in st.compare_cols:
            last_cmp[c] = max(last_cmp.get(c, -1), g)
        for c in st.write_cols:
            last_write[c] = max(last_write.get(c, -1), g)
    return groups


class PackedProgram:
    """A :class:`CompiledProgram` schedule list-scheduled into VLIW groups.

    Same dense tensor layout, but group-major: slot ``g * pack + p`` is slot
    ``p`` of group ``g`` (``pack`` = widest group), padded with no-op slots
    (all write columns -1, no valid keys, hist_flag off) that write and
    count nothing.  Cycle accounting stays on the source program — packing
    is a kernel wall-clock optimization, the modeled hardware still charges
    one write cycle per original step.
    """

    def __init__(self, compiled: CompiledProgram,
                 max_pack: int = DEFAULT_MAX_PACK):
        if not compiled.writes_distinct:
            raise ValueError(
                "cannot pack a program with duplicate write columns in one "
                "step (serial write semantics); run the gather kernel")
        self.compiled = compiled
        self.max_pack = max_pack
        groups = pack_steps(compiled.steps, max_pack)
        self.n_groups = len(groups)
        self.pack = max(len(g) for g in groups)
        S, C = compiled.cmp_cols.shape
        K = compiled.keys.shape[1]
        W = compiled.wr_cols.shape[1]
        n_slots = self.n_groups * self.pack
        self.cmp_cols = np.full((n_slots, C), -1, np.int32)
        self.keys = np.zeros((n_slots, K, C), np.int8)
        self.key_valid = np.zeros((n_slots, K), bool)
        self.hist_flag = np.zeros((n_slots,), bool)
        self.wr_cols = np.full((n_slots, W), -1, np.int32)
        self.wr_vals = np.zeros((n_slots, W), np.int8)
        perm = []                     # flat step index per occupied slot
        slots = []
        for g, members in enumerate(groups):
            for p, idx in enumerate(members):
                perm.append(idx)
                slots.append(g * self.pack + p)
        perm = np.asarray(perm, np.int64)
        slots = np.asarray(slots, np.int64)
        self.cmp_cols[slots] = compiled.cmp_cols[perm]
        self.keys[slots] = compiled.keys[perm]
        self.key_valid[slots] = compiled.key_valid[perm]
        self.hist_flag[slots] = compiled.hist_flag[perm]
        self.wr_cols[slots] = compiled.wr_cols[perm]
        self.wr_vals[slots] = compiled.wr_vals[perm]

    @property
    def n_slots(self) -> int:
        return self.n_groups * self.pack

    @property
    def efficiency(self) -> float:
        """Occupied fraction of the padded slot grid."""
        return self.compiled.n_steps / max(1, self.n_slots)

    @property
    def schedule_tensors(self) -> tuple[np.ndarray, ...]:
        return (self.cmp_cols, self.keys, self.key_valid, self.hist_flag,
                self.wr_cols, self.wr_vals)


def resolve_schedule(compiled: CompiledProgram,
                     kernel_variant: str | None = None,
                     max_pack: int | None = None):
    """Map an executor-level ``kernel_variant`` to kernel arguments.

    Returns ``(schedule_tensors, variant, pack, resolved_name)`` — the
    tensors to feed
    :func:`~repro_torch.kernels.tap_pass.kernel.tap_run_program`
    plus its ``variant``/``pack`` statics.  ``None`` resolves to
    :func:`default_kernel_variant`.  Programs whose steps carry duplicate
    write or compare columns fall back to the gather body (the only
    bit-exact one for serial same-column writes / per-position mismatch
    counting); ``onehot_packed`` additionally falls back to the flat
    one-hot schedule when list scheduling found nothing to pack, or when
    group-width padding would inflate the slot grid faster than the trip
    count shrinks (carry-ripple chains pin most slots to 1-wide groups).
    """
    kv = default_kernel_variant() if kernel_variant is None else kernel_variant
    if kv not in KERNEL_VARIANTS:
        raise ValueError(
            f"kernel_variant must be one of {KERNEL_VARIANTS}, got {kv!r}")
    if kv != "gather" and not (compiled.writes_distinct
                               and compiled.compares_distinct):
        kv = "gather"
    if kv == "onehot_packed":
        p = compiled.packed(max_pack)
        if p.pack > 1 and p.n_slots <= 1.25 * compiled.n_steps:
            return p.schedule_tensors, "onehot", p.pack, kv
        kv = "onehot"                 # no useful packing: skip padded copy
    return compiled.schedule_tensors, kv, 1, kv


@functools.lru_cache(maxsize=256)
def _compile_steps(steps: tuple[Step, ...]) -> CompiledProgram:
    return CompiledProgram(steps)


def compile_program(program: Program) -> CompiledProgram:
    """Lower + pack, cached on the flattened schedule (Step tuples hash)."""
    steps = lower(program)
    return trace.traced_compile("compile_steps", _compile_steps, steps,
                                _label=f"steps[{len(steps)}]")


# ---------------------------------------------------------------------------
# Program builders (mirror the core/ap.py drivers pass-for-pass)
# ---------------------------------------------------------------------------

def ripple_add_program(lut: LUT, width: int, carry_col: int, a_base: int = 0,
                       b_base: int | None = None, zero_carry: bool = True
                       ) -> Program:
    """B <- A + B, digit-serial carry ripple (paper §IV multi-trit add)."""
    b_base = width if b_base is None else b_base
    i = digit("i")
    prog: list[Op] = [ZeroCol(carry_col)] if zero_carry else []
    prog.append(ForDigit("i", 0, width,
                         (ApplyLUT(lut, (a_base + i, b_base + i, carry_col)),)))
    return tuple(prog)


def ripple_sub_program(lut_sub: LUT, width: int, borrow_col: int,
                       a_base: int = 0, b_base: int | None = None,
                       zero_carry: bool = True) -> Program:
    """B <- A - B (mod r^p), borrow ripples."""
    b_base = width if b_base is None else b_base
    i = digit("i")
    prog: list[Op] = [ZeroCol(borrow_col)] if zero_carry else []
    prog.append(ForDigit("i", 0, width,
                         (ApplyLUT(lut_sub,
                                   (a_base + i, b_base + i, borrow_col)),)))
    return tuple(prog)


def multiply_program(lut_add: LUT, lut_half: LUT, width: int, radix: int,
                     a_base: int, acopy_base: int, b_base: int, r_base: int,
                     carry_col: int) -> Program:
    """R <- A * B by shift-and-add with A-repair sweeps.

    Identical op-for-op to :func:`repro_torch.core.ap.multiply`: for each
    multiplier digit B_j and weight t, t predicated add-sweeps of A into
    R<<j, a half-adder carry ripple through the upper product digits, then
    (when the adder's cycle-breaking dummy-writes the A column) a repair
    sweep restoring A from the pristine copy A'.  The digit loops are
    ForDigit IR; the (j, t, repetition) structure — whose trip counts depend
    on t — is unrolled here at build time.
    """
    adder_writes_a = any(0 in p.write_cols for p in lut_add.passes)
    i = digit("i")
    prog: list[Op] = []
    for j in range(width):
        for t in range(1, radix):
            for _ in range(t):
                prog.append(ZeroCol(carry_col))
                prog.append(ForDigit("i", 0, width, (
                    ApplyLUT(lut_add,
                             (a_base + i, r_base + j + i, carry_col),
                             extra_key=((b_base + j, t),)),)))
                prog.append(ForDigit("k", j + width, 2 * width, (
                    ApplyLUT(lut_half, (r_base + digit("k"), carry_col)),)))
                if adder_writes_a:
                    repair = tuple(
                        CompareWrite(compare_cols=(acopy_base + i,),
                                     key=(v,),
                                     write_cols=(a_base + i,),
                                     write_vals=(v,))
                        for v in range(1, radix))
                    prog.append(ForDigit("i", 0, width, repair))
    return tuple(prog)


def negate_program(lut_not_copy: LUT, lut_half: LUT, width: int,
                   b_base: int, r_base: int, carry_col: int) -> Program:
    """R <- (-B) mod r^p (radix complement): digitwise diminished-radix
    complement of B into R via the 2-column inverter LUT, then +1 by seeding
    the carry column and rippling the half adder through R."""
    i = digit("i")
    return (
        ForDigit("i", 0, width,
                 (ApplyLUT(lut_not_copy, (b_base + i, r_base + i)),)),
        SetCol(carry_col, 1),
        ForDigit("i", 0, width,
                 (ApplyLUT(lut_half, (r_base + i, carry_col)),)),
    )


def elementwise_program(lut2: LUT, width: int, a_base: int = 0,
                        b_base: int | None = None) -> Program:
    """Digitwise 2-input MVL op B_i <- f(A_i, B_i) (min/max/modsum/...)."""
    b_base = width if b_base is None else b_base
    i = digit("i")
    return (ForDigit("i", 0, width,
                     (ApplyLUT(lut2, (a_base + i, b_base + i)),)),)


def checksum_program(n_cols: int, radix: int, cs_col: int | None = None
                     ) -> Program:
    """Mod-r row checksum fold: ``cs <- sum(col_0..col_{n-1}) mod r``.

    The fault-detection program (the fault model's): zero the
    checksum column, then fold every data column in with the ``modsum``
    2-input LUT (``(a, b) -> (a, (a+b) mod r)``).  Compiling it through
    the normal IR means every compare/write cycle of detection is priced
    by the same schedule-static accounting as real programs — checksum
    verification shows up honestly in ``APStats``.
    """
    if n_cols < 1:
        raise ValueError(f"need at least one data column, got {n_cols}")
    cs = n_cols if cs_col is None else cs_col
    lut = build_lut_nonblocked(tt.REGISTRY["modsum"](radix))
    return (ZeroCol(cs),) + tuple(ApplyLUT(lut, (c, cs))
                                  for c in range(n_cols))


@functools.lru_cache(maxsize=64)
def _compile_checksum_cached(n_cols: int, radix: int) -> CompiledProgram:
    return compile_program(checksum_program(n_cols, radix))


def compile_checksum(n_cols: int, radix: int) -> CompiledProgram:
    """Compiled mod-r checksum fold over ``n_cols`` data columns, writing
    column ``n_cols`` (cached)."""
    return trace.traced_compile(
        "compile_checksum", _compile_checksum_cached, n_cols, radix,
        _label=f"checksum:{n_cols}c:r{radix}")


# ---------------------------------------------------------------------------
# Whole-program cache keyed on (fn, radix, width)
# ---------------------------------------------------------------------------

def compile_named(fn: str, radix: int, width: int, *, blocked: bool = False
                  ) -> CompiledProgram:
    """Compile a standard multi-digit program by name, cached (with
    compile-span + cache hit/miss telemetry; see
    :mod:`repro_torch.apc.trace`).

    See :func:`_compile_named_cached` for the program layouts.
    """
    return trace.traced_compile(
        "compile_named", _compile_named_cached, fn, radix, width,
        blocked=blocked, _label=f"{fn}:r{radix}:w{width}")


@functools.lru_cache(maxsize=128)
def _compile_named_cached(fn: str, radix: int, width: int, *,
                          blocked: bool = False) -> CompiledProgram:
    """Compile a standard multi-digit program by name, cached.

    Layouts (little-endian digit columns, matching core/ap.py drivers):

    - ``add``/``sub``:          [A(w) | B(w) | C]        -> 2w+1 columns
    - ``mul``:                  [A | A' | B | R(2w) | C] -> 5w+1 columns
    - ``negate``:               [B(w) | R(w) | C]        -> 2w+1 columns
    - ``min``/``max``/``modsum``/``nor``/``nand``: [A | B] -> 2w columns
    """
    build = build_lut_blocked if blocked else build_lut_nonblocked
    if fn == "add":
        lut = build(tt.full_adder(radix))
        prog = ripple_add_program(lut, width, carry_col=2 * width)
    elif fn == "sub":
        lut = build(tt.full_subtractor(radix))
        prog = ripple_sub_program(lut, width, borrow_col=2 * width)
    elif fn == "mul":
        lut_add = build(tt.full_adder(radix))
        lut_half = build(tt.half_adder(radix))
        prog = multiply_program(lut_add, lut_half, width, radix,
                                a_base=0, acopy_base=width, b_base=2 * width,
                                r_base=3 * width, carry_col=5 * width)
    elif fn == "negate":
        lut_not = build(tt.tnot_copy(radix))
        lut_half = build(tt.half_adder(radix))
        prog = negate_program(lut_not, lut_half, width, b_base=0,
                              r_base=width, carry_col=2 * width)
    elif fn in ("min", "max", "modsum", "nor", "nand"):
        lut = build(tt.REGISTRY[fn](radix))
        prog = elementwise_program(lut, width)
    else:
        raise ValueError(f"unknown program {fn!r}")
    return compile_program(prog)
