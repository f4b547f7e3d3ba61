"""MvAP functional simulator in PyTorch (paper Fig. 1 / §III-IV).

The MvCAM array is a ``[n_rows, n_cols]`` int8 tensor of radix-n digits
(``-1`` = the all-HRS don't-care state).  A *compare* applies a masked key to
every row in parallel and produces the per-row Tag vector; a *write* overwrites
the masked columns of tagged rows.  LUT schedules generated by
:mod:`repro_torch.core.nonblocked` / :mod:`repro_torch.core.blocked` are
replayed pass by pass (non-blocked) or block by block (blocked, DFF
semantics: all compares of a block observe the pre-block array; one write
lands at block end).

Rows are the data-parallel axis: every operation here is a tensor op over
the row dimension, on whatever device holds the array.

The simulator doubles as the paper's "functional co-simulator": it counts
memristor set/reset operations (Table V rules) and per-compare mismatch
histograms (fm/1mm/2mm/3mm), which :mod:`repro_torch.core.energy` turns into
energy/delay/area numbers (Table XI, Figs. 8-9).

The drivers take ``engine="replay"`` (this module, the oracle) or
``engine="apc"`` (compile the whole program and run it fused through
:mod:`repro_torch.apc`) and ``device=None`` (``cuda:0``; see
:mod:`repro_torch.device`).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import as_digits
from .lut import LUT
from .mvl import DONT_CARE


# ---------------------------------------------------------------------------
# Stats (functional-simulator counters)
# ---------------------------------------------------------------------------

@dataclass
class APStats:
    """Aggregated counters for an AP program run."""
    radix: int
    n_rows: int = 0
    n_compare_cycles: int = 0        # schedule-level (row-parallel) cycles
    n_write_cycles: int = 0
    sets: int = 0                    # total memristor SET ops across rows
    resets: int = 0                  # total memristor RESET ops across rows
    # mismatch histogram: index k = #row-compares with exactly k mismatching
    # masked cells (k=0 is a full match)
    mismatch_hist: np.ndarray = field(default_factory=lambda: np.zeros(8, np.int64))

    def merge(self, other: "APStats") -> "APStats":
        assert self.radix == other.radix
        out = APStats(self.radix, max(self.n_rows, other.n_rows))
        out.n_compare_cycles = self.n_compare_cycles + other.n_compare_cycles
        out.n_write_cycles = self.n_write_cycles + other.n_write_cycles
        out.sets = self.sets + other.sets
        out.resets = self.resets + other.resets
        n = max(len(self.mismatch_hist), len(other.mismatch_hist))
        h = np.zeros(n, np.int64)
        h[:len(self.mismatch_hist)] += self.mismatch_hist
        h[:len(other.mismatch_hist)] += other.mismatch_hist
        out.mismatch_hist = h
        return out


# ---------------------------------------------------------------------------
# Primitive operations
# ---------------------------------------------------------------------------

def compare(arr: torch.Tensor, cols: tuple[int, ...],
            key: tuple[int, ...]) -> torch.Tensor:
    """Masked-key compare against all rows.  Returns bool Tag vector [R].

    Per-cell match semantics (Table III): masked-out columns always match
    (all decoded signals low); a stored don't-care matches any key; otherwise
    match iff stored == key.
    """
    tag = torch.ones(arr.shape[0], dtype=torch.bool, device=arr.device)
    for c, k in zip(cols, key):
        cell = arr[:, c]
        tag &= (cell == k) | (cell == DONT_CARE)
    return tag


def mismatch_count(arr: torch.Tensor, cols: tuple[int, ...],
                   key: tuple[int, ...]) -> torch.Tensor:
    """#mismatching masked cells per row (0 = full match) — energy model input."""
    m = torch.zeros(arr.shape[0], dtype=torch.int32, device=arr.device)
    for c, k in zip(cols, key):
        cell = arr[:, c]
        m += ((cell != k) & (cell != DONT_CARE)).to(torch.int32)
    return m


def write(arr: torch.Tensor, tag: torch.Tensor, cols: tuple[int, ...],
          vals: tuple[int, ...]
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Overwrite masked columns of tagged rows.

    Returns (new_arr, n_sets, n_resets) where set/reset counts follow the
    nTnR write rules (paper §II.C.2 / Table V): a changed digit costs one SET
    (new memristor to LRS) + one RESET (old to HRS); writing the stored value
    costs nothing; writing over don't-care costs one SET only.  ``arr`` is
    not modified; every column's old value is read from it.
    """
    sets = torch.zeros((), dtype=torch.int64, device=arr.device)
    resets = torch.zeros((), dtype=torch.int64, device=arr.device)
    new = arr.clone()
    for c, v in zip(cols, vals):
        old = arr[:, c]
        changed = tag & (old != v)
        sets = sets + changed.sum()                        # new LRS (v != DC)
        resets = resets + (changed & (old != DONT_CARE)).sum()
        new[:, c] = old.masked_fill(changed, v)
    return new, sets, resets


# ---------------------------------------------------------------------------
# LUT replay
# ---------------------------------------------------------------------------

def apply_lut(arr: torch.Tensor, lut: LUT, col_map: tuple[int, ...],
              extra_key: tuple[tuple[int, int], ...] = (),
              stats: APStats | None = None) -> torch.Tensor:
    """Replay a LUT schedule on the array.

    ``col_map[i]`` is the physical column of logical LUT column ``i``.
    ``extra_key`` extends every compare with additional (col, value) exact
    matches — used by the multiplication driver to predicate on a multiplier
    digit.  The pass/block loop is a python loop over the *static* schedule;
    row work is fully vectorized.
    """
    mm_updates = []
    for blk in lut.blocks:
        tag = torch.zeros(arr.shape[0], dtype=torch.bool, device=arr.device)
        for key in blk.keys:
            cols = tuple(col_map[i] for i in range(lut.width))
            full_cols = cols + tuple(c for c, _ in extra_key)
            full_key = tuple(key) + tuple(v for _, v in extra_key)
            tag |= compare(arr, full_cols, full_key)
            if stats is not None:
                mm_updates.append(mismatch_count(arr, full_cols, full_key))
        wcols = tuple(col_map[c] for c in blk.write_cols)
        arr, s, r = write(arr, tag, wcols, blk.write_vals)
        if stats is not None:
            stats.sets += int(s)
            stats.resets += int(r)
    if stats is not None:
        stats.n_compare_cycles += lut.n_compare_cycles
        stats.n_write_cycles += lut.n_write_cycles
        stats.n_rows = arr.shape[0]
        nb = len(stats.mismatch_hist)
        for mm in mm_updates:
            counts = np.bincount(mm.cpu().numpy(), minlength=nb)
            if len(counts) > nb:
                # fold overflow into the final (">= nb-1 mismatches") bin —
                # same saturation as the fused kernel's histogram
                counts = np.concatenate([counts[:nb - 1],
                                         [counts[nb - 1:].sum()]])
            stats.mismatch_hist += counts.astype(np.int64)
    return arr


def apply_lut_pure(arr: torch.Tensor, lut: LUT, col_map: tuple[int, ...],
                   extra_key: tuple[tuple[int, int], ...] = ()
                   ) -> torch.Tensor:
    """Counter-free replay (no host syncs)."""
    for blk in lut.blocks:
        tag = torch.zeros(arr.shape[0], dtype=torch.bool, device=arr.device)
        for key in blk.keys:
            cols = tuple(col_map[i] for i in range(lut.width))
            full_cols = cols + tuple(c for c, _ in extra_key)
            full_key = tuple(key) + tuple(v for _, v in extra_key)
            tag |= compare(arr, full_cols, full_key)
        wcols = tuple(col_map[c] for c in blk.write_cols)
        new = arr.clone()
        for c, v in zip(wcols, blk.write_vals):
            new[:, c] = arr[:, c].masked_fill(tag, v)
        arr = new
    return arr


# ---------------------------------------------------------------------------
# Number layout helpers
# ---------------------------------------------------------------------------

def encode_operands(a: np.ndarray, b: np.ndarray, radix: int, width: int,
                    extra_cols: int = 1) -> np.ndarray:
    """Pack integer vectors A, B into the CAM layout.

    Layout (little-endian digits): columns [A_0..A_{w-1} | B_0..B_{w-1} | C...]
    with ``extra_cols`` scratch/carry columns initialised to 0 — the paper's
    2p+1 cells/row for p-trit addition.
    """
    rows = len(a)
    arr = np.zeros((rows, 2 * width + extra_cols), dtype=np.int8)
    for i in range(width):
        arr[:, i] = (a // radix ** i) % radix
        arr[:, width + i] = (b // radix ** i) % radix
    return arr


def decode_digits(arr, cols: list[int], radix: int) -> np.ndarray:
    """Little-endian digit columns → integer vector (numpy or tensor in)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    out = np.zeros(arr.shape[0], dtype=np.int64)
    for k, c in enumerate(cols):
        out += arr[:, c].astype(np.int64) * radix ** k
    return out


# ---------------------------------------------------------------------------
# Arithmetic drivers (multi-digit, row-parallel)
# ---------------------------------------------------------------------------

def _tspan(name: str, **args):
    """Driver-phase trace span (no-op unless a tracer is active).

    The apc package import is lazy: repro_torch.core must stay importable
    without initializing repro_torch.apc (which imports back into core).
    """
    from ..apc import trace
    return trace.span(name, cat="driver", **args)


def _set_col(arr: torch.Tensor, col: int, val: int,
             stats: APStats | None) -> torch.Tensor:
    """Unconditional write of ``val`` into a column (one write cycle)."""
    ones = torch.ones(arr.shape[0], dtype=torch.bool, device=arr.device)
    arr, s, r = write(arr, ones, (col,), (val,))
    if stats is not None:
        stats.sets += int(s)
        stats.resets += int(r)
        stats.n_write_cycles += 1
    return arr


def _zero_col(arr: torch.Tensor, col: int,
              stats: APStats | None) -> torch.Tensor:
    return _set_col(arr, col, 0, stats)


def _apply(arr, lut, col_map, extra=(), stats=None):
    if stats is None:
        return apply_lut_pure(arr, lut, col_map, extra)
    return apply_lut(arr, lut, col_map, extra, stats=stats)


def _run_apc(arr, program, stats, pool, kernel_variant, device):
    from .. import apc
    return apc.run(arr, program, stats=stats, pool=pool,
                   kernel_variant=kernel_variant, device=device)


def ripple_add(arr, lut: LUT, width: int, carry_col: int,
               a_base: int = 0, b_base: int | None = None,
               stats: APStats | None = None, zero_carry: bool = True,
               engine: str = "replay", pool=None,
               kernel_variant: str | None = None,
               device=None) -> torch.Tensor:
    """In-place p-digit add: B <- A + B, digit-serial over positions.

    ``lut`` is a full-adder schedule over logical columns (A, B, C); the
    carry column ripples across digit positions, exactly the paper's §IV
    multi-trit operation.

    ``engine="replay"`` replays pass-by-pass (this module, the oracle);
    ``engine="apc"`` compiles the whole program and runs it fused
    (:mod:`repro_torch.apc`) — identical digits and counters, no per-pass
    syncs.  ``kernel_variant`` (apc engine only, also on the other drivers
    below) picks the schedule form (:mod:`repro_torch.apc.exec`); every
    variant is bit-exact.  ``pool`` (an :class:`repro_torch.apc.ArrayPool`,
    apc engine only, also on the other drivers below) streams the rows
    over the array bank on the pool's device.
    """
    b_base = width if b_base is None else b_base
    arr = as_digits(arr, device)
    with _tspan("ripple_add", rows=int(arr.shape[0]), width=width,
                engine=engine):
        if engine == "apc":
            from ..apc.lower import ripple_add_program
            return _run_apc(arr, ripple_add_program(
                lut, width, carry_col, a_base, b_base, zero_carry),
                stats, pool, kernel_variant, arr.device)
        if zero_carry:
            arr = _zero_col(arr, carry_col, stats)
        for i in range(width):
            arr = _apply(arr, lut, (a_base + i, b_base + i, carry_col),
                         (), stats)
        return arr


def ripple_sub(arr, lut_sub: LUT, width: int, borrow_col: int,
               stats: APStats | None = None, zero_carry: bool = True,
               engine: str = "replay", pool=None,
               kernel_variant: str | None = None,
               device=None) -> torch.Tensor:
    """In-place p-digit subtract: B <- A - B (mod r^p), borrow ripples."""
    arr = as_digits(arr, device)
    with _tspan("ripple_sub", rows=int(arr.shape[0]), width=width,
                engine=engine):
        if engine == "apc":
            from ..apc.lower import ripple_sub_program
            return _run_apc(arr, ripple_sub_program(
                lut_sub, width, borrow_col, zero_carry=zero_carry),
                stats, pool, kernel_variant, arr.device)
        if zero_carry:
            arr = _zero_col(arr, borrow_col, stats)
        for i in range(width):
            arr = _apply(arr, lut_sub, (i, width + i, borrow_col), (), stats)
        return arr


def negate(arr, lut_not_copy: LUT, lut_half: LUT, width: int,
           b_base: int, r_base: int, carry_col: int,
           stats: APStats | None = None, engine: str = "replay",
           pool=None, kernel_variant: str | None = None,
           device=None) -> torch.Tensor:
    """R <- (-B) mod r^p (radix complement).

    Digitwise diminished-radix complement of B into R via the 2-column
    inverter LUT (§IV.B: the 1-column inverter is un-compilable, every
    non-fixpoint sits on a 2-cycle), then +1 by seeding the carry column
    with 1 and rippling the half adder through R.
    """
    arr = as_digits(arr, device)
    with _tspan("negate", rows=int(arr.shape[0]), width=width,
                engine=engine):
        if engine == "apc":
            from ..apc.lower import negate_program
            return _run_apc(arr, negate_program(
                lut_not_copy, lut_half, width, b_base, r_base, carry_col),
                stats, pool, kernel_variant, arr.device)
        for i in range(width):
            arr = _apply(arr, lut_not_copy, (b_base + i, r_base + i),
                         (), stats)
        arr = _set_col(arr, carry_col, 1, stats)
        for i in range(width):
            arr = _apply(arr, lut_half, (r_base + i, carry_col), (), stats)
        return arr


def elementwise(arr, lut2: LUT, width: int, a_base: int = 0,
                b_base: int | None = None, stats: APStats | None = None,
                engine: str = "replay", pool=None,
                kernel_variant: str | None = None,
                device=None) -> torch.Tensor:
    """Digitwise 2-input MVL op B_i <- f(A_i, B_i) (min/max/modsum/...)."""
    b_base = width if b_base is None else b_base
    arr = as_digits(arr, device)
    with _tspan("elementwise", rows=int(arr.shape[0]), width=width,
                engine=engine):
        if engine == "apc":
            from ..apc.lower import elementwise_program
            return _run_apc(arr, elementwise_program(
                lut2, width, a_base, b_base),
                stats, pool, kernel_variant, arr.device)
        for i in range(width):
            arr = _apply(arr, lut2, (a_base + i, b_base + i), (), stats)
        return arr


def multiply(arr, lut_add: LUT, lut_half: LUT, width: int, radix: int,
             a_base: int, acopy_base: int, b_base: int, r_base: int,
             carry_col: int, stats: APStats | None = None,
             engine: str = "replay", pool=None,
             kernel_variant: str | None = None,
             device=None) -> torch.Tensor:
    """R <- A * B by AP shift-and-add (the §IV LUT methodology, extended).

    For each multiplier digit B_j and each weight t in {1..r-1}, run t
    add-sweeps of A into R<<j with every compare key extended by (B_j == t):
    only rows whose multiplier digit equals t take those adds.  After the
    adder sweeps, the carry ripples out through the upper R digits with the
    half-adder LUT.

    Operand-corruption hazard (our finding on §IV.B): the TFA's cycle-breaking
    pass performs a dummy write into the A column, so A does not survive a
    sweep for rows that hit the '101' state.  A pristine copy A' is kept and a
    repair sweep (compare A'_i==v -> write A_i:=v) restores A after each add
    sweep; corruption only ever writes the dummy value, so repair is exact.
    All extra compare/write cycles are charged to ``stats``.

    Layout: [A | A' | B | R(2w) | C]; R and C must be zeroed beforehand.
    """
    arr = as_digits(arr, device)
    with _tspan("multiply", rows=int(arr.shape[0]), width=width,
                engine=engine):
        if engine == "apc":
            from ..apc.lower import multiply_program
            return _run_apc(arr, multiply_program(
                lut_add, lut_half, width, radix, a_base, acopy_base, b_base,
                r_base, carry_col), stats, pool, kernel_variant, arr.device)
        adder_writes_a = any(0 in p.write_cols for p in lut_add.passes)
        for j in range(width):
            for t in range(1, radix):
                for _ in range(t):
                    arr = _zero_col(arr, carry_col, stats)
                    extra = ((b_base + j, t),)
                    for i in range(width):
                        col_map = (a_base + i, r_base + j + i, carry_col)
                        arr = _apply(arr, lut_add, col_map, extra, stats)
                    # ripple the final carry out through the upper product
                    # digits
                    for k in range(j + width, 2 * width):
                        arr = _apply(arr, lut_half, (r_base + k, carry_col),
                                     (), stats)
                    if adder_writes_a:
                        # repair sweep: restore any dummy-written A digits
                        for i in range(width):
                            for v in range(1, radix):
                                tag = compare(arr, (acopy_base + i,), (v,))
                                arr, s, r = write(arr, tag, (a_base + i,),
                                                  (v,))
                                if stats is not None:
                                    stats.sets += int(s)
                                    stats.resets += int(r)
                                    stats.n_compare_cycles += 1
                                    stats.n_write_cycles += 1
        return arr


def mac(arr, lut_add: LUT, lut_rsub: LUT, K: int, width: int,
        x_base: int = 0, w_base: int | None = None,
        acc_base: int | None = None, carry_col: int | None = None,
        stats: APStats | None = None, zero_acc: bool = True,
        engine: str = "replay", pool=None,
        kernel_variant: str | None = None, device=None) -> torch.Tensor:
    """ACC <- sum_k w_k * X_k: ternary multiply-accumulate (dot product).

    Weight digits W_k store trit+1 in {0,1,2}; for each k one full-adder
    sweep predicated on W_k == 2 (ACC += X_k) and one rev-subtractor sweep
    predicated on W_k == 0 (ACC -= X_k) run over the accumulator digits.
    Arithmetic wraps mod r^width (radix complement), so no carry ripples
    past the accumulator and negative operands/sums are free.  Default
    layout [X_0..X_{K-1} | W(K) | ACC | C] per
    :func:`repro_torch.apc.mac_layout`.
    """
    from ..apc.mac import W_MINUS, W_PLUS, mac_layout, mac_program
    lay = mac_layout(K, width)
    w_base = lay["w_base"] if w_base is None else w_base
    acc_base = lay["acc_base"] if acc_base is None else acc_base
    carry_col = lay["carry_col"] if carry_col is None else carry_col
    arr = as_digits(arr, device)
    with _tspan("mac", rows=int(arr.shape[0]), k=K, width=width,
                engine=engine):
        if engine == "apc":
            return _run_apc(arr, mac_program(
                lut_add, lut_rsub, K, width, x_base, w_base, acc_base,
                carry_col, zero_acc), stats, pool, kernel_variant,
                arr.device)
        if zero_acc:
            for j in range(width):
                arr = _set_col(arr, acc_base + j, 0, stats)
        for k in range(K):
            arr = _zero_col(arr, carry_col, stats)
            for i in range(width):
                arr = _apply(arr, lut_add,
                             (x_base + k * width + i, acc_base + i,
                              carry_col),
                             ((w_base + k, W_PLUS),), stats)
            arr = _zero_col(arr, carry_col, stats)
            for i in range(width):
                arr = _apply(arr, lut_rsub,
                             (x_base + k * width + i, acc_base + i,
                              carry_col),
                             ((w_base + k, W_MINUS),), stats)
        return arr


def mac_tiled(x, w_ter, radix: int, width: int, *, k_tile: int, pool=None,
              runtime=None, stats: APStats | None = None,
              blocked: bool = False, kernel_variant: str | None = None,
              device=None) -> torch.Tensor:
    """Driver for the K-tiled ternary MAC: ACC = sum_k w_k * x_k from raw
    operands (``x`` [R, K] integers, ``w_ter`` [R, K] in {-1, 0, +1}).

    Encoding is on the device; the reduction axis splits into
    ``k_tile``-term partial-sum programs whose radix-complement
    accumulators fold through a ripple-add reduction chain
    (:func:`repro_torch.apc.compile_mac_tiled`) — bit-exact vs the untiled
    :func:`mac` at the same width.  ``pool`` (an
    :class:`repro_torch.apc.ArrayPool`) streams the rows over the array
    bank and bounds every program row to the pool's column budget;
    ``runtime`` (an :class:`repro_torch.apc.Runtime`) schedules the
    tile/reduction programs as a program graph over the runtime's bank
    instead (same digits, same counters, graph makespan in
    ``runtime.last_report``).  Both run on their pool's device; without
    them the programs run on ``device``.  Returns the signed int32 dot
    products.
    """
    from .. import apc
    K = x.shape[1]
    with _tspan("mac_tiled", rows=int(x.shape[0]), k=K, width=width,
                k_tile=k_tile,
                route=("runtime" if runtime is not None
                       else "pool" if pool is not None else "plain")):
        if runtime is not None:
            if pool is not None:
                raise ValueError("runtime= already carries a pool; pass one "
                                 "of pool= or runtime=")
            runtime.check_knobs(kernel_variant=kernel_variant)
            tiled = apc.compile_mac_tiled(radix, K, width, k_tile,
                                          blocked=blocked,
                                          max_cols=runtime.pool.cols)
            dev = runtime.pool.device
            (digits,) = runtime.run_mac_graph(
                [(torch.as_tensor(x).to(dev), torch.as_tensor(w_ter).to(dev),
                  tiled)], stats=stats)
            return apc.decode_signed_digits_jnp(digits, radix)
        max_cols = pool.cols if pool is not None else None
        tiled = apc.compile_mac_tiled(radix, K, width, k_tile,
                                      blocked=blocked, max_cols=max_cols)
        return apc.run_mac_tiled(x, w_ter, tiled, pool=pool, stats=stats,
                                 kernel_variant=kernel_variant,
                                 device=device)
