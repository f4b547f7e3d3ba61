"""AP multiply-accumulate: the ternary dot-product as one fused program.

The paper's in-memory claim applied to the model-serving path: a ternary
dot-product ``y = sum_k w_k * x_k`` with weights in {-1, 0, +1} needs no
multiplier at all — it is K predicated in-place add/subtract sweeps on an
accumulator column group, exactly the §IV multi-digit methodology with every
compare key extended by the row's weight digit:

- ``w_k = +1``  ->  ``ACC += X_k``  (full-adder sweep, predicate W_k == 2)
- ``w_k = -1``  ->  ``ACC -= X_k``  (rev-subtractor sweep, predicate W_k == 0)
- ``w_k =  0``  ->  no row matches either predicate; the sweeps are no-ops.

Every CAM row holds one output cell's operands — for a matmul, row (m, n)
holds activation vector x[m, :] (radix-r digits), weight column w[:, n]
(one digit per k, value+1 in {0,1,2}), and the accumulator — so ONE program
run computes all M*N dot products in parallel, rows being the AP's native
data-parallel axis.

Arithmetic is mod r^width with radix-complement (signed) encoding: operands
and accumulator live at the same width, so carries out of the top digit drop
and no half-adder ripple into upper digits is needed; negative activations
and negative partial sums cost nothing extra.  :func:`mac_acc_width` picks
the minimal width for exact signed decode.

Operand-corruption note (§IV.B): the adder/subtractor cycle-breaking pass
dummy-writes the X column, but unlike :func:`~repro_torch.apc.lower.
multiply_program` no repair sweep is needed — each X_k block is consumed by
exactly one sweep per row (the two predicates are disjoint), so the X
columns are simply scratch after the run; only ACC is read back.

Programs are compiled once per (radix, K, width) (:func:`compile_mac`,
lru-cached) and run via the fused executor — one program-kernel launch
for the whole K-term dot product.

K-tiling (column budget): one MvCAM array has a bounded number of columns,
and the untiled MAC layout needs ``K*(width+1) + width + 1`` of them — at
serving-scale K the row simply does not fit.  :func:`compile_mac_tiled`
splits the reduction axis into ``ceil(K / k_tile)`` tiles, each an ordinary
(smaller) MAC program producing a radix-complement partial accumulator at
the SAME width; because the arithmetic is mod ``r^width`` throughout,
adding the partials (a chain of ripple-add sweeps, :func:`mac_reduce_
program`) yields digits bit-identical to the untiled program whenever the
true dot product is decodable at that width.  Tiled cycle counts are the
exact sum of the tile programs plus the reduction programs.
"""
from __future__ import annotations

import functools
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..core import truth_tables as tt
from ..core.blocked import build_lut_blocked
from ..core.lut import LUT
from ..core.nonblocked import build_lut_nonblocked
from . import trace
from .ir import ApplyLUT, ForDigit, Op, Program, SetCol, ZeroCol, digit
from .lower import CompiledProgram, compile_program
from .metrics import get_registry

# weight trit encoding: stored digit = trit + 1 (valid for any radix >= 3)
W_MINUS, W_ZERO, W_PLUS = 0, 1, 2

# support-mask bits: bit v is set iff weight digit value v occurs in the
# column.  A dense column has all three; a zero trit contributes only
# bit W_ZERO, which predicates no sweep.
SUPPORT_DENSE = (1 << W_MINUS) | (1 << W_ZERO) | (1 << W_PLUS)


def _host(w) -> np.ndarray:
    """A numpy copy of ``w`` (numpy, list or a tensor on any device)."""
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().numpy()
    return np.asarray(w)


def mac_weight_support(w_ter) -> tuple[int, ...]:
    """Per-k digit-support bitmasks for a ternary weight block.

    ``w_ter`` is any array whose LAST axis is K (``[K]``, ``[N, K]``, ...);
    leading axes are the CAM rows that will share the program, so the mask
    for position k is the union of digit values seen across them.  Bit
    ``v`` (v = trit + 1) set means some row holds that digit at k — the
    add sweep can fire only if bit :data:`W_PLUS` is set, the subtract
    sweep only if bit :data:`W_MINUS` is.  Host-syncs ``w_ter``.
    """
    w = _host(w_ter)
    if w.ndim == 0:
        raise ValueError("w_ter must have a K axis")
    d = (w.astype(np.int64) + 1).reshape(-1, w.shape[-1])
    if d.size and (d.min() < 0 or d.max() > 2):
        raise ValueError("weights must be ternary in {-1, 0, +1}")
    out = np.zeros(w.shape[-1], np.int64)
    for v in (W_MINUS, W_ZERO, W_PLUS):
        out |= (d == v).any(axis=0) << v
    return tuple(int(m) for m in out)


def weight_digest(w_ter) -> str:
    """Content hash of a ternary weight block (canonical int8 digits +
    shape) — the identity key for sparsity-pruned programs and
    resident-bank handles."""
    w = np.ascontiguousarray(_host(w_ter).astype(np.int8) + 1)
    h = hashlib.sha1(repr(w.shape).encode())
    h.update(w.tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def mac_layout(K: int, width: int) -> dict[str, int]:
    """Column bases for the MAC row layout
    ``[X_0(w) .. X_{K-1}(w) | W(K) | ACC(w) | C]``."""
    return {"x_base": 0, "w_base": K * width, "acc_base": K * width + K,
            "carry_col": K * width + K + width,
            "n_cols": K * (width + 1) + width + 1}


def mac_acc_width(radix: int, K: int, max_abs: int) -> int:
    """Minimal digit width for exact signed (radix-complement) decode of
    ``sum_k w_k * x_k`` with ``|x_k| <= max_abs`` and ternary weights:
    smallest p with ``r^p >= 2 * K * max_abs + 1``."""
    bound = 2 * K * max(1, max_abs) + 1
    p, hi = 1, radix
    while hi < bound:
        p, hi = p + 1, hi * radix
    return p


# ---------------------------------------------------------------------------
# Program builder
# ---------------------------------------------------------------------------

def mac_program(lut_add: LUT, lut_rsub: LUT, K: int, width: int,
                x_base: int = 0, w_base: int | None = None,
                acc_base: int | None = None, carry_col: int | None = None,
                zero_acc: bool = True,
                support: tuple[int, ...] | None = None) -> Program:
    """ACC <- sum_k w_k * X_k, one predicated add + sub sweep per k.

    ``lut_add`` computes B <- A + B + C (:func:`~repro_torch.core.
    truth_tables.full_adder`), ``lut_rsub`` computes B <- B - A - C
    (:func:`~repro_torch.core.truth_tables.rev_subtractor`); both keep the
    accumulator in column 1 so X stays stationary.  Carries wrap mod
    r^width (radix-complement), so no upper-digit ripple follows the
    sweeps.

    ``support`` (sparsity compression): per-k digit-support bitmasks from
    :func:`mac_weight_support`.  A sweep whose predicate digit is absent
    from the column can never fire, so its compare/write steps (and the
    carry clear in front of them) are simply not emitted — a zero trit
    kills both sweeps for its k.  The pruned program is bit-exact on any
    data respecting the support: the dropped sweeps would have matched no
    row and written nothing.
    """
    lay = mac_layout(K, width)
    w_base = lay["w_base"] if w_base is None else w_base
    acc_base = lay["acc_base"] if acc_base is None else acc_base
    carry_col = lay["carry_col"] if carry_col is None else carry_col
    k, i = digit("k"), digit("i")
    xcol = x_base + k * width + i
    prog: list[Op] = []
    if zero_acc:
        prog.extend(SetCol(acc_base + j, 0) for j in range(width))
    if support is None:
        prog.append(ForDigit("k", 0, K, (
            ZeroCol(carry_col),
            ForDigit("i", 0, width, (
                ApplyLUT(lut_add, (xcol, acc_base + i, carry_col),
                         extra_key=((w_base + k, W_PLUS),)),)),
            ZeroCol(carry_col),
            ForDigit("i", 0, width, (
                ApplyLUT(lut_rsub, (xcol, acc_base + i, carry_col),
                         extra_key=((w_base + k, W_MINUS),)),)),
        )))
        return tuple(prog)
    if len(support) != K:
        raise ValueError(f"support has {len(support)} masks for K={K}")
    # unrolled over k so each sweep can be kept/dropped independently;
    # with a fully-dense support this emits the exact same schedule as
    # the ForDigit("k", ...) loop above.
    n_slots = 2 * K
    live = [bool((support[kk] >> wval) & 1)
            for kk in range(K) for wval in (W_PLUS, W_MINUS)]
    last_live = max((s for s in range(n_slots) if live[s]), default=-1)
    for kk in range(K):
        xcol_k = x_base + kk * width + i
        for lut, wval in ((lut_add, W_PLUS), (lut_rsub, W_MINUS)):
            if not (support[kk] >> wval) & 1:
                continue
            prog.append(ZeroCol(carry_col))
            prog.append(ForDigit("i", 0, width, (
                ApplyLUT(lut, (xcol_k, acc_base + i, carry_col),
                         extra_key=((w_base + kk, wval),)),)))
    # set/reset parity with the dense schedule: a carry left nonzero by
    # the final surviving sweep is cleared (one counted reset) by the next
    # pruned slot's ZeroCol in the dense order — keep exactly that one
    # clear when pruned slots follow the last surviving sweep.
    if -1 < last_live < n_slots - 1:
        prog.append(ZeroCol(carry_col))
    return tuple(prog)


def _norm_support(support, K: int) -> tuple[int, ...] | None:
    """Canonicalize a support spec: ``None`` stays ``None`` (dense loop),
    and an all-dense tuple collapses to ``None`` so it shares the dense
    compile-cache entry."""
    if support is None:
        return None
    sup = tuple(int(m) for m in support)
    if len(sup) != K:
        raise ValueError(f"support has {len(sup)} masks for K={K}")
    if all(m == SUPPORT_DENSE for m in sup):
        return None
    return sup


def compile_mac(radix: int, K: int, width: int, *, blocked: bool = False,
                support: tuple[int, ...] | None = None) -> CompiledProgram:
    """Compile the (radix, K, width) MAC program, cached per process.

    With ``support`` (see :func:`mac_weight_support`) the compiled
    schedule carries only the sweeps that can fire for the actual weight
    digits; the cache key includes the mask tuple, so each distinct
    sparsity pattern compiles once."""
    support = _norm_support(support, K)
    label = f"mac:r{radix}:K{K}:w{width}"
    if support is not None:
        label += f":s{_support_digest(support)}"
    return trace.traced_compile(
        "compile_mac", _compile_mac_cached, radix, K, width, blocked=blocked,
        support=support, _label=label)


def _support_digest(support: tuple[int, ...]) -> str:
    return hashlib.sha1(bytes(support)).hexdigest()[:10]


@functools.lru_cache(maxsize=256)
def _compile_mac_cached(radix: int, K: int, width: int, *,
                        blocked: bool = False,
                        support: tuple[int, ...] | None = None
                        ) -> CompiledProgram:
    build = build_lut_blocked if blocked else build_lut_nonblocked
    lut_add = build(tt.full_adder(radix))
    lut_rsub = build(tt.rev_subtractor(radix))
    return compile_program(
        mac_program(lut_add, lut_rsub, K, width, support=support))


# ---------------------------------------------------------------------------
# Row packing / unpacking (host-side numpy)
# ---------------------------------------------------------------------------

def encode_mac_rows(x: np.ndarray, w_ter: np.ndarray, radix: int,
                    width: int) -> np.ndarray:
    """Pack per-row operands into the MAC layout.

    ``x`` [R, K] integers (any sign — stored mod r^width, radix complement),
    ``w_ter`` [R, K] in {-1, 0, +1}.  ACC and C start at 0.
    """
    R, K = x.shape
    if w_ter.shape != (R, K):
        raise ValueError(f"w_ter shape {w_ter.shape} != x shape {(R, K)}")
    if np.abs(w_ter).max(initial=0) > 1:
        raise ValueError("weights must be ternary in {-1, 0, +1}")
    lay = mac_layout(K, width)
    arr = np.zeros((R, lay["n_cols"]), np.int8)
    xm = np.asarray(x, np.int64) % radix ** width          # [R, K]
    for i in range(width):
        arr[:, i:K * width:width] = (xm // radix ** i) % radix
    arr[:, lay["w_base"]:lay["w_base"] + K] = w_ter + 1
    return arr


def decode_mac_acc(arr: np.ndarray, radix: int, K: int,
                   width: int) -> np.ndarray:
    """Signed (radix-complement) decode of the accumulator columns."""
    lay = mac_layout(K, width)
    acc = np.zeros(arr.shape[0], np.int64)
    for i in range(width):
        acc += arr[:, lay["acc_base"] + i].astype(np.int64) * radix ** i
    hi = radix ** width
    return np.where(acc <= (hi - 1) // 2, acc, acc - hi)


# ---------------------------------------------------------------------------
# Row packing / unpacking (device-side torch — no host round trip)
# ---------------------------------------------------------------------------
# The names keep the reference's ``_jnp`` suffix so each function's
# counterpart is found by name; here they take and return torch tensors and
# run on the tensors' device.

def encode_mac_x_rows_jnp(x: torch.Tensor, radix: int,
                          width: int) -> torch.Tensor:
    """Activation half of the MAC row encode: digits of ``x`` [R, K] in the
    k-major/i-minor X-block layout, [R, K*width] int8.  No host sync;
    digits are the radix-complement residue mod ``r^width`` extracted by
    iterated floor-div/mod so no ``r^width`` power is materialized."""
    R, K = x.shape
    v = x.to(torch.int32)
    digs = []
    for _ in range(width):
        # floor div/mod: negative values yield radix-complement digits
        # (v stays -1 forever once exhausted -> all (r-1) digits)
        digs.append(torch.remainder(v, radix).to(torch.int8))
        v = torch.div(v, radix, rounding_mode="floor")
    return torch.stack(digs, dim=-1).reshape(R, K * width)


def encode_weight_digits_jnp(w_ter: torch.Tensor) -> torch.Tensor:
    """Weight half of the MAC row encode: trit + 1 digit plane, int8, same
    shape as ``w_ter``.  This is THE weight-side encode chokepoint — every
    call bumps the ``mac.weight_encodes`` metrics counter."""
    get_registry().counter("mac.weight_encodes").inc()
    return w_ter.to(torch.int8) + 1


def assemble_mac_rows_jnp(xd: torch.Tensor, wd: torch.Tensor,
                          width: int) -> torch.Tensor:
    """Glue pre-encoded halves into full MAC rows: ``xd`` [R, K*width] from
    :func:`encode_mac_x_rows_jnp`, ``wd`` [R, K] from
    :func:`encode_weight_digits_jnp`; ACC and C columns start at 0."""
    R, K = wd.shape
    if tuple(xd.shape) != (R, K * width):
        raise ValueError(f"xd shape {tuple(xd.shape)} != {(R, K * width)}")
    lay = mac_layout(K, width)
    pad = torch.zeros((R, lay["n_cols"] - lay["acc_base"]), dtype=torch.int8,
                      device=xd.device)
    return torch.cat([xd, wd, pad], dim=1)


def encode_mac_rows_jnp(x: torch.Tensor, w_ter: torch.Tensor, radix: int,
                        width: int) -> torch.Tensor:
    """Device-side :func:`encode_mac_rows`: torch, no host sync.

    ``x`` [R, K] integer dtype (any sign; digits are the radix-complement
    residue mod ``r^width``), ``w_ter`` [R, K] in {-1, 0, +1}.  Weight
    validity is the CALLER's contract here — unlike the numpy encoder there
    is no host value check.
    """
    R, K = x.shape
    if tuple(w_ter.shape) != (R, K):
        raise ValueError(f"w_ter shape {tuple(w_ter.shape)} != x shape "
                         f"{(R, K)}")
    return assemble_mac_rows_jnp(
        encode_mac_x_rows_jnp(x, radix, width),
        encode_weight_digits_jnp(w_ter), width)


def decode_signed_digits_jnp(digits: torch.Tensor,
                             radix: int) -> torch.Tensor:
    """Signed radix-complement decode of little-endian digit columns, in
    int32 on the digits' device.

    ``digits`` [R, width] int8.  The wrap test (residue > (r^width - 1)/2)
    is evaluated on two half-words so no intermediate exceeds
    ``r^ceil(width/2)``; the caller's contract is that the decoded value
    itself fits int32 (:func:`mac_acc_width` widths for int32-safe dot
    products always do).
    """
    width = digits.shape[1]
    h = width // 2
    if radix ** (width - h) > 2 ** 31 - 1:
        raise ValueError(
            f"width={width} too wide for int32 device decode at radix "
            f"{radix}; decode on host with decode_mac_acc instead")
    d = digits.to(torch.int32)
    zero = torch.zeros(d.shape[0], dtype=torch.int32, device=d.device)
    lo = sum((d[:, i] * radix ** i for i in range(h)), zero)
    hi = sum((d[:, h + i] * radix ** i for i in range(width - h)), zero)
    half = (radix ** width - 1) // 2
    half_lo, half_hi = half % radix ** h, half // radix ** h
    neg = ((hi > half_hi) | ((hi == half_hi) & (lo > half_lo))).to(
        torch.int32)
    return lo + (hi - neg * radix ** (width - h)) * radix ** h


def decode_mac_acc_jnp(arr: torch.Tensor, radix: int, K: int,
                       width: int) -> torch.Tensor:
    """Device-side :func:`decode_mac_acc` (int32, no host sync)."""
    base = mac_layout(K, width)["acc_base"]
    return decode_signed_digits_jnp(arr[:, base:base + width], radix)


def matmul_mac_rows(x_int: torch.Tensor, w_ter: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """THE row layout of an AP matmul, in one place: CAM row ``t*N + n``
    holds activation vector ``x_int[t, :]`` and weight column
    ``w_ter[:, n]`` — all T*N dot products row-parallel.  ``x_int`` [T, K],
    ``w_ter`` [K, N]; returns ``(x_rows, w_rows)`` both [T*N, K].  The
    matching decode is ``acc.reshape(T, N)``."""
    t, k = x_int.shape
    if w_ter.shape[0] != k:
        raise ValueError(f"x has K={k}, w_ter has K={w_ter.shape[0]}")
    return (torch.repeat_interleave(x_int, w_ter.shape[1], dim=0),
            w_ter.T.repeat(t, 1))


# ---------------------------------------------------------------------------
# K-tiling: per-tile partial-sum programs + ripple-add reduction
# ---------------------------------------------------------------------------

def mac_reduce_program(lut_add: LUT, width: int, n_parts: int) -> Program:
    """Fold ``n_parts`` radix-complement partials into the LAST one.

    Layout ``[P_0(w) | .. | P_{n_parts-1}(w) | C]``: a chain of ripple-add
    sweeps P_t += P_{t-1} (t = 1..n_parts-1), each mod ``r^width`` (the
    carry out of the top digit is dropped with the final carry-clear, the
    same radix-complement wrap as the MAC itself).  The reduced sum lands
    in the P_{n_parts-1} digit block.
    """
    if n_parts < 2:
        raise ValueError(f"reduction needs >= 2 partials, got {n_parts}")
    carry = n_parts * width
    i = digit("i")
    prog: list[Op] = []
    for t in range(1, n_parts):
        prog.append(ZeroCol(carry))
        prog.append(ForDigit("i", 0, width, (
            ApplyLUT(lut_add,
                     ((t - 1) * width + i, t * width + i, carry)),)))
    return tuple(prog)


def compile_mac_reduce(radix: int, width: int, n_parts: int, *,
                       blocked: bool = False) -> CompiledProgram:
    """Compile (cached) the ``n_parts``-way partial-sum reduction."""
    return trace.traced_compile(
        "compile_mac_reduce", _compile_mac_reduce_cached, radix, width,
        n_parts, blocked=blocked, _label=f"reduce:{n_parts}x w{width}")


@functools.lru_cache(maxsize=64)
def _compile_mac_reduce_cached(radix: int, width: int, n_parts: int, *,
                               blocked: bool = False) -> CompiledProgram:
    build = build_lut_blocked if blocked else build_lut_nonblocked
    lut_add = build(tt.full_adder(radix))
    return compile_program(mac_reduce_program(lut_add, width, n_parts))


class TiledMac(NamedTuple):
    """A K-tiled MAC: per-tile partial-sum programs + a reduction chain.

    ``tiles[t] = (k_lo, k_hi)`` is the reduction-axis slice of tile ``t``
    (program ``programs[t]``, an ordinary :func:`compile_mac` at
    ``K = k_hi - k_lo``).  ``reduce_groups[j]`` partials feed reduction
    program ``reduce_programs[j]``; after the first group, each group's
    first partial is the previous group's result (chained when the
    reduction row itself would blow the column budget).

    ``support`` (when not None) records the per-k digit-support masks the
    tile programs were pruned against, and ``dense_write_cycles`` /
    ``dense_compare_cycles`` hold the UNPRUNED totals so the sparsity win
    is always reportable without recompiling the dense oracle.
    """
    radix: int
    K: int
    width: int
    k_tile: int
    tiles: tuple[tuple[int, int], ...]
    programs: tuple[CompiledProgram, ...]
    reduce_groups: tuple[int, ...]
    reduce_programs: tuple[CompiledProgram, ...]
    support: tuple[int, ...] | None = None
    dense_write_cycles: int | None = None
    dense_compare_cycles: int | None = None

    @property
    def n_write_cycles(self) -> int:
        """Exact total: sum of tile programs + reduction programs."""
        return (sum(p.n_write_cycles for p in self.programs)
                + sum(p.n_write_cycles for p in self.reduce_programs))

    @property
    def n_compare_cycles(self) -> int:
        return (sum(p.n_compare_cycles for p in self.programs)
                + sum(p.n_compare_cycles for p in self.reduce_programs))

    @property
    def min_cols(self) -> int:
        """Widest row any constituent program touches."""
        return max(p.min_cols for p in self.programs + self.reduce_programs)

    # -- sparsity accounting ------------------------------------------------

    @property
    def n_pruned_write_cycles(self) -> int:
        """Write cycles the sparsity compression removed vs. dense."""
        if self.dense_write_cycles is None:
            return 0
        return self.dense_write_cycles - self.n_write_cycles

    @property
    def n_pruned_compare_cycles(self) -> int:
        if self.dense_compare_cycles is None:
            return 0
        return self.dense_compare_cycles - self.n_compare_cycles

    @property
    def n_dense_passes(self) -> int:
        """Predicated sweeps the dense program replays: add + sub per k."""
        return 2 * self.K

    @property
    def n_emitted_passes(self) -> int:
        """Predicated sweeps the compiled (possibly pruned) program keeps."""
        if self.support is None:
            return self.n_dense_passes
        return sum(((m >> W_PLUS) & 1) + ((m >> W_MINUS) & 1)
                   for m in self.support)

    @property
    def n_pruned_passes(self) -> int:
        return self.n_dense_passes - self.n_emitted_passes


def _reduce_plan(n_parts: int, width: int, max_cols: int | None
                 ) -> tuple[int, ...]:
    """Group sizes for the reduction chain under a column budget.

    A ``g``-way reduction row needs ``g*width + 1`` columns; when all
    ``n_parts`` partials fit one row the plan is a single group, otherwise
    each later group reuses the previous group's result as its first
    partial (consuming ``g - 1`` fresh partials).
    """
    if n_parts < 2:
        return ()
    cap = n_parts if max_cols is None else (max_cols - 1) // width
    if cap < 2:
        raise ValueError(
            f"column budget {max_cols} cannot hold a 2-way reduction of "
            f"width-{width} partials ({2 * width + 1} columns needed)")
    groups = [min(n_parts, cap)]
    left = n_parts - groups[0]
    while left:
        g = min(left + 1, cap)
        groups.append(g)
        left -= g - 1
    return tuple(groups)


def compile_mac_tiled(radix: int, K: int, width: int, k_tile: int, *,
                      blocked: bool = False, max_cols: int | None = None,
                      support: tuple[int, ...] | None = None) -> TiledMac:
    """Compile the K-tiled MAC: ``ceil(K / k_tile)`` partial-sum programs
    plus the ripple-add reduction chain (``max_cols`` bounds the reduction
    row too).  Bit-exact vs :func:`compile_mac` at the same width — the
    partials and their sum all wrap mod ``r^width`` (radix complement), so
    tiling never changes the final residue digits.

    ``support`` (per-k masks over the FULL K axis, see
    :func:`mac_weight_support`) turns on sparsity compression: each tile
    program is pruned against its ``support[lo:hi]`` slice, and the dense
    cycle totals are recorded on the result for reporting.

    Cached per (radix, K, width, k_tile, blocked, max_cols, support): a
    caller that multiplies by the same projection shape (per weight-content
    hash when pruning) replays the same TiledMac for every request.
    """
    support = _norm_support(support, K)
    label = f"mac_tiled:K{K}/kt{k_tile}:w{width}"
    if support is not None:
        label += f":s{_support_digest(support)}"
    return trace.traced_compile(
        "compile_mac_tiled", _compile_mac_tiled_cached, radix, K, width,
        k_tile, blocked=blocked, max_cols=max_cols, support=support,
        _label=label)


@functools.lru_cache(maxsize=128)
def _compile_mac_tiled_cached(radix: int, K: int, width: int, k_tile: int, *,
                              blocked: bool = False,
                              max_cols: int | None = None,
                              support: tuple[int, ...] | None = None
                              ) -> TiledMac:
    if k_tile < 1:
        raise ValueError(f"k_tile must be >= 1, got {k_tile}")
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    if max_cols is not None:
        tile_cols = mac_layout(min(k_tile, K), width)["n_cols"]
        if tile_cols > max_cols:
            raise ValueError(
                f"k_tile={k_tile} MAC rows need {tile_cols} columns, "
                f"budget is {max_cols}")
    tiles = tuple((lo, min(K, lo + k_tile)) for lo in range(0, K, k_tile))
    programs = tuple(
        compile_mac(radix, hi - lo, width, blocked=blocked,
                    support=None if support is None else support[lo:hi])
        for lo, hi in tiles)
    groups = _reduce_plan(len(tiles), width, max_cols)
    reduce_programs = tuple(
        compile_mac_reduce(radix, width, g, blocked=blocked) for g in groups)
    dense_w = dense_c = None
    if support is not None:
        # the dense tile programs are one lru hit each — record the
        # unpruned totals so the sparsity win is visible downstream
        dense = [compile_mac(radix, hi - lo, width, blocked=blocked)
                 for lo, hi in tiles]
        dense_w = (sum(p.n_write_cycles for p in dense)
                   + sum(p.n_write_cycles for p in reduce_programs))
        dense_c = (sum(p.n_compare_cycles for p in dense)
                   + sum(p.n_compare_cycles for p in reduce_programs))
    return TiledMac(radix, K, width, k_tile, tiles, programs, groups,
                    reduce_programs, support, dense_w, dense_c)
