"""AP backend for the packed-ternary matmul (impl="ap").

Runs the whole M x N output tile as associative-processor MAC programs:
row (m, n) of the MvCAM bank holds activation vector x[m, :] as radix-r
digit groups, weight column w[:, n] as trit digits, and an accumulator;
:func:`repro_torch.apc.compile_mac` compiles the K-term predicated
add/subtract schedule once per (radix, K, width) and the executor replays
it in one program-kernel launch.

Column budget: the untiled MAC row needs ``K*(width+1) + width + 1``
columns, and the program kernel stages a row tile in shared memory, so
serving-scale K runs through ``k_tile=``:
:func:`repro_torch.apc.compile_mac_tiled` splits the reduction axis into
K-tiles, each an ordinary MAC program producing a radix-complement partial
accumulator at the same width, and a ripple-add reduction chain folds the
partials.  Because every program wraps mod ``r^width``, the tiled digits —
and hence the decoded matmul — are bit-identical to the untiled program,
and the charged compare/write cycles are the exact sum of the tile programs
plus the reduction programs.  ``pool=`` (an
:class:`repro_torch.apc.ArrayPool`) streams the rows through the array
bank, K-tiled to its column budget; ``runtime=`` (an
:class:`repro_torch.apc.Runtime`) schedules the tiled MAC as a program
graph over its bank; ``mesh=`` (a sequence of devices) shards the rows of
the untiled program.

Data movement: encode (digit extraction, weight trits, row replication)
and decode (signed radix-complement) run on the device; the one host sync
on the input side is the integer-validation/width reduction on the [M, K]
input (two scalars), and results stay on the device.

It is exact integer arithmetic, so activations must be integer-valued; for
float activations use the packed kernel (``impl="pallas"``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .ref import unpack_ternary

__all__ = ["ternary_matmul_ap", "ap_matmul_cycle_counts", "default_k_tile"]


def _as_int_activations(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Validate + convert to int32 on x's device; returns (xi, max_abs).

    The ONE input-side host sync: two scalars (validity flag, |x| max) —
    the [M, K] digits themselves never round-trip.
    """
    xf = x.to(torch.float32)
    max_abs = (xf.abs().max() if xf.numel()
               else torch.zeros((), device=xf.device))
    ok, max_abs = torch.stack([
        torch.all(xf == torch.round(xf)).to(torch.float32),
        max_abs]).tolist()
    if not ok:
        raise ValueError(
            "impl='ap' runs exact integer AP arithmetic: activations must "
            "be integer-valued (got non-integer entries); quantize x first "
            "or use impl='pallas'")
    return xf.to(torch.int32), int(max_abs)


def default_k_tile(cols: int, width: int) -> int:
    """Largest K-tile whose MAC row fits a ``cols``-column array:
    ``mac_layout(k, width).n_cols = k*(width+1) + width + 1 <= cols``."""
    kt = (cols - width - 1) // (width + 1)
    if kt < 1:
        raise ValueError(
            f"column budget {cols} cannot hold even a 1-term width-{width} "
            f"MAC row ({2 * width + 2} columns needed)")
    return kt


def ternary_matmul_ap(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor, *, radix: int = 3,
                      width: int | None = None, mesh=None, pool=None,
                      runtime=None, k_tile: int | None = None, stats=None,
                      block_rows: int | None = None, blocked: bool = False,
                      kernel_variant: str | None = None) -> torch.Tensor:
    """y[M, N] = (x @ unpack(packed)) * scale on the AP program executor.

    ``x`` [M, K] integer-valued; ``packed``/``scale`` as produced by
    :func:`~repro_torch.kernels.ternary_matmul.ops.quantize_and_pack`, all
    on one device, where the programs run.  ``width`` (accumulator digits)
    defaults to the minimal exact width for the observed activation range
    and is VALIDATED against it when passed — a too-narrow accumulator
    would silently wrap mod ``r^width``, so it raises instead.  ``stats``
    (an :class:`~repro_torch.core.ap.APStats`) collects the
    functional-simulator counters for the energy model.

    Execution routing: ``pool=`` streams the M*N rows through the array
    bank on the pool's device, K-tiling the MAC to the pool's column
    budget (``k_tile`` overrides the derived tile; it must fit);
    ``runtime=`` builds the tiled MAC as a
    :class:`repro_torch.apc.ProgramGraph` and schedules it over the
    runtime's (possibly device-spanning) bank — same digits, same counters,
    plus the graph makespan in ``runtime.last_report``; ``k_tile`` alone
    runs the tiled programs on the single-array executor (the
    tiled-vs-untiled oracle); ``mesh`` shards the M*N row axis of the
    untiled program.  ``kernel_variant`` picks the program-kernel schedule
    form; every variant is bit-exact.  Bit-exact vs
    :func:`~repro_torch.kernels.ternary_matmul.ref.ternary_matmul_ref` on
    every route because the integer accumulator converts to float32
    exactly and the final scale-multiply is the same float32 op.
    """
    from ... import apc
    from ...apc import trace

    xi, max_abs = _as_int_activations(x)
    m, kdim = xi.shape
    w_ter = unpack_ternary(packed, dtype=torch.int8)               # [K', N]
    kp, n = w_ter.shape
    if kdim > kp:
        raise ValueError(f"x K={kdim} exceeds packed K'={kp}")
    if kdim < kp:                        # pack-time padding rows: w == 0 there
        xi = F.pad(xi, (0, kp - kdim))
    req_width = apc.mac_acc_width(radix, kp, max_abs)
    if width is None:
        width = req_width
    elif width < req_width:
        raise ValueError(
            f"width={width} accumulator digits wrap mod {radix}**{width} "
            f"for activations with |x| <= {max_abs} at K={kp}: exact "
            f"signed decode needs width >= {req_width} "
            f"(mac_acc_width({radix}, {kp}, {max_abs}))")
    # row (m, n) <- (x[m, :], w[:, n]): M*N dot products, on the device
    x_rows, w_rows = apc.matmul_mac_rows(xi, w_ter)                # [M*N, K']
    route = ("runtime" if runtime is not None
             else "tiled" if pool is not None or k_tile is not None
             else "plain")
    with trace.span("ternary_matmul_ap", cat="matmul", m=m, k=kp, n=n,
                    width=width, route=route):
        acc = _run_routed(apc, x_rows, w_rows, radix, kp, width,
                          mesh=mesh, pool=pool, runtime=runtime,
                          k_tile=k_tile, stats=stats, block_rows=block_rows,
                          blocked=blocked, kernel_variant=kernel_variant)
    y = (acc.reshape(m, n).to(torch.float32)
         * scale.to(device=acc.device, dtype=torch.float32)[None, :])
    return y.to(device=x.device, dtype=x.dtype)


def _run_routed(apc, x_rows, w_rows, radix, kp, width, *, mesh, pool,
                runtime, k_tile, stats, block_rows, blocked,
                kernel_variant):
    if runtime is not None:
        if mesh is not None or pool is not None:
            raise ValueError("runtime= already carries a pool; pass one of "
                             "mesh=, pool=, or runtime=")
        if block_rows is not None:
            raise ValueError("block_rows only applies without runtime=; "
                             "the runtime pool's own rows govern blocks")
        runtime.check_knobs(kernel_variant=kernel_variant)
        max_cols = runtime.pool.cols
        kt = k_tile if k_tile is not None else default_k_tile(max_cols,
                                                              width)
        tiled = apc.compile_mac_tiled(radix, kp, width, kt,
                                      blocked=blocked, max_cols=max_cols)
        dev = runtime.pool.device
        (digits,) = runtime.run_mac_graph(
            [(x_rows.to(dev), w_rows.to(dev), tiled)], stats=stats)
        return apc.decode_signed_digits_jnp(digits, radix)
    if pool is not None or k_tile is not None:
        if mesh is not None:
            raise ValueError("the tiled/pool route does not mesh-shard; "
                             "pass one of mesh= or pool=/k_tile=")
        max_cols = pool.cols if pool is not None else None
        kt = k_tile if k_tile is not None else default_k_tile(pool.cols,
                                                              width)
        tiled = apc.compile_mac_tiled(radix, kp, width, kt,
                                      blocked=blocked, max_cols=max_cols)
        return apc.run_mac_tiled(x_rows, w_rows, tiled, pool=pool,
                                 stats=stats, block_rows=block_rows,
                                 kernel_variant=kernel_variant,
                                 device=x_rows.device)
    compiled = apc.compile_mac(radix, kp, width, blocked=blocked)
    arr = apc.encode_mac_rows_jnp(x_rows, w_rows, radix, width)
    out = apc.run(arr, compiled, stats=stats, mesh=mesh,
                  block_rows=block_rows, kernel_variant=kernel_variant,
                  device=arr.device)
    return apc.decode_mac_acc_jnp(out, radix, kp, width)           # [M*N]


def ap_matmul_cycle_counts(radix: int, K: int, width: int,
                           blocked: bool = False,
                           k_tile: int | None = None) -> dict[str, int]:
    """Schedule-static AP cycle counts for one (any-size) matmul tile.

    All M*N dot products run row-parallel, so these are the counts of the
    whole matmul, not per output — the write-cycle number the Table XI
    energy model charges at 2 ns / cycle.  With ``k_tile`` the counts are
    the exact sum of the per-tile partial-sum programs plus the ripple-add
    reduction chain (the tiled route's charges).
    """
    from ... import apc
    if k_tile is not None:
        tiled = apc.compile_mac_tiled(radix, K, width, k_tile,
                                      blocked=blocked)
        return {"compare_cycles": tiled.n_compare_cycles,
                "write_cycles": tiled.n_write_cycles,
                "steps": sum(p.n_steps for p in
                             tiled.programs + tiled.reduce_programs),
                "acc_width": width, "n_tiles": len(tiled.tiles)}
    compiled = apc.compile_mac(radix, K, width, blocked=blocked)
    return {"compare_cycles": compiled.n_compare_cycles,
            "write_cycles": compiled.n_write_cycles,
            "steps": compiled.n_steps, "acc_width": width}
