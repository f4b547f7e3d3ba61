"""The array pool, the part the K-tiled MAC needs: :func:`run_mac_tiled`.

The reference's :mod:`repro.apc.pool` models a bank of bounded-column
MvCAM arrays (``ArrayPool``: blocks dealt over arrays, wall cycles, resident
weight planes, the fault model).  The port so far carries only the
``pool=None`` route of :func:`run_mac_tiled`, which runs every tile and
reduction program on the single-array executor; ``pool=`` and ``resident=``
come with the array pool (ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import torch

from ..core.ap import APStats
from ..device import resolve_device
from . import trace
from .exec import execute
from .graph import CARRIED, fold_stage_input, mac_fold_plan
from .mac import TiledMac, decode_signed_digits_jnp, encode_mac_rows_jnp
from .mac import mac_layout
from .stats import accumulate


def run_mac_tiled(x, w_ter, tiled: TiledMac, *, pool=None,
                  stats: APStats | None = None,
                  block_rows: int | None = None,
                  kernel_variant: str | None = None, resident=None,
                  device=None) -> torch.Tensor:
    """ACC = sum_k w_k * x_k through the K-tiled programs.

    ``x`` [R, K] integers, ``w_ter`` [R, K] in {-1, 0, +1} (tensors or
    numpy, moved to ``device``; ``None`` = ``cuda:0``).  Each tile's
    partial-accumulator digit block is carried forward on the device into
    the ripple-add reduction rows; the return value is the signed int32 dot
    product per row, decoded on the device — the caller's conversion is the
    ONE host sync.  Every program runs on the single-array executor (the
    tiled-vs-untiled equivalence oracle): same digits, same counters as the
    untiled program.
    """
    if pool is not None:
        raise NotImplementedError(
            "pool= (the bounded array bank) is not ported yet: it comes "
            "with the array pool (ROADMAP queue 1, item 5)")
    if resident is not None:
        raise NotImplementedError(
            "resident= (weight-stationary planes) is not ported yet: it "
            "comes with the array pool (ROADMAP queue 1, item 5)")
    dev = resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    w_ter = torch.as_tensor(w_ter).to(dev)
    R, K = x.shape
    if K != tiled.K:
        raise ValueError(f"x has K={K}, tiled program compiled for "
                         f"K={tiled.K}")
    radix, width = tiled.radix, tiled.width

    def _run(arr, compiled, label):
        out, traced = execute(arr, compiled,
                              collect_stats=stats is not None,
                              block_rows=block_rows,
                              kernel_variant=kernel_variant, device=dev)
        if stats is not None:
            accumulate(stats, traced, compiled, n_rows=R, label=label)
        return out

    with trace.span("run_mac_tiled", cat="pool", rows=R, k=K,
                    tiles=len(tiled.tiles), k_tile=tiled.k_tile):
        partials: list[torch.Tensor] = []           # [R, width] digit blocks
        for t, ((lo, hi), prog) in enumerate(zip(tiled.tiles,
                                                 tiled.programs)):
            arr_t = encode_mac_rows_jnp(x[:, lo:hi], w_ter[:, lo:hi],
                                        radix, width)
            out = _run(arr_t, prog, f"tile{t}[{lo}:{hi}]")
            base = mac_layout(hi - lo, width)["acc_base"]
            partials.append(out[:, base:base + width])
        # sequential replay of the shared fold plan (graph.mac_fold_plan is
        # the single source of truth for which partials feed which
        # reduction)
        carried = partials[0]
        for j, stage in enumerate(mac_fold_plan(tiled)):
            group = [carried if p == CARRIED else partials[p]
                     for p in stage.parts]
            out = _run(fold_stage_input(group), stage.prog, f"reduce{j}")
            carried = out[:, stage.out_lo:stage.out_hi]
        return decode_signed_digits_jnp(carried, radix)
