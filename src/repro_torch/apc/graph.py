"""Program graphs, the fold part: the K-tiled MAC's reduction chain.

The reference's :mod:`repro.apc.graph` holds the dependency DAGs of
compiled-program launches and their occupancy model; of it the port so far
carries only the fold plan, which :func:`repro_torch.apc.pool.run_mac_tiled`
replays.  The graph itself (``ProgramGraph``, ``graph_makespan``,
``add_mac_tiled``, ``coalesce_graphs``) comes with the graph runtime.

- :func:`mac_fold_plan` — the K-tiled MAC (:class:`~repro_torch.apc.mac.
  TiledMac`) reduction as explicit stages: which tile partials (or the
  previous stage's result, :data:`CARRIED`) each ripple-add reduction
  program folds.  It is THE shared description of the reduction chain, so
  cycle accounting lives here, in one place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .lower import CompiledProgram
from .mac import TiledMac

CARRIED = -1          # fold-plan sentinel: previous stage's folded result


class FoldStage(NamedTuple):
    """One ripple-add reduction stage of a K-tiled MAC fold.

    ``parts`` are indices into the tile-partial list (:data:`CARRIED` means
    the previous stage's result rides along as the first operand);
    ``out_lo:out_hi`` is the digit-column slice of the stage's output row
    holding the folded sum.
    """
    prog: CompiledProgram
    parts: tuple[int, ...]
    out_lo: int
    out_hi: int


def mac_fold_plan(tiled: TiledMac) -> tuple[FoldStage, ...]:
    """The reduction chain of a :class:`TiledMac` as explicit fold stages.

    Single source of truth for which partials feed which reduction program
    (and hence for tiled cycle accounting): ``run_mac_tiled`` replays these
    stages sequentially.
    """
    stages: list[FoldStage] = []
    width = tiled.width
    nxt = 0
    for j, (g, prog) in enumerate(zip(tiled.reduce_groups,
                                      tiled.reduce_programs)):
        fresh = g if j == 0 else g - 1       # later stages carry one partial
        parts = tuple(range(nxt, nxt + fresh))
        if j:
            parts = (CARRIED,) + parts
        nxt += fresh
        stages.append(FoldStage(prog, parts, (g - 1) * width, g * width))
    return tuple(stages)


def fold_stage_input(group: list[torch.Tensor]) -> torch.Tensor:
    """Pack a reduction stage's row: partial digit blocks side by side plus
    the zeroed carry column."""
    rows = group[0].shape[0]
    return torch.cat(
        [g.to(torch.int8) for g in group]
        + [torch.zeros((rows, 1), dtype=torch.int8,
                       device=group[0].device)], dim=1)
