"""AP-backed model layers, the part the graph runtime needs.

The reference's :mod:`repro.apc.layers` serves a model's ternary
projections through the graph runtime (``APLinear``, ``APServeContext``,
``APSink``, ``ap_moe_dispatch``).  Of it this module holds only
:data:`N_MASKED_MAC`, which :meth:`repro_torch.apc.runtime.Runtime.run_graph`
uses to price its power tracks; the rest comes with AP-backed serving
(ROADMAP queue 1, item 9), in this file.
"""
from __future__ import annotations

__all__ = ["N_MASKED_MAC"]

# compare-key mask width of the MAC sweeps: 3 LUT columns + 1 weight
# predicate column (what the Table XI matchline model charges per compare)
N_MASKED_MAC = 4
