"""Non-blocked LUT generation — paper Algorithm 1.

Depth-first preorder over each tree of the (cycle-free) state diagram,
starting from the noAction roots: a node's pass is assigned before any of its
children's, which guarantees the §IV.A ordering property (the pass in which a
vector appears as an input runs before any pass that writes that vector as an
output).  Each pass costs one compare cycle + one write cycle.
"""
from __future__ import annotations

import functools

from .lut import LUT, Pass
from .state_diagram import StateDiagram
from .truth_tables import InPlaceFunction


def build_lut_nonblocked(fn: InPlaceFunction,
                         diagram: StateDiagram | None = None) -> LUT:
    if diagram is None:
        # schedules are deterministic in fn, so equal functions (value-based
        # hash) share one build — the test suite re-requests the same handful
        # of adders hundreds of times
        return _build_lut_nonblocked_cached(fn)
    return _build_lut_nonblocked(fn, diagram)


@functools.lru_cache(maxsize=512)
def _build_lut_nonblocked_cached(fn: InPlaceFunction) -> LUT:
    return _build_lut_nonblocked(fn, None)


def _build_lut_nonblocked(fn: InPlaceFunction,
                          diagram: StateDiagram | None = None) -> LUT:
    sd = diagram or StateDiagram(fn)
    passes: list[Pass] = []
    p = 0

    def build(node):                      # procedure BUILDLUT(state j)
        nonlocal p
        if not node.no_action:
            p += 1
            node.pass_num = p
            passes.append(Pass(key=node.vec,
                               write_cols=node.write_cols,
                               write_vals=node.write_vals,
                               pass_num=p))
        for child in sorted(node.children, key=lambda c: c.vec):
            build(child)

    # Paper: visit trees right-to-left in the figure; layout order is
    # presentation-only, so we use a deterministic key (root vector).
    for root in sorted(sd.roots, key=lambda r: r.vec):
        build(root)

    lut = LUT(fn_name=fn.name, radix=fn.radix, width=fn.width, passes=passes,
              blocked=False,
              no_action_states=[r.vec for r in sd.roots])
    return lut
