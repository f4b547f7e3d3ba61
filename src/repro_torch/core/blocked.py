"""Blocked LUT generation — paper Algorithms 2, 3, 4 (§V).

BFS-like traversal with a dynamic ``grpLvl`` (level × group) occupancy table.
A *group* is the set of action states sharing one write action — keyed by the
parent's adjusted ``outVal(writeDim)`` (Algorithm 2 line 5), i.e. the written
digit values together with the write dimension.  Only states at the top level
(all ancestors processed) may be issued; a group fully resident at the top
level is issued as one block (k compares + ONE write cycle).  When no group
is fully available, the group with the most top-level states is split: its
lower-level members move to a fresh group number, and the top-level part is
issued (Algorithm 3).  Issuing a block elevates the members' subtrees by one
level (Algorithm 4).
"""
from __future__ import annotations

import functools
from collections import defaultdict

from .lut import LUT, Pass
from .state_diagram import CycleBreakError, Node, StateDiagram
from .truth_tables import InPlaceFunction


def initial_grp_lvl(sd: StateDiagram) -> tuple[dict, dict]:
    """Algorithm 2: populate grpLvl[level][group] and assign node.grp_num.

    Group numbers follow the paper's adjusted outVal, except that widened
    (cycle-broken) writes also fold in *which* columns are written — two
    write actions are interchangeable only if they write the same values to
    the same columns.  (For the TFA this matches the paper exactly: the only
    widened write, W020, is already unique by dimension.)
    """
    grp_of: dict[tuple, int] = {}
    grp_lvl: dict[int, defaultdict] = {}

    def group_key(n: Node) -> tuple:
        return (n.write_cols, n.write_vals)

    next_g = [0]

    def group_num(n: Node) -> int:
        k = group_key(n)
        if k not in grp_of:
            # paper numbering: parent.outVal(writeDim) + sum_{i<dim} n^i;
            # stored for reference, uniquified via the key above.
            grp_of[k] = n.out_val(sd.radix)
        return grp_of[k]

    levels = defaultdict(lambda: defaultdict(int))
    for node in sd.nodes.values():
        if node.no_action:
            continue
        g = group_num(node)
        node.grp_num = g
        levels[node.level][g] += 1
    next_g[0] = (max((g for lv in levels.values() for g in lv), default=0) + 1)
    return levels, {"next_g": next_g[0]}


def build_lut_blocked(fn: InPlaceFunction,
                      diagram: StateDiagram | None = None) -> LUT:
    if diagram is None:
        return _build_lut_blocked_cached(fn)
    return _build_lut_blocked(fn, diagram)


@functools.lru_cache(maxsize=512)
def _build_lut_blocked_cached(fn: InPlaceFunction) -> LUT:
    return _build_lut_blocked(fn, None)


def _build_lut_blocked(fn: InPlaceFunction,
                       diagram: StateDiagram | None = None) -> LUT:
    sd = diagram or StateDiagram(fn)
    # fresh dynamic levels (diagram may be shared with the non-blocked build)
    for root in sd.roots:
        stack = [(root, 0)]
        while stack:
            n, d = stack.pop()
            n.level = d
            for ch in n.children:
                stack.append((ch, d + 1))

    grp_lvl, meta = initial_grp_lvl(sd)
    next_g = meta["next_g"]
    action = sd.action_nodes
    max_level = max((n.level for n in action), default=0)

    passes: list[Pass] = []
    p = 0
    top = 1

    def group_members(g: int) -> list[Node]:
        return [n for n in action if n.grp_num == g and n.pass_num is None]

    def lower_count(g: int) -> int:
        return sum(grp_lvl[l][g] for l in range(top + 1, max_level + 1))

    def update_lut(g_tgt: int) -> None:
        """Algorithm 4: emit passes for group g_tgt, elevate subtrees."""
        nonlocal p
        members = [n for n in group_members(g_tgt) if n.level == top]
        for j in sorted(members, key=lambda n: n.vec):
            p += 1
            j.pass_num = p
            passes.append(Pass(key=j.vec, write_cols=j.write_cols,
                               write_vals=j.write_vals, pass_num=p,
                               group_num=g_tgt))
            for v in sd.descendants(j):
                grp_lvl[v.level - 1][v.grp_num] += 1
                grp_lvl[v.level][v.grp_num] -= 1
                v.level -= 1
        grp_lvl[top][g_tgt] = 0

    # Algorithm 3: BUILDLUTBLOCKED
    remaining = len(action)
    while remaining > 0:
        found = False
        for g in sorted(set(n.grp_num for n in action if n.pass_num is None)):
            cond1 = grp_lvl[top][g] > 0
            cond2 = lower_count(g) == 0
            if cond1 and cond2:
                update_lut(g)
                found = True
        if not found:
            # split the group with the most top-level states
            g_tgt = max((g for g in grp_lvl[top] if grp_lvl[top][g] > 0),
                        key=lambda g: grp_lvl[top][g])
            G = next_g
            next_g += 1
            for l in range(top + 1, max_level + 1):
                grp_lvl[l][G] = grp_lvl[l][g_tgt]
                grp_lvl[l][g_tgt] = 0
            for j in action:
                if j.grp_num == g_tgt and j.level > top and j.pass_num is None:
                    j.grp_num = G
            update_lut(g_tgt)
        remaining = sum(1 for n in action if n.pass_num is None)

    lut = LUT(fn_name=fn.name, radix=fn.radix, width=fn.width, passes=passes,
              blocked=True,
              no_action_states=[r.vec for r in sd.roots])
    return lut


# ---------------------------------------------------------------------------
# Beyond-paper: cycle-break choice exploration
# ---------------------------------------------------------------------------

def _raw_cycles(fn: InPlaceFunction) -> list[list]:
    """Non-trivial cycles of the unmodified functional graph."""
    cycles, seen = [], set()
    for start in fn.states:
        if start in seen:
            continue
        path, pos = [], {}
        cur = start
        while cur not in seen and cur not in pos:
            pos[cur] = len(path)
            path.append(cur)
            cur = fn(cur)
            if cur == path[-1]:        # noAction self-loop
                break
        if cur in pos and cur != path[-1]:
            cyc = path[pos[cur]:]
            if len(cyc) >= 2:
                cycles.append(cyc)
        seen.update(path)
    return cycles


def best_blocked_lut(fn: InPlaceFunction, max_combos: int = 128
                     ) -> tuple[LUT, dict]:
    """Search over cycle-break redirect choices for the schedule with the
    fewest write cycles (beyond the paper, which fixes one redirect by hand).

    On the paper's own TFA this finds an 8-write-block schedule vs the
    paper's 9 (Table X): redirecting ``120 -> 201`` instead of ``101 -> 020``
    lets the two W01/W11 groups merge.  Returns (lut, breaks_used).
    """
    import itertools as it

    cycles = _raw_cycles(fn)
    if not cycles:
        lut = build_lut_blocked(fn)
        return lut, {}

    probe = StateDiagram(fn)           # for candidate enumeration only
    per_cycle_options = []
    for cyc in cycles:
        opts = []
        for x in cyc:
            for y2 in probe.redirect_candidates(x):
                opts.append((x, y2))
        per_cycle_options.append(opts)

    best: tuple[LUT, dict] | None = None
    n = 0
    for combo in it.product(*per_cycle_options):
        if n >= max_combos:
            break
        n += 1
        pins = dict(combo)
        if len(pins) != len(combo):
            continue                   # same state pinned twice
        try:
            sd = StateDiagram(fn, break_choices=pins)
            lut = build_lut_blocked(fn, diagram=sd)
            lut.validate(fn)
        except (CycleBreakError, AssertionError):
            continue
        if best is None or lut.n_write_cycles < best[0].n_write_cycles:
            best = (lut, dict(sd.breaks_used))
    if best is None:                   # fall back to default greedy
        lut = build_lut_blocked(fn)
        return lut, {}
    return best
