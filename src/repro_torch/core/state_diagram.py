"""State-diagram representation of an in-place truth table (paper §IV.A-B).

Every state (stored vector) has exactly one outgoing edge — the application of
the function — so the diagram is a functional graph: each weakly-connected
component contains exactly one cycle, and ``noAction`` fixpoints are
self-loops.  Valid in-place LUT schedules exist iff the diagram (after cycle
breaking) is a forest of trees rooted at ``noAction`` states, processed
parent-before-child.

Cycle breaking (paper §IV.B): for a cycle edge ``x -> y`` we search for an
alternate output ``y'`` that agrees with ``y`` on the written columns but
differs on some otherwise-untouched column(s) (a "dummy extra written digit",
widening ``writeDim``), such that ``x`` is not reachable from ``y'`` — this
redirects the edge backwards and breaks the cycle.  The paper's TFA example
redirects ``101 -> 120`` to ``101 -> 020`` via a 3-trit write.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from .truth_tables import InPlaceFunction, Vec


@dataclass
class Node:
    """A state with the attributes of paper Table VIII."""
    vec: Vec
    out: Vec                      # effective output (post cycle-breaking)
    no_action: bool
    write_cols: tuple[int, ...]   # effective written columns for this entry
    write_vals: tuple[int, ...]   # values written into write_cols
    widened: bool = False         # True if cycle-breaking widened the write
    parent: "Node | None" = None  # node holding vec == out
    children: list["Node"] = field(default_factory=list)
    level: int = 0                # depth from root (root=0); dynamic in blocked
    grp_num: int | None = None
    pass_num: int | None = None

    @property
    def write_dim(self) -> int:
        return len(self.write_cols)

    def out_val(self, radix: int) -> int:
        """Paper's adjusted outVal(writeDim): n-ary→decimal of the written
        digits plus the sum_{i<writeDim} n^i offset that separates write
        dimensions (Algorithm 2 line 5)."""
        val = 0
        for v in self.write_vals:
            val = val * radix + v
        return val + sum(radix ** i for i in range(self.write_dim))

    def __repr__(self):
        return (f"Node({''.join(map(str, self.vec))}->"
                f"{''.join(map(str, self.out))}"
                f"{' noAction' if self.no_action else ''})")


class CycleBreakError(ValueError):
    pass


class StateDiagram:
    """Cycle-free state diagram of an :class:`InPlaceFunction`.

    ``break_choices`` optionally pins the cycle-break redirects as a mapping
    {input_state: alternate_output}; states not listed fall back to the
    default greedy (sorted states, noAction targets first), which reproduces
    the paper's TFA choice ``101 -> 020``.  Alternate redirects can reduce the
    blocked write-cycle count — see :func:`repro_torch.core.blocked.best_blocked_lut`.
    """

    def __init__(self, fn: InPlaceFunction,
                 break_choices: dict[Vec, Vec] | None = None):
        self.fn = fn
        self.radix = fn.radix
        self.width = fn.width
        self.nodes: dict[Vec, Node] = {}
        self.break_choices = dict(break_choices or {})
        self.breaks_used: dict[Vec, Vec] = {}
        self._build()

    # -- construction -----------------------------------------------------
    def _build(self) -> None:
        fn = self.fn
        for x in fn.states:
            y = fn(x)
            diff = tuple(c for c in range(fn.width) if x[c] != y[c])
            # The nominal write covers all declared write columns; the write
            # ACTION values are the output restricted to them.
            wc = tuple(fn.write_cols)
            self.nodes[x] = Node(
                vec=x, out=y, no_action=(y == x),
                write_cols=wc, write_vals=tuple(y[c] for c in wc))
            assert set(diff) <= set(wc)
        self._break_cycles()
        self._link()

    def _succ(self, x: Vec) -> Vec:
        return self.nodes[x].out

    def _reachable(self, src: Vec, dst: Vec) -> bool:
        """Is dst reachable from src following current out-edges?"""
        seen = set()
        cur = src
        while cur not in seen:
            if cur == dst:
                return True
            seen.add(cur)
            nxt = self._succ(cur)
            if nxt == cur:
                return False
            cur = nxt
        return False

    def _find_cycle(self) -> list[Vec] | None:
        """Return one non-trivial cycle (len >= 2) if any."""
        color: dict[Vec, int] = {}
        for start in self.nodes:
            if color.get(start):
                continue
            path = []
            cur = start
            while True:
                c = color.get(cur, 0)
                if c == 1:                      # found a node on current path
                    i = path.index(cur)
                    cyc = path[i:]
                    if len(cyc) >= 2:
                        return cyc
                    break
                if c == 2:
                    break
                color[cur] = 1
                path.append(cur)
                nxt = self._succ(cur)
                if nxt == cur:                  # noAction self-loop: fine
                    break
                cur = nxt
            for v in path:
                color[v] = 2
        return None

    def redirect_candidates(self, x: Vec) -> list[Vec]:
        """Valid alternate outputs for state x: keep the written digits,
        vary only free (non-write, non-protected) columns."""
        fn = self.fn
        free_cols = [c for c in range(fn.width)
                     if c not in fn.write_cols and c not in fn.protected_cols]
        y = self.fn(x)
        out = []
        for combo in itertools.product(range(self.radix),
                                       repeat=len(free_cols)):
            y2 = list(y)
            for c, v in zip(free_cols, combo):
                y2[c] = v
            y2 = tuple(y2)
            if y2 != y:
                out.append(y2)
        return out

    def _redirect(self, x: Vec, y2: Vec) -> None:
        fn = self.fn
        node = self.nodes[x]
        free_cols = [c for c in range(fn.width)
                     if c not in fn.write_cols and c not in fn.protected_cols]
        extra = tuple(c for c in free_cols if y2[c] != x[c])
        wc = tuple(sorted(set(fn.write_cols) | set(extra)))
        node.out = y2
        node.write_cols = wc
        node.write_vals = tuple(y2[c] for c in wc)
        node.widened = True
        self.breaks_used[x] = y2

    def _break_cycles(self) -> None:
        fn = self.fn
        # pinned redirects first (exploration mode)
        for x, y2 in self.break_choices.items():
            if y2 not in self.redirect_candidates(x):
                raise CycleBreakError(
                    f"{fn.name}: pinned redirect {x}->{y2} is not a valid "
                    f"alternate output")
            self._redirect(x, y2)
        while (cycle := self._find_cycle()) is not None:
            broken = False
            # Try edges in sorted-state order; redirect x -> y to x -> y'.
            for x in sorted(cycle):
                candidates = self.redirect_candidates(x)
                # Prefer redirecting to noAction roots (the paper picks
                # '020' for TFA input '101'), deterministically.
                candidates.sort(key=lambda z: (not self.nodes[z].no_action, z))
                for y2 in candidates:
                    if self._reachable(y2, x):
                        continue               # would still (or newly) cycle
                    self._redirect(x, y2)
                    broken = True
                    break
                if broken:
                    break
            if not broken:
                raise CycleBreakError(
                    f"{fn.name}: cannot break cycle {cycle} — no free column "
                    f"redirect exists (protected={fn.protected_cols})")

    def _link(self) -> None:
        for node in self.nodes.values():
            if node.no_action:
                continue
            parent = self.nodes[node.out]
            node.parent = parent
            parent.children.append(node)
        # levels (depth from root); roots are noAction states
        for root in self.roots:
            stack = [(root, 0)]
            while stack:
                n, d = stack.pop()
                n.level = d
                for ch in n.children:
                    stack.append((ch, d + 1))
        # sanity: every action node must be in some root's tree
        n_in_trees = sum(self._tree_size(r) for r in self.roots)
        if n_in_trees != len(self.nodes):
            raise CycleBreakError(
                f"{self.fn.name}: diagram is not a forest after cycle "
                f"breaking ({n_in_trees} of {len(self.nodes)} reachable)")

    def _tree_size(self, root: Node) -> int:
        total = 0
        stack = [root]
        while stack:
            n = stack.pop()
            total += 1
            stack.extend(n.children)
        return total

    # -- queries -----------------------------------------------------------
    @property
    def roots(self) -> list[Node]:
        return [n for n in self.nodes.values() if n.no_action]

    @property
    def action_nodes(self) -> list[Node]:
        return [n for n in self.nodes.values() if not n.no_action]

    def descendants(self, node: Node) -> list[Node]:
        out = []
        stack = list(node.children)
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children)
        return out

    def validate_acyclic(self) -> None:
        if self._find_cycle() is not None:
            raise CycleBreakError("state diagram has a residual cycle")
