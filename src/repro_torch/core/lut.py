"""LUT schedule datatypes + validity checking (paper §IV.A properties).

A LUT schedule is an ordered list of passes; each pass compares one full input
vector (the compare key spans all ``width`` operand columns) and writes
``write_vals`` into ``write_cols`` of the matching rows.  Consecutive passes
sharing one write action may be fused into a *block* (paper §V): all compares
of a block run before its single write cycle (per-row DFF latches "matched
anywhere in this block").
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .truth_tables import InPlaceFunction, Vec


@dataclass(frozen=True)
class Pass:
    key: Vec                       # full input vector to compare against
    write_cols: tuple[int, ...]
    write_vals: tuple[int, ...]
    pass_num: int                  # 1-based, as in the paper's tables
    group_num: int | None = None   # blocked approach only

    @property
    def output(self) -> dict[int, int]:
        return dict(zip(self.write_cols, self.write_vals))


@dataclass(frozen=True)
class Block:
    """Passes sharing one write action; one write cycle for the whole block."""
    write_cols: tuple[int, ...]
    write_vals: tuple[int, ...]
    keys: tuple[Vec, ...]


@dataclass(eq=False)           # identity eq/hash: schedules are interned via
class LUT:                     # the cached builders, and IR nodes hold refs
    fn_name: str
    radix: int
    width: int
    passes: list[Pass]
    blocked: bool                  # True => block structure is semantic
    no_action_states: list[Vec] = field(default_factory=list)

    @property
    def n_passes(self) -> int:
        return len(self.passes)

    @property
    def blocks(self) -> list[Block]:
        """Group consecutive passes with identical write action."""
        blocks: list[Block] = []
        cur: list[Pass] = []
        for p in self.passes:
            if cur and (p.write_cols, p.write_vals) == (
                    cur[0].write_cols, cur[0].write_vals) and self.blocked:
                cur.append(p)
            else:
                if cur:
                    blocks.append(Block(cur[0].write_cols, cur[0].write_vals,
                                        tuple(q.key for q in cur)))
                cur = [p]
        if cur:
            blocks.append(Block(cur[0].write_cols, cur[0].write_vals,
                                tuple(q.key for q in cur)))
        return blocks

    @property
    def n_write_cycles(self) -> int:
        return len(self.blocks)

    @property
    def n_compare_cycles(self) -> int:
        return len(self.passes)

    # -- semantics ----------------------------------------------------------
    def apply_row(self, row: Vec) -> Vec:
        """Replay the schedule on a single row value (python oracle).

        Non-blocked: compare/write per pass, sequentially.
        Blocked: per block, all compares test the value the row had at block
        entry; the write lands at block end (DFF semantics).
        """
        row = tuple(row)
        for blk in self.blocks:
            matched = row in blk.keys
            if matched:
                new = list(row)
                for c, v in zip(blk.write_cols, blk.write_vals):
                    new[c] = v
                row = tuple(new)
        return row

    def validate(self, fn: InPlaceFunction) -> None:
        """Check full functional correctness + the §IV.A ordering properties."""
        # (1) replay every possible stored value and compare with f
        for x in fn.states:
            got = self.apply_row(x)
            want_nominal = fn(x)
            node_out = self._effective_output(x)
            if got != node_out:
                raise AssertionError(
                    f"{self.fn_name}: replay({x}) = {got}, schedule expects "
                    f"{node_out}")
            # the written (non-dummy) columns must carry the true result
            for c in fn.write_cols:
                if got[c] != want_nominal[c]:
                    raise AssertionError(
                        f"{self.fn_name}: col {c} of replay({x}) = {got[c]} "
                        f"!= f(x)[{c}] = {want_nominal[c]}")
        # (2) ordering property: a pass writing value y (restricted to its
        # write cols) must come strictly after the pass whose key is y —
        # unless y is a noAction state.
        order = {p.key: i for i, p in enumerate(self.passes)}
        na = set(self.no_action_states)
        for i, p in enumerate(self.passes):
            y = list(p.key)
            for c, v in zip(p.write_cols, p.write_vals):
                y[c] = v
            y = tuple(y)
            if y in na:
                continue
            if y not in order:
                raise AssertionError(
                    f"{self.fn_name}: pass {p.pass_num} writes {y} which has "
                    f"no pass and is not noAction")
            if order[y] >= i:
                raise AssertionError(
                    f"{self.fn_name}: pass {p.pass_num} (key {p.key}) writes "
                    f"{y} whose own pass comes later — domino hazard")

    def _effective_output(self, x: Vec) -> Vec:
        """Output including any cycle-breaking dummy digits."""
        for p in self.passes:
            if p.key == tuple(x):
                y = list(x)
                for c, v in zip(p.write_cols, p.write_vals):
                    y[c] = v
                return tuple(y)
        return tuple(x)            # noAction
