"""Microcode IR for whole AP programs (the missing sequencer layer).

An AP *program* is a tuple of ops over the physical column space of one
MvCAM array:

- :class:`SetCol` — unconditional write of a constant digit into a column
  (:func:`ZeroCol` is the carry-clearing special case).
- :class:`ApplyLUT` — one LUT-schedule application (paper §IV-V) at a
  physical column mapping, optionally predicated by ``extra_key`` exact
  matches appended to every compare (the multiply driver's B_j == t gate).
- :class:`CompareWrite` — a raw masked compare + write pair; used for the
  multiply operand-repair sweeps, which the functional simulator charges as
  one compare + one write cycle but does NOT histogram (``count_mismatch``).
- :class:`ForDigit` — a structured loop over digit positions; body column
  references use :class:`RelCol` affine expressions of the loop variable and
  are resolved at lowering time (the schedule stays fully static).

Column references (``Col``) are plain ints (physical column), ``RelCol``
(loop-relative, ``scale * env[var] + offset``), or ``AffineCol`` (a sum of
scaled loop variables — the MAC generator's ``x_base + k*width + i``
addressing over nested :class:`ForDigit` loops).  ``digit("i") + base``,
``base + digit("i")``, ``digit("k") * width + digit("i")`` all work.

Programs are *data*: :mod:`repro_torch.apc.lower` flattens them into one static
:class:`~repro_torch.apc.lower.Step` schedule which the fused executor
(:mod:`repro_torch.apc.exec`) replays in a single kernel launch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from ..core.lut import LUT


@dataclass(frozen=True)
class RelCol:
    """Affine column expression ``scale * env[var] + offset``."""
    var: str
    offset: int = 0
    scale: int = 1

    def __add__(self, other) -> "Col":
        if isinstance(other, int):
            return RelCol(self.var, self.offset + other, self.scale)
        if isinstance(other, (RelCol, AffineCol)):
            return self._affine() + other
        return NotImplemented

    __radd__ = __add__

    def __mul__(self, k: int) -> "RelCol":
        return RelCol(self.var, self.offset * int(k), self.scale * int(k))

    __rmul__ = __mul__

    def _affine(self) -> "AffineCol":
        return AffineCol(((self.var, self.scale),), self.offset)

    def resolve(self, env: dict[str, int]) -> int:
        if self.var not in env:
            raise KeyError(f"unbound loop variable {self.var!r}")
        return self.scale * env[self.var] + self.offset


@dataclass(frozen=True)
class AffineCol:
    """Multi-variable affine column ``sum(scale * env[var]) + offset`` —
    block addressing over nested :class:`ForDigit` loops, e.g. the MAC
    generator's ``x_base + k * width + i``."""
    terms: tuple[tuple[str, int], ...]       # (var, scale)
    offset: int = 0

    def __add__(self, other) -> "AffineCol":
        if isinstance(other, int):
            return AffineCol(self.terms, self.offset + other)
        if isinstance(other, RelCol):
            other = other._affine()
        if isinstance(other, AffineCol):
            return AffineCol(self.terms + other.terms,
                             self.offset + other.offset)
        return NotImplemented

    __radd__ = __add__

    def resolve(self, env: dict[str, int]) -> int:
        acc = self.offset
        for var, scale in self.terms:
            if var not in env:
                raise KeyError(f"unbound loop variable {var!r}")
            acc += scale * env[var]
        return acc


Col = Union[int, RelCol, AffineCol]


def digit(var: str = "i") -> RelCol:
    """The loop variable of an enclosing :class:`ForDigit` as a column expr."""
    return RelCol(var, 0)


def resolve_col(col: Col, env: dict[str, int]) -> int:
    c = col.resolve(env) if isinstance(col, (RelCol, AffineCol)) else int(col)
    if c < 0:
        raise ValueError(f"column expression resolved to negative column {c}")
    return c


@dataclass(frozen=True)
class SetCol:
    """Unconditional write ``col := val`` (one write cycle, no compare)."""
    col: Col
    val: int = 0


def ZeroCol(col: Col) -> SetCol:
    """Clear a carry/borrow/scratch column (paper drivers zero C first)."""
    return SetCol(col, 0)


@dataclass(frozen=True)
class ApplyLUT:
    """One LUT application: logical LUT column ``i`` lives at
    ``col_map[i]``; every compare key is extended by the ``extra_key``
    (col, value) exact matches."""
    lut: LUT
    col_map: tuple[Col, ...]
    extra_key: tuple[tuple[Col, int], ...] = ()

    def __post_init__(self):
        if len(self.col_map) != self.lut.width:
            raise ValueError(
                f"col_map has {len(self.col_map)} entries for a width-"
                f"{self.lut.width} LUT {self.lut.fn_name}")


@dataclass(frozen=True)
class CompareWrite:
    """Raw compare/write microinstruction (repair sweeps, fix-ups).

    ``count_mismatch`` mirrors the functional simulator: driver-level repair
    compares increment the compare-cycle counter but are excluded from the
    energy model's mismatch histogram.
    """
    compare_cols: tuple[Col, ...]
    key: tuple[int, ...]
    write_cols: tuple[Col, ...]
    write_vals: tuple[int, ...]
    count_mismatch: bool = False


@dataclass(frozen=True)
class ForDigit:
    """Static loop ``for var in range(start, stop)`` over digit positions."""
    var: str
    start: int
    stop: int
    body: tuple["Op", ...]


Op = Union[SetCol, ApplyLUT, CompareWrite, ForDigit]
Program = tuple[Op, ...]
