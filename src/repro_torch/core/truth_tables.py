"""In-place digit-function truth tables for radix-n AP arithmetic (paper §IV).

An in-place function over a ``width``-digit state vector overwrites a fixed
subset of columns (``write_cols``) with the function output while leaving the
remaining columns untouched — e.g. the ternary full adder maps
``(A, B, Cin) -> (A, S, Cout)`` writing columns (B, C).

These tables are the input to the state-diagram LUT compiler
(:mod:`repro_torch.core.state_diagram`).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Mapping

Vec = tuple[int, ...]


@dataclass(frozen=True)
class InPlaceFunction:
    """A total in-place digit function f: {0..r-1}^w -> {0..r-1}^w."""

    name: str
    radix: int
    width: int
    write_cols: tuple[int, ...]          # columns the LUT output overwrites
    table: Mapping[Vec, Vec] = field(repr=False)
    protected_cols: tuple[int, ...] = () # columns cycle-breaking must NOT touch

    def __post_init__(self):
        n_states = self.radix ** self.width
        if len(self.table) != n_states:
            raise ValueError(
                f"{self.name}: table has {len(self.table)} entries, "
                f"expected {n_states}")
        wset = set(self.write_cols)
        for x, y in self.table.items():
            if len(x) != self.width or len(y) != self.width:
                raise ValueError(f"{self.name}: bad vector width at {x}->{y}")
            for c in range(self.width):
                if c not in wset and x[c] != y[c]:
                    raise ValueError(
                        f"{self.name}: entry {x}->{y} modifies non-write col {c}")
        bad = wset & set(self.protected_cols)
        if bad:
            raise ValueError(f"{self.name}: cols {bad} both written and protected")

    @property
    def states(self) -> list[Vec]:
        return list(self.table.keys())

    def __call__(self, x: Vec) -> Vec:
        return self.table[tuple(x)]

    def __hash__(self) -> int:
        # value-based hash (the auto-generated one chokes on the table dict);
        # lets equal functions share one cached LUT build (lru_cache key).
        memo = self.__dict__.get("_hash")
        if memo is None:
            memo = hash((self.name, self.radix, self.width, self.write_cols,
                         self.protected_cols,
                         tuple(sorted(self.table.items()))))
            object.__setattr__(self, "_hash", memo)
        return memo


def from_callable(name: str, radix: int, width: int,
                  write_cols: tuple[int, ...],
                  fn: Callable[[Vec], Vec],
                  protected_cols: tuple[int, ...] = ()) -> InPlaceFunction:
    table = {}
    for x in itertools.product(range(radix), repeat=width):
        table[x] = tuple(fn(x))
    return InPlaceFunction(name, radix, width, tuple(write_cols), table,
                           tuple(protected_cols))


# ---------------------------------------------------------------------------
# Arithmetic functions
# ---------------------------------------------------------------------------

def full_adder(radix: int) -> InPlaceFunction:
    """(A, B, Cin) -> (A, S, Cout): the paper's TFA for radix=3 (Table VII
    inputs/outputs), the binary AP adder of [6] for radix=2 (Table VI)."""
    def fn(x):
        a, b, c = x
        s = a + b + c
        return (a, s % radix, s // radix)
    return from_callable(f"full_adder_r{radix}", radix, 3, (1, 2), fn)


def full_subtractor(radix: int) -> InPlaceFunction:
    """(A, B, Bin) -> (A, D, Bout) computing B := (A - B - Bin), borrow out.

    Orientation: result D = A - B - Bin (mod r) written over B, so a p-digit
    in-place subtract leaves A intact and B holding A - B.
    """
    def fn(x):
        a, b, c = x
        d = a - b - c
        return (a, d % radix, 1 if d < 0 else 0)
    return from_callable(f"full_subtractor_r{radix}", radix, 3, (1, 2), fn)


def rev_subtractor(radix: int) -> InPlaceFunction:
    """(X, A, Bin) -> (X, D, Bout) computing A := (A - X - Bin), borrow out.

    The mirror of :func:`full_subtractor`: the difference lands on the
    *second* operand column, so an accumulator column can be decremented in
    place by a stationary operand — the MAC driver's ``ACC -= X_k`` sweep
    (predicated on a weight digit of -1).
    """
    def fn(x):
        a, b, c = x
        d = b - a - c
        return (a, d % radix, 1 if d < 0 else 0)
    return from_callable(f"rev_subtractor_r{radix}", radix, 3, (1, 2), fn)


def half_adder(radix: int) -> InPlaceFunction:
    """(B, C) -> (S, Cout) with S = (B + C) % r — used to fold a carry in."""
    def fn(x):
        b, c = x
        s = b + c
        return (s % radix, s // radix)
    return from_callable(f"half_adder_r{radix}", radix, 2, (0, 1), fn)


def increment(radix: int) -> InPlaceFunction:
    """(B, C) -> (B+C mod r, carry) — alias of half_adder kept for clarity."""
    return half_adder(radix)


# ---------------------------------------------------------------------------
# Logic functions (2-input in-place: (A, B) -> (A, f(A,B)))
# ---------------------------------------------------------------------------

def _logic2(name: str, radix: int, op: Callable[[int, int], int]) -> InPlaceFunction:
    def fn(x):
        a, b = x
        return (a, op(a, b) % radix)
    return from_callable(f"{name}_r{radix}", radix, 2, (1,), fn)


def tmin(radix: int) -> InPlaceFunction:   # multi-valued AND
    return _logic2("min", radix, min)


def tmax(radix: int) -> InPlaceFunction:   # multi-valued OR
    return _logic2("max", radix, max)


def modsum(radix: int) -> InPlaceFunction:  # multi-valued XOR
    return _logic2("modsum", radix, lambda a, b: a + b)


def tnor(radix: int) -> InPlaceFunction:   # multi-valued NOR: (r-1) - max
    return _logic2("nor", radix, lambda a, b: (radix - 1) - max(a, b))


def tnand(radix: int) -> InPlaceFunction:  # multi-valued NAND: (r-1) - min
    return _logic2("nand", radix, lambda a, b: (radix - 1) - min(a, b))


def tnot(radix: int) -> InPlaceFunction:
    """STI-style inverter, 1-column in place.

    NOTE: provably NOT implementable as an in-place AP LUT — x -> (r-1)-x is
    an involution, so every non-fixpoint lies on a 2-cycle and there is no
    free column for the paper's §IV.B dummy-write break.  StateDiagram raises
    CycleBreakError; use :func:`tnot_copy` (2-column) instead."""
    def fn(x):
        return ((radix - 1) - x[0],)
    return from_callable(f"not_r{radix}", radix, 1, (0,), fn)


def tnot_copy(radix: int) -> InPlaceFunction:
    """(A, B) -> (A, (r-1)-A): inverter into a destination column."""
    def fn(x):
        return (x[0], (radix - 1) - x[0])
    return from_callable(f"not_copy_r{radix}", radix, 2, (1,), fn)


REGISTRY: dict[str, Callable[[int], InPlaceFunction]] = {
    "full_adder": full_adder,
    "full_subtractor": full_subtractor,
    "rev_subtractor": rev_subtractor,
    "half_adder": half_adder,
    "min": tmin,
    "max": tmax,
    "modsum": modsum,
    "nor": tnor,
    "nand": tnand,
    "not": tnot,
    "not_copy": tnot_copy,
}
