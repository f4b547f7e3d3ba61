"""Core paper contribution: MvAP LUT compilation + functional simulation.

Pipeline: truth table (:mod:`truth_tables`) -> state diagram with cycle
breaking (:mod:`state_diagram`) -> LUT schedule (:mod:`nonblocked` Algorithm 1
or :mod:`blocked` Algorithms 2-4) -> row-parallel replay on the PyTorch MvCAM
simulator (:mod:`ap`) -> energy/delay/area (:mod:`energy`, :mod:`circuit`).
"""
from . import ap, blocked, circuit, energy, lut, mvl, nonblocked
from . import state_diagram, truth_tables
from .blocked import build_lut_blocked
from .lut import LUT, Block, Pass
from .nonblocked import build_lut_nonblocked
from .state_diagram import CycleBreakError, StateDiagram
from .truth_tables import InPlaceFunction, from_callable

__all__ = [
    "ap", "blocked", "circuit", "energy", "lut", "mvl", "nonblocked",
    "state_diagram", "truth_tables", "build_lut_blocked",
    "build_lut_nonblocked", "LUT", "Block", "Pass", "CycleBreakError",
    "StateDiagram", "InPlaceFunction", "from_callable",
]
