"""Energy / delay / area model for AP LUT arithmetic (paper §VI).

Write energy: 1 nJ per memristor set or reset on average [26]; counts come
from the functional simulator (:class:`repro_torch.core.ap.APStats`).

Compare energy: per-row-compare values E(m) (m = #mismatching masked cells)
from the analytical matchline model (:mod:`repro_torch.core.circuit`) at the
paper's adopted design point (R_L, R_H) = (20 kΩ, 1 MΩ).

Delay (ns): compare = precharge(1) + evaluate(1); write = 2.  In the
*optimized* scheme the precharge overlaps a preceding write, so a compare
that directly follows a write costs 1 ns while compares following compares
still need the explicit precharge (paper §VI.C).  A blocked LUT pays one
write per block; a non-blocked LUT pays one per pass.

Area: a q-bit binary row uses 2q "2T2R" cells, a p-trit ternary row 2p
"3T3R" cells, with area(2T2R) = 0.67 * area(3T3R) (§VI.B Table XI).

Reference ternary adders (CLA/CSA/CRA, hybrid CNTFET+memristor [15]) are
encoded as per-20-trit-add constants extrapolated at VDD = 0.8 V; the CLA
constants are calibrated once against the paper's quoted ratios (52.64 %
energy, 6.8x / 9.5x delay at 512 rows) and reused for every figure.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ap import APStats
from .circuit import CellParams, compare_energy_table
from .lut import LUT

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

E_WRITE_PER_OP_J = 1e-9          # 1 nJ per set or reset [26]

T_PRECHARGE_NS = 1.0
T_EVALUATE_NS = 1.0
T_WRITE_NS = 2.0

# hybrid CNTFET+memristor ternary adders [15], extrapolated to 20-trit @0.8V.
# CLA energy is calibrated to the paper's 52.64% TAP saving; CLA delay to the
# 6.8x(non-blocked)/9.5x(blocked) savings at 512 rows.  CRA/CSA carry the
# qualitative ordering of Fig. 8 (CRA > CSA > CLA); exact values not quoted.
CLA_NJ_PER_20T_ADD = 88.81
CLA_NS_PER_20T_ADD = 22.32
CSA_NJ_PER_20T_ADD = CLA_NJ_PER_20T_ADD * 1.18
CRA_NJ_PER_20T_ADD = CLA_NJ_PER_20T_ADD * 1.35

AREA_2T2R = 0.67                 # relative to one 3T3R cell
AREA_3T3R = 1.0

# equivalent widths: q bits ~ ceil(p * log2(3))
EQUIV_WIDTHS = {5: 8, 10: 16, 20: 32, 32: 51, 40: 64, 80: 128}


# ---------------------------------------------------------------------------
# Delay model
# ---------------------------------------------------------------------------

def lut_delay_ns(lut: LUT, n_digits: int, optimized_precharge: bool = False
                 ) -> float:
    """Schedule delay for an n-digit row-parallel operation (any #rows)."""
    total = 0.0
    for blk in lut.blocks:
        k = len(blk.keys)
        if optimized_precharge:
            # first compare of the block follows a write -> precharge hidden
            total += T_EVALUATE_NS + (k - 1) * (T_PRECHARGE_NS + T_EVALUATE_NS)
        else:
            total += k * (T_PRECHARGE_NS + T_EVALUATE_NS)
        total += T_WRITE_NS
    return total * n_digits


def cla_delay_ns(n_rows: int) -> float:
    """Serial CLA: one 20-trit add per row."""
    return CLA_NS_PER_20T_ADD * n_rows


# ---------------------------------------------------------------------------
# Energy model
# ---------------------------------------------------------------------------

@dataclass
class EnergyReport:
    write_energy_j: float
    compare_energy_j: float
    sets: float
    resets: float

    @property
    def total_j(self) -> float:
        return self.write_energy_j + self.compare_energy_j


def energy_from_stats(stats: APStats, n_masked: int,
                      params: CellParams | None = None) -> EnergyReport:
    """Turn functional-simulator counters into joules."""
    params = params or CellParams(radix=stats.radix)
    e_cmp = compare_energy_table(params, n_masked)
    hist = stats.mismatch_hist[: n_masked + 1].astype(float)
    # overflow bucket (extended keys can exceed n_masked): clamp to worst case
    extra = stats.mismatch_hist[n_masked + 1:].sum()
    compare_j = float(hist @ e_cmp) + float(extra) * float(e_cmp[-1])
    write_j = (stats.sets + stats.resets) * E_WRITE_PER_OP_J
    return EnergyReport(write_energy_j=write_j, compare_energy_j=compare_j,
                        sets=stats.sets, resets=stats.resets)


def cla_energy_j(n_rows: int) -> float:
    return CLA_NJ_PER_20T_ADD * 1e-9 * n_rows


def csa_energy_j(n_rows: int) -> float:
    return CSA_NJ_PER_20T_ADD * 1e-9 * n_rows


def cra_energy_j(n_rows: int) -> float:
    return CRA_NJ_PER_20T_ADD * 1e-9 * n_rows


# ---------------------------------------------------------------------------
# Area model
# ---------------------------------------------------------------------------

def row_area_units(width: int, radix: int) -> float:
    """Normalized row area (Table XI): operand cells (A and B vectors), in
    2T2R units — a binary q-bit row reads "2q x", a ternary p-trit row
    "2p * (area(3T3R)/area(2T2R)) x"."""
    if radix == 2:
        return 2.0 * width
    return 2.0 * width * (AREA_3T3R / AREA_2T2R)


def area_table(widths_ternary=(5, 10, 20, 32, 40, 80)) -> dict:
    """Reproduce the Table XI normalized-area row."""
    out = {}
    for p in widths_ternary:
        q = EQUIV_WIDTHS[p]
        out[(q, p)] = (row_area_units(q, 2), row_area_units(p, 3))
    return out
