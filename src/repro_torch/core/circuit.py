"""Matchline RC discharge model of the "nTnR" MvCAM cell (paper §VI.A).

Replaces the paper's HSPICE runs with an analytical first-order model that
reproduces the Fig. 6 / Fig. 7 design-space trends:

  * the matchline capacitor C_L, precharged to VDD, discharges through the
    parallel pull-down paths of the masked cells during the evaluate window;
  * a *matching* masked cell exposes (n-1) HRS paths (the key-selected branch
    is gated off); a stored don't-care is all-HRS and looks identical;
  * a *mismatching* cell exposes one LRS path plus (n-2) HRS paths;
  * unmasked cells have every branch gated off (decoded signals all low).

Each branch includes the access transistor's on-resistance R_T in series with
its memristor.  V_ML(t) = VDD * exp(-G_row * t / C_L); the dynamic range is
DR = V_fm(t_eval) - V_1mm(t_eval) (eq. 2), and the per-compare energy is the
capacitor charge replaced each precharge/evaluate cycle,
E = C_L * (VDD^2 - V_ML(t_eval)^2).

Defaults are calibrated once against the paper's quoted design point
(DR ~ 240 mV at R_L = 20 kΩ, α = 50, C_L = 100 fF, 1 ns evaluate) and then
reused unchanged everywhere (Table XI compare energies, Fig 7 sweep).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

# paper's adopted design point (§VI.A)
R_L_DEFAULT = 20e3           # ohms, memristor LRS
ALPHA_DEFAULT = 50.0         # R_H = alpha * R_L
C_L_DEFAULT = 100e-15        # farads, matchline cap
VDD_DEFAULT = 0.8            # volts (45 nm PTM, Vt = 0.4 V)
T_EVAL_DEFAULT = 1e-9        # seconds, evaluate window
R_T_DEFAULT = 8e3            # ohms, access-transistor on-resistance (45 nm)


@dataclass(frozen=True)
class CellParams:
    radix: int = 3
    r_l: float = R_L_DEFAULT
    alpha: float = ALPHA_DEFAULT
    c_l: float = C_L_DEFAULT
    vdd: float = VDD_DEFAULT
    t_eval: float = T_EVAL_DEFAULT
    r_t: float = R_T_DEFAULT

    @property
    def r_h(self) -> float:
        return self.alpha * self.r_l

    def with_(self, **kw) -> "CellParams":
        return replace(self, **kw)


def cell_conductance(params: CellParams, mismatch: bool) -> float:
    """Pull-down conductance of one masked cell during evaluate."""
    n = params.radix
    g_hrs = 1.0 / (params.r_h + params.r_t)
    g_lrs = 1.0 / (params.r_l + params.r_t)
    if mismatch:
        return g_lrs + (n - 2) * g_hrs
    return (n - 1) * g_hrs


def row_conductance(params: CellParams, n_masked: int, n_mismatch: int) -> float:
    g_mm = cell_conductance(params, mismatch=True)
    g_fm = cell_conductance(params, mismatch=False)
    return n_mismatch * g_mm + (n_masked - n_mismatch) * g_fm


def matchline_voltage(params: CellParams, n_masked: int,
                      n_mismatch: int) -> float:
    """V_ML at the end of the evaluate window."""
    g = row_conductance(params, n_masked, n_mismatch)
    return params.vdd * np.exp(-g * params.t_eval / params.c_l)


def dynamic_range(params: CellParams, n_masked: int = 3) -> float:
    """DR = V_fm - V_1mm (paper eq. 2)."""
    return (matchline_voltage(params, n_masked, 0)
            - matchline_voltage(params, n_masked, 1))


def compare_energy(params: CellParams, n_masked: int,
                   n_mismatch: int) -> float:
    """Energy (J) of one row-compare: charge replaced on the ML capacitor."""
    v_end = matchline_voltage(params, n_masked, n_mismatch)
    return params.c_l * (params.vdd ** 2 - v_end ** 2)


def compare_energy_table(params: CellParams, n_masked: int) -> np.ndarray:
    """E(m) for m = 0..n_masked mismatching cells, in joules."""
    return np.array([compare_energy(params, n_masked, m)
                     for m in range(n_masked + 1)])


def design_space_sweep(radix: int = 3, n_masked: int = 3,
                       r_l_values=(20e3, 30e3, 50e3, 100e3),
                       alphas=(10, 20, 30, 40, 50)):
    """Reproduce the Fig. 6 (DR) and Fig. 7 (compare energy) sweeps.

    Returns dict with 'dr' [len(r_l), len(alpha)] volts and
    'energy' [len(r_l), len(alpha), n_masked+1] joules.
    """
    dr = np.zeros((len(r_l_values), len(alphas)))
    en = np.zeros((len(r_l_values), len(alphas), n_masked + 1))
    for i, rl in enumerate(r_l_values):
        for j, a in enumerate(alphas):
            p = CellParams(radix=radix, r_l=rl, alpha=float(a))
            dr[i, j] = dynamic_range(p, n_masked)
            en[i, j] = compare_energy_table(p, n_masked)
    return {"r_l": np.array(r_l_values), "alpha": np.array(alphas),
            "dr": dr, "energy": en}
