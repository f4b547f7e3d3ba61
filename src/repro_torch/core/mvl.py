"""Multi-valued logic (MVL) primitives.

Radix-n unbalanced logic: digit values {0, 1, ..., n-1} realised with voltage
levels i * VDD/(n-1) (paper §II).  The paper's illustrative radix is ternary
(n=3) with the unbalanced {0,1,2} system; balanced ternary {-1,0,1} is used by
the quantization layer (models/quant.py) and maps onto unbalanced via +1.

This module also implements the ternary inverters (Table IV) and the search-key
n-ary decoder (Table II / Fig. 3) used by the MvCAM front-end.
"""
from __future__ import annotations

import numpy as np

DONT_CARE = -1  # sentinel for the all-HRS "don't care" cell state / masked key


# ---------------------------------------------------------------------------
# Digit/vector conversions
# ---------------------------------------------------------------------------

def int_to_digits(x: int, radix: int, width: int) -> tuple[int, ...]:
    """Little-endian digit expansion of ``x`` in ``radix`` with ``width`` digits."""
    if x < 0:
        raise ValueError("int_to_digits requires non-negative x")
    out = []
    for _ in range(width):
        out.append(x % radix)
        x //= radix
    if x:
        raise OverflowError(f"{x=} does not fit in {width} radix-{radix} digits")
    return tuple(out)


def digits_to_int(digits, radix: int) -> int:
    """Little-endian digits → integer."""
    val = 0
    for d in reversed(list(digits)):
        val = val * radix + int(d)
    return val


def vec_to_key(digits, radix: int) -> int:
    """Big-endian positional encoding of a state vector (paper's 'n-ary'-to-
    decimal conversion, e.g. '020' ternary → 6)."""
    val = 0
    for d in digits:
        val = val * radix + int(d)
    return val


def key_to_vec(key: int, radix: int, width: int) -> tuple[int, ...]:
    out = []
    for _ in range(width):
        out.append(key % radix)
        key //= radix
    return tuple(reversed(out))


# ---------------------------------------------------------------------------
# Ternary inverters (Table IV) — used by the decoder circuit model
# ---------------------------------------------------------------------------

def sti(x: int) -> int:
    """Standard ternary inverter: 2-x."""
    return 2 - x


def pti(x: int) -> int:
    """Positive ternary inverter: 0 iff x==2 else 2."""
    return 0 if x == 2 else 2


def nti(x: int) -> int:
    """Negative ternary inverter: 2 iff x==0 else 0."""
    return 2 if x == 0 else 0


def binary_not(x: int) -> int:
    """Binary inverter on {0,2} rails (logic-high = 2)."""
    return 2 if x == 0 else 0


def ternary_decoder(mask: int, key: int) -> tuple[int, int, int]:
    """Gate-level ternary decoder of Fig. 3 (eqs. 1a-1c).

    Returns the (S2, S1, S0) signal triplet on {0, 2} rails.  ``mask`` is 0
    (column masked out) or 2 (=n-1, active); ``key`` in {0,1,2}.
    """
    m = 1 if mask else 0
    s2 = 2 * m if pti(key) == 2 else 0                      # Mask · PTI(K)
    s1 = 2 * m if (nti(key) == 2 or binary_not(pti(key)) == 2) else 0
    s0 = 2 * m if binary_not(nti(key)) == 2 else 0
    return (s2, s1, s0)


def nary_decoder(mask: int, key: int, radix: int) -> tuple[int, ...]:
    """Behavioural n-ary decoder (Table II).

    Output signal vector (S_{n-1} ... S_0) on {0, n-1} rails: when unmasked,
    exactly S_key is low (0) and the rest are high (n-1); when masked, all 0.
    """
    if mask == 0:
        return tuple(0 for _ in range(radix))
    return tuple(0 if i == key else radix - 1 for i in reversed(range(radix)))


# ---------------------------------------------------------------------------
# Memristor cell state mapping (Table I)
# ---------------------------------------------------------------------------

def value_to_cell_states(value: int, radix: int) -> tuple[str, ...]:
    """Stored digit → (M_{n-1} ... M_0) memristor states, 'H'/'L'.

    Digit i sets M_i to LRS ('L'); don't-care (DONT_CARE) is all-HRS.
    """
    if value == DONT_CARE:
        return tuple("H" for _ in range(radix))
    if not (0 <= value < radix):
        raise ValueError(f"digit {value} out of range for radix {radix}")
    return tuple("L" if i == value else "H" for i in reversed(range(radix)))


def cell_match(stored: int, mask: int, key: int, radix: int) -> bool:
    """Single-cell compare outcome derived from the resistive model (Table III).

    A masked-out column (mask=0 → all signals low) always matches.  A stored
    don't-care (all HRS) matches any key.  Otherwise match iff stored == key:
    searching key i drives S_i low; only M_i==LRS on that low line keeps every
    low-resistance path off the matchline.
    """
    if mask == 0:
        return True
    if stored == DONT_CARE:
        return True
    return stored == key


def logic_levels(radix: int, vdd: float) -> np.ndarray:
    """Voltage levels of the unbalanced radix-n system (paper §II)."""
    return np.arange(radix) * vdd / (radix - 1)
