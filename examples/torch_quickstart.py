"""Quickstart on the PyTorch port: the paper's pipeline end-to-end.

Truth table -> state diagram (cycle break 101->020) -> LUTs (Algorithm 1
non-blocked, Algorithms 2-4 blocked) -> row-parallel 20-trit vector addition
on the port's MvAP simulator -> energy / delay / area summary vs the paper.
The same steps, inputs and printed numbers as ``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(default ``cuda:0``).
"""
import argparse

import numpy as np

from repro_torch.core import StateDiagram, build_lut_blocked
from repro_torch.core import build_lut_nonblocked
from repro_torch.core import ap, truth_tables as tt
from repro_torch.core.circuit import CellParams
from repro_torch.core.energy import (energy_from_stats, lut_delay_ns,
                                     row_area_units)
from repro_torch.device import resolve_device

WIDTH, ROWS = 20, 1024


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0)")
    dev = resolve_device(parser.parse_args(argv).device)

    # 1. compile the ternary full adder truth table into LUT schedules
    fa = tt.full_adder(3)
    sd = StateDiagram(fa)
    print(f"state diagram: {len(sd.roots)} noAction roots, "
          f"cycle break(s): {sd.breaks_used}  (paper: 101 -> 020)")
    lut_nb = build_lut_nonblocked(fa)
    lut_bl = build_lut_blocked(tt.full_adder(3))
    lut_nb.validate(fa)
    lut_bl.validate(tt.full_adder(3))
    print(f"non-blocked: {lut_nb.n_passes} passes / {lut_nb.n_write_cycles} "
          f"writes (paper Table VII: 21/21)")
    print(f"blocked:     {lut_bl.n_passes} passes / {lut_bl.n_write_cycles} "
          f"writes (paper Table X: 21/9)")

    # 2. 20-trit row-parallel in-place addition: B <- A + B
    rng = np.random.default_rng(0)
    a = rng.integers(0, 3 ** WIDTH, ROWS)
    b = rng.integers(0, 3 ** WIDTH, ROWS)
    arr = ap.encode_operands(a, b, 3, WIDTH)
    stats = ap.APStats(radix=3)
    out = ap.ripple_add(arr, lut_nb, WIDTH, carry_col=2 * WIDTH,
                        stats=stats, device=dev).cpu().numpy()
    got = ap.decode_digits(out, list(range(WIDTH, 2 * WIDTH)), 3) \
        + out[:, 2 * WIDTH].astype(np.int64) * 3 ** WIDTH
    if not np.array_equal(got, a + b):
        raise SystemExit("20-trit additions: wrong sums")
    print(f"\n{ROWS} parallel 20-trit additions: all correct")

    # 3. price it with the co-simulator's energy/delay/area model
    rep = energy_from_stats(stats, n_masked=3, params=CellParams(radix=3))
    print(f"sets/resets per add: {stats.sets / ROWS:.2f} (paper: 21.02)")
    print(f"total energy per add: {rep.total_j / ROWS * 1e9:.2f} nJ "
          f"(paper: 42.06 nJ)")
    ratio = lut_delay_ns(lut_nb, WIDTH) / lut_delay_ns(lut_bl, WIDTH)
    print(f"delay: non-blocked {lut_delay_ns(lut_nb, WIDTH):.0f} ns, "
          f"blocked {lut_delay_ns(lut_bl, WIDTH):.0f} ns "
          f"(ratio {ratio:.2f}x, paper: 1.4x)")
    print(f"row area: {row_area_units(WIDTH, 3):.0f} units "
          f"(32-bit binary AP: {row_area_units(32, 2):.0f}; paper: 60 vs 64)")


if __name__ == "__main__":
    main()
