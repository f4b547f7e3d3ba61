"""Beyond the paper's adder, on the PyTorch port: the LUT compiler is
universal (paper §I claims NOR/XOR/AND/mult/add/sub) — here: subtraction,
multiplication, logic ops, and higher radices, all validated against numpy,
plus the beyond-paper best-blocked schedule search and the AP program
compiler (``repro_torch.apc``) that fuses whole multi-digit programs into
one program-kernel launch.  The same steps, inputs and printed lines as
``examples/ap_arithmetic.py``.

Run:  PYTHONPATH=src python examples/torch_ap_arithmetic.py [--device cpu]
(default ``cuda:0``).
"""
import argparse

import numpy as np

from repro_torch import apc
from repro_torch.core import build_lut_blocked, build_lut_nonblocked
from repro_torch.core import ap, truth_tables as tt
from repro_torch.core.blocked import best_blocked_lut
from repro_torch.device import resolve_device


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"check failed: {what}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0)")
    dev = resolve_device(parser.parse_args(argv).device)
    rng = np.random.default_rng(1)

    # ---- multi-radix adders -------------------------------------------------
    for radix in (2, 3, 4, 5):
        fa = tt.full_adder(radix)
        nb = build_lut_nonblocked(fa)
        bl = build_lut_blocked(tt.full_adder(radix))
        nb.validate(fa)
        bl.validate(tt.full_adder(radix))
        print(f"radix-{radix} adder: {nb.n_passes} passes, "
              f"blocked {bl.n_write_cycles} writes")

    # ---- subtraction (both engines: replay and the fused compiler) ----------
    w = 8
    sub = tt.full_subtractor(3)
    lut_sub = build_lut_nonblocked(sub)
    a = rng.integers(0, 3 ** w, 256)
    b = rng.integers(0, 3 ** w, 256)
    arr = ap.encode_operands(a, b, 3, w)
    out = ap.ripple_sub(arr, lut_sub, w, borrow_col=2 * w,
                        device=dev).cpu().numpy()
    out_apc = ap.ripple_sub(arr, lut_sub, w, borrow_col=2 * w, engine="apc",
                            device=dev).cpu().numpy()
    got = ap.decode_digits(out, list(range(w, 2 * w)), 3)
    require(np.array_equal(got, (a - b) % 3 ** w), "ternary subtraction")
    require(np.array_equal(out, out_apc),
            "fused engine must be bit-identical")
    print(f"ternary subtraction: 256 rows x {w} trits correct "
          f"(replay == apc)")

    # ---- multiplication (shift-and-add with operand repair) -----------------
    w = 4
    lut_add = build_lut_nonblocked(tt.full_adder(3))
    lut_half = build_lut_nonblocked(tt.half_adder(3))
    a = rng.integers(0, 3 ** w, 128)
    b = rng.integers(0, 3 ** w, 128)
    arr = np.zeros((128, 5 * w + 1), np.int8)
    for i in range(w):
        arr[:, i] = arr[:, w + i] = (a // 3 ** i) % 3
        arr[:, 2 * w + i] = (b // 3 ** i) % 3
    out = ap.multiply(arr, lut_add, lut_half, w, 3, a_base=0, acopy_base=w,
                      b_base=2 * w, r_base=3 * w, carry_col=5 * w,
                      device=dev).cpu().numpy()
    got = ap.decode_digits(out, list(range(3 * w, 5 * w)), 3)
    require(np.array_equal(got, a * b), "ternary multiplication")
    require(np.array_equal(ap.decode_digits(out, list(range(w)), 3), a),
            "operand A must survive (repair sweep)")
    print(f"ternary multiplication: 128 rows x {w}x{w} trits correct, "
          f"A preserved")

    # ---- in-place logic ops -------------------------------------------------
    for name in ("min", "max", "modsum", "nor", "nand"):
        fn = tt.REGISTRY[name](3)
        lut = build_lut_nonblocked(fn)
        lut.validate(fn)
        print(f"ternary {name}: {lut.n_passes} passes valid")

    # ---- AP program compiler: whole programs as one fused schedule ----------
    w = 20
    compiled = apc.compile_named("add", 3, w)
    print(f"\napc 20-trit adder: {compiled.n_steps} fused steps, "
          f"{compiled.n_compare_cycles} compare + {compiled.n_write_cycles} "
          f"write cycles")
    a = rng.integers(0, 3 ** w, 4096)
    b = rng.integers(0, 3 ** w, 4096)
    arr = ap.encode_operands(a, b, 3, w)
    out, traced = apc.execute(arr, compiled, collect_stats=True, device=dev)
    stats = apc.to_ap_stats(traced, compiled, 4096, radix=3)
    out = out.cpu().numpy()
    got = ap.decode_digits(out, list(range(w, 2 * w)), 3) \
        + out[:, 2 * w].astype(np.int64) * 3 ** w
    require(np.array_equal(got, a + b), "apc fused add")
    print(f"apc fused add: 4096 rows correct, {stats.sets / 4096:.2f} "
          f"sets/add (paper Table XI: 21.02), one kernel launch")

    # new ops via the compiler: radix-complement negate
    neg = apc.compile_named("negate", 3, 8)
    arrn = np.zeros((128, 17), np.int8)
    for i in range(8):
        arrn[:, i] = (b[:128] // 3 ** i) % 3
    outn, _ = apc.execute(arrn, neg, device=dev)
    require(np.array_equal(ap.decode_digits(outn.cpu().numpy(),
                                            list(range(8, 16)), 3),
                           (-b[:128]) % 3 ** 8), "apc negate")
    print("apc negate: radix-complement of 128 rows correct")

    # ---- beyond-paper: best cycle-break search ------------------------------
    best, breaks = best_blocked_lut(tt.full_adder(3))
    base = build_lut_blocked(tt.full_adder(3))
    print(f"\nbest-blocked search: {base.n_write_cycles} -> "
          f"{best.n_write_cycles} write blocks via redirect {breaks} "
          f"(paper's Table X uses 9)")


if __name__ == "__main__":
    main()
