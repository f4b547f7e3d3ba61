#!/usr/bin/env python3
"""Time the TAP entry points that callers use, ``tap_ripple_add`` and
``tap_apply_lut``, with each call building its schedule from the LUT as a
caller's call does; the source tree is a flag, so that two checkouts
compare in one run on one card.

Run on a machine with one card, from the root of a checkout:

    mkdir -p build/parent && git archive <rev> | tar -x -C build/parent
    python3 scripts/tap_entry_times.py --src build/parent --json a.json
    python3 scripts/tap_entry_times.py --json b.json

``--src`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one); the timing helpers come from this checkout's
``chip_smoke.py``.  Two calls, each on one short schedule of the schedule
kernel: the width-3 ripple add (non-blocked full adder, 64 steps, 7
columns) and one application of the blocked full adder (columns 0-2 of the
same 7), at 4096, 65536 and 2^20 rows.  Each call is first checked against
the plain version and must launch ``tap_apply_schedule`` once; then
``ms`` is the CUDA-event median of 20 back-to-back calls (the host's work
per call included) and ``device_ms`` that of a CUDA graph of 20 calls
(null, with the reason, where a call cannot be captured, as one that
copies from the host at every call cannot).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (4096, 65536, 1 << 20)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--src", default=ROOT,
                   help="root of the checkout to time (default: this one)")
    p.add_argument("--json", help="also write the rows here")
    args = p.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tap_entry_times: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src)
    sys.path[:0] = [os.path.join(src, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.core import build_lut_blocked, build_lut_nonblocked
    from repro_torch.core import truth_tables as tt
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.tap_pass import (kernel, ref, tap_apply_lut,
                                              tap_ripple_add)
    cuda_lib.build(["tap_schedule"])
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    rng = np.random.default_rng(cs.SEED)
    lut_n = build_lut_nonblocked(tt.full_adder(3))
    lut_b = build_lut_blocked(tt.full_adder(3))
    cases = (
        ("tap_ripple_add", "ripple_add3x3",
         lambda a: tap_ripple_add(a, lut_n, 3, 6),
         lambda a: ref.apply_schedule(a, ref.ripple_add_schedule(lut_n, 3,
                                                                 6))),
        ("tap_apply_lut", "full_adder_blocked",
         lambda a: tap_apply_lut(a, lut_b, (0, 1, 2)),
         lambda a: ref.apply_schedule(a, ref.schedule_from_lut(lut_b,
                                                               (0, 1, 2)))))
    out = []
    for rows in ROWS:
        _, _, digits = cs.named_operands("add", 3, 3, rows, rng)
        arr = torch.from_numpy(digits).to(dev)
        for entry, program, call, plain in cases:
            before = kernel.launch_counts["tap_apply_schedule"]
            got = call(arr)
            cs.check(kernel.launch_counts["tap_apply_schedule"] == before + 1,
                     f"{entry} rows={rows}: not one schedule-kernel launch")
            cs.check(torch.equal(got, plain(arr)),
                     f"{entry} rows={rows}: not the plain version's digits")
            row = {"entry": entry, "program": program, "rows": rows,
                   "src": os.path.relpath(src, ROOT),
                   "ms": cs.event_ms(lambda: call(arr), reps=5, inner=20),
                   "card": card}
            try:
                row["device_ms"] = cs.graph_ms(lambda: call(arr))
            except RuntimeError as e:    # a call that copies to the card
                row["device_ms"] = None
                row["graph_error"] = str(e).splitlines()[0]
                torch.cuda.synchronize()
            out.append(row)
            print(json.dumps(row), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
