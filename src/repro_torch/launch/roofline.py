"""Roofline analysis over the dry-run records, at the H100's peaks.

Terms (per card; spec-sheet figures for the NVIDIA H100 80GB HBM3 (SXM5)
at 700 W, not measurements):
    compute    = FLOPs_per_card / 989e12 FLOP/s       (bf16 dense, tensor cores)
    memory     = bytes_per_card / 3.35e12 B/s         (HBM3)
    collective = collective_bytes_per_card / 450e9 B/s (NVLink 4, per direction)

Sources: the port's own counts of each rank's local program
(:class:`repro_torch.launch.dryrun.LocalCost`: ``FlopCounterMode``'s
formulas, operands + results of every op, result bytes of every
collective), never XLA's.  Conventions held fixed, as the reference's:
  * bytes accessed counts every op's operands and results with no fusion
    — an OVERCOUNT of real HBM traffic; use it for deltas;
  * collective bytes = the sum of each collective's result bytes.
Also reported: MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference; N = active
params) and MODEL/counted FLOPs, the useful-compute fraction that exposes
remat, attention and redundancy.
"""
from __future__ import annotations

import argparse
import json
import os

PEAK_FLOPS = 989e12        # bf16 dense per card
HBM_BW = 3.35e12           # B/s per card
LINK_BW = 450e9            # B/s, NVLink 4 per direction
CARD = "NVIDIA H100 80GB HBM3, 700 W (spec sheet)"

DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "experiments", "dryrun_torch")


def model_flops(rec: dict, shapes) -> float:
    """6*N_active*D for train, 2*N_active*D_token for decode/prefill
    (global)."""
    cell = shapes[rec["shape"]]
    n = rec["params_active"]
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch          # one token per sequence


def analyze(rec: dict, chips: int, shapes) -> dict:
    if rec.get("status") != "ok":
        return dict(rec)
    compute_s = rec["flops"] / PEAK_FLOPS
    memory_s = rec["bytes_accessed"] / HBM_BW
    coll_s = rec["collectives"]["total"] / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(rec, shapes)
    bound = max(terms.values())
    ideal = mf / (chips * PEAK_FLOPS)
    return {
        **rec,
        "terms": terms,
        "dominant": dominant,
        "model_flops_global": mf,
        "model_to_hlo_flops": mf / (chips * rec["flops"])
        if rec["flops"] > 0 else None,
        # roofline fraction: ideal compute-bound step time / bound term
        "roofline_fraction": ideal / bound if bound > 0 else None,
    }


def load_all(dir_=DIR, mesh: str = "16x16", tag: str = "") -> list[dict]:
    from ..configs.shapes import SHAPES
    out = []
    chips = 512 if mesh == "2x16x16" else 256
    for fn in sorted(os.listdir(dir_)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(dir_, fn)) as f:
            rec = json.load(f)
        if rec.get("mesh") != mesh or rec.get("tag", "") != tag:
            continue
        out.append(analyze(rec, chips, SHAPES))
    return out


def table(records: list[dict]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'dom':12s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'coll_s':>10s} {'MODEL/cnt':>9s} "
           f"{'roofline':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in records:
        if r.get("status") == "ok":
            t = r["terms"]
            lines.append(
                f"{r['arch']:24s} {r['shape']:12s} "
                f"{r['dominant'].replace('_s', ''):12s} "
                f"{t['compute_s']:10.4f} {t['memory_s']:10.4f} "
                f"{t['collective_s']:10.4f} "
                f"{(r['model_to_hlo_flops'] or 0):9.3f} "
                f"{(r['roofline_fraction'] or 0):9.4f}")
        else:
            lines.append(f"{r['arch']:24s} {r['shape']:12s} "
                         f"{r.get('status'):12s} "
                         f"{r.get('reason', r.get('error', ''))[:60]}")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()
    recs = load_all(mesh=args.mesh, tag=args.tag)
    print(f"peaks: {CARD}")
    print(table(recs))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(recs, f, indent=1, default=str)


if __name__ == "__main__":
    main()
