"""The dry-run and roofline tables from the records of
:mod:`repro_torch.launch.dryrun`.

Usage: PYTHONPATH=src python -m repro_torch.launch.report [--compact]
(``--compact``: one row a cell, both meshes and the roofline)
"""
from __future__ import annotations

import json
import os

from ..configs.shapes import SHAPES
from .roofline import CARD, DIR, analyze

ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(mesh: str, tag: str = "", dir_: str = DIR) -> dict:
    out = {}
    for fn in sorted(os.listdir(dir_)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(dir_, fn)) as f:
            r = json.load(f)
        if r.get("mesh") != mesh or r.get("tag", "") != tag:
            continue
        out[(r["arch"], r["shape"])] = analyze(
            r, 512 if mesh == "2x16x16" else 256, SHAPES)
    return out


def fmt_b(x) -> str:
    return "-" if x is None else f"{x / 1e9:.2f}"


def _status(x) -> str:
    if x is None:
        return "missing"
    if x["status"] == "skipped":
        return "skip (full-attn)"
    return "OK" if x["status"] == "ok" else x["status"]


def dryrun_table(dir_: str = DIR) -> str:
    single, multi = load("16x16", dir_=dir_), load("2x16x16", dir_=dir_)
    lines = ["| arch | shape | 16x16 (256) | 2x16x16 (512) | per-card peak GB"
             " (16x16 / 2x16x16) | per-card state GB | GFLOPs/card |"
             " collective GB/card | fits 80 GB |",
             "|---|---|---|---|---|---|---|---|---|"]
    archs = sorted({a for a, _ in set(single) | set(multi)})
    for a in archs:
        for sh in ORDER:
            s, m = single.get((a, sh)), multi.get((a, sh))
            if s is None and m is None:
                continue
            r = s if s is not None and s["status"] == "ok" else m
            if r is None or r["status"] != "ok":
                lines.append(f"| {a} | {sh} | {_status(s)} | {_status(m)} "
                             f"| - | - | - | - | - |")
                continue
            peaks = " / ".join(
                fmt_b(x["memory"]["peak_bytes"]) if x and x["status"] == "ok"
                else "-" for x in (s, m))
            fits = all(x["memory"]["fits_80gb"] for x in (s, m)
                       if x and x["status"] == "ok")
            lines.append(
                f"| {a} | {sh} | {_status(s)} | {_status(m)} | {peaks} "
                f"| {fmt_b(r['memory']['argument_bytes'])} "
                f"| {r['flops'] / 1e9:.0f} "
                f"| {r['collectives']['total'] / 1e9:.2f} "
                f"| {'yes' if fits else 'no'} |")
    return "\n".join(lines)


def roofline_table(dir_: str = DIR) -> str:
    single = load("16x16", dir_=dir_)
    lines = ["| arch | shape | compute s | memory s | collective s |"
             " dominant | MODEL/counted | roofline frac |",
             "|---|---|---|---|---|---|---|---|"]
    for (a, sh) in sorted(single):
        r = single[(a, sh)]
        if r["status"] != "ok":
            continue
        t = r["terms"]
        lines.append(
            f"| {a} | {sh} | {t['compute_s']:.4f} | {t['memory_s']:.4f} "
            f"| {t['collective_s']:.4f} | {r['dominant'].replace('_s', '')} "
            f"| {(r['model_to_hlo_flops'] or 0):.3f} "
            f"| {(r['roofline_fraction'] or 0):.4f} |")
    return "\n".join(lines)


def compact_table(dir_: str = DIR) -> str:
    """One row a cell: both meshes' status and peak, the 256-card
    roofline."""
    single, multi = load("16x16", dir_=dir_), load("2x16x16", dir_=dir_)
    lines = ["| arch | shape | 256 / 512 | peak GB 256 / 512 | TFLOPs/card"
             " | coll GB/card | dominant | compute / memory / coll s |"
             " MODEL/counted |",
             "|---|---|---|---|---|---|---|---|---|"]
    for a in sorted({a for a, _ in set(single) | set(multi)}):
        for sh in ORDER:
            s, m = single.get((a, sh)), multi.get((a, sh))
            if s is None and m is None:
                continue
            stat = f"{_status(s)} / {_status(m)}"
            if s is None or s["status"] != "ok":
                lines.append(f"| {a} | {sh} | {stat} | - | - | - | - | - "
                             f"| - |")
                continue
            peaks = " / ".join(
                f"{x['memory']['peak_bytes'] / 1e9:.1f}"
                if x and x["status"] == "ok" else "-" for x in (s, m))
            t = s["terms"]
            lines.append(
                f"| {a} | {sh} | {stat} | {peaks} | {s['flops'] / 1e12:.1f} "
                f"| {s['collectives']['total'] / 1e9:.1f} "
                f"| {s['dominant'].replace('_s', '')} "
                f"| {t['compute_s']:.3f} / {t['memory_s']:.3f} / "
                f"{t['collective_s']:.3f} "
                f"| {(s['model_to_hlo_flops'] or 0):.3f} |")
    return "\n".join(lines)


def main():
    import sys
    if "--compact" in sys.argv[1:]:
        print(f"peaks: {CARD}\n")
        print(compact_table())
        return
    print("## Dry-run (both meshes)\n")
    print(dryrun_table())
    print(f"\n## Roofline (single pod, 256 cards; peaks: {CARD})\n")
    print(roofline_table())


if __name__ == "__main__":
    main()
