"""Assigned input-shape cells (same 4 for every LM arch).

``train_4k`` lowers train_step; ``prefill_32k`` lowers the prefill path;
``decode_32k`` / ``long_500k`` lower serve_step (one new token against a KV /
SSM cache of seq_len).  long_500k requires sub-quadratic structure — the
dry-run skips it for pure full-attention archs (recorded, per assignment).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}

SMOKE_SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 64, 4),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 128, 2),
    "decode_32k": ShapeCell("decode_32k", "decode", 128, 4),
    "long_500k": ShapeCell("long_500k", "decode", 512, 1),
}


def applicable(cfg, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) pair."""
    if cell.name == "long_500k" and not cfg.is_sub_quadratic:
        return False, ("pure full-attention arch: every layer would hold the "
                       "full 500k KV cache (no sub-quadratic structure) — "
                       "skipped per assignment")
    return True, ""
