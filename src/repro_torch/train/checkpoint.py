"""Checkpoints in the reference's on-disk layout.

The port of :mod:`repro.train.checkpoint`; one directory per step,
committed by an atomic rename:

    <dir>/step_000000123.tmp/         # written
        manifest.json                 # step, emergency, leaves
        proc00000/leaf_<i>_<offs>.npy # leaf i, its global index offsets
    <dir>/step_000000123/             # committed (rename)

``leaves`` maps each '::'-joined tree path to its index (sorted paths),
shape and dtype string.  The port holds whole tensors on one device, so it
writes each leaf as one file at offsets 0; it reads any split the
reference wrote.  A checkpoint crosses between the packages both ways.

bf16 without ``ml_dtypes``: the manifest says ``"bfloat16"`` and the file
holds the 2-byte payload as a ``V2`` array, the form ``np.save`` gives
the reference's bf16 arrays and its restore views; the port reads that or
any other 2-byte form back as bf16.

``keep_last`` limits disk; an ``emergency=True`` save runs no GC, so a
preemption save does not collect older steps (a later regular save's GC
counts it like any other step, as in the reference).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..device import resolve_device

SEP = "::"
# the dtypes a train state holds (params, m, v, step)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + [str(k)], v)
        else:
            flat[SEP.join(prefix)] = node

    walk([], tree)
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(dtype)


def save(ckpt_dir: str, step: int, state, emergency: bool = False,
         keep_last: int = 3) -> str:
    """Write a checkpoint of ``state`` (a nested dict of tensors); returns
    the committed path.  DTensor leaves are gathered whole first (every
    rank of their mesh must call this), and only rank 0 writes."""
    flat = {k: t.full_tensor() if hasattr(t, "full_tensor") else t
            for k, t in _flatten(state).items()}
    tmp = os.path.join(ckpt_dir, f"step_{step:09d}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if _rank() != 0:
        return final
    pdir = os.path.join(tmp, "proc00000")
    os.makedirs(pdir, exist_ok=True)

    manifest = {"step": step, "emergency": emergency, "leaves": {}}
    for i, (key, t) in enumerate(sorted(flat.items())):
        manifest["leaves"][key] = {
            "index": i, "shape": list(t.shape), "dtype": _NAMES[t.dtype]}
        suffix = "_".join("0" * t.ndim) or "0"
        np.save(os.path.join(pdir, f"leaf_{i}_{suffix}.npy"), _to_numpy(t))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)          # atomic commit
    if not emergency:
        _gc(ckpt_dir, keep_last)
    return final


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, device=None) -> dict:
    """Load a checkpoint as a nested dict of tensors on ``device`` (``None``
    = ``cuda:0``; the reference's ``shardings=``), the pieces of each leaf
    put together at their offsets."""
    dev = resolve_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    files = [(pdir, fn) for pdir in sorted(os.listdir(path))
             if pdir.startswith("proc")
             for fn in os.listdir(os.path.join(path, pdir))]
    flat_out = {}
    for key, info in manifest["leaves"].items():
        i, dtype = info["index"], _DTYPES[info["dtype"]]
        full = torch.zeros(tuple(info["shape"]), dtype=dtype)
        for pdir, fn in files:
            if not fn.startswith(f"leaf_{i}_"):
                continue
            offs = [int(x) for x in fn[:-4].split("_")[2:] if x != ""]
            part = _from_numpy(np.load(os.path.join(path, pdir, fn)), dtype)
            idx = tuple(slice(o, o + s) for o, s in zip(offs, part.shape))
            full[idx] = part
        flat_out[key] = full.to(dev)
    return _unflatten(flat_out)
