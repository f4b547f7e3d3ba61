"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--smoke]``.

The port of :mod:`repro.launch.serve`, with its flags and defaults (batch
4, 16-token prompts, 32 new tokens, a 128-token cache).  Weights are
random from seed 0 (``init_params``), their MLPs packed
(``quantize_model_params``) and cast once for compute (``cast_params``);
the engine serves the float route, the packed projections on the
packed-ternary matmul kernels.

Inside an initialised process group (one process per rank, each given its
device) the engine serves on the elastic (data, model) ``DeviceMesh``
(``make_elastic_mesh``): the params are sharded by the partition rules,
every rank drives the same request, and rank 0 prints.  Under
``torchrun`` (``WORLD_SIZE`` in the environment) the launcher opens that
group itself: NCCL with each rank on card ``LOCAL_RANK``, or gloo with
``--device cpu``.  Without a group it serves on one device, ``cuda:0``
unless ``--device`` says otherwise (``--device cpu`` runs the plain CPU
path).  ``main(argv)`` returns the generated ids.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_config, get_smoke_config
from ..configs.registry import ARCH_IDS
from ..models import model as M
from ..models.quant import quantize_model_params
from ..serve import Engine, ServeCfg
from ..serve.engine import mesh_device
from .mesh import make_elastic_mesh


def _open_group(device) -> bool:
    """Under ``torchrun`` with no group yet, open one (True if opened)."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return False
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo")
    else:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    return True


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    opened = _open_group(args.device)
    try:
        cfg = get_smoke_config(args.arch) if args.smoke \
            else get_config(args.arch)
        mesh = make_elastic_mesh() if dist.is_initialized() else None
        dev = mesh_device(mesh, args.device)
        params = M.cast_params(cfg, quantize_model_params(
            M.init_params(cfg, seed=0, device=dev)))
        engine = Engine(cfg, params, ServeCfg(max_len=args.max_len,
                                              temperature=args.temperature),
                        device=dev, mesh=mesh)
        rng = np.random.default_rng(0)
        prompts = rng.integers(1, cfg.vocab, (args.batch, args.prompt_len),
                               dtype=np.int32)
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.new_tokens)
        dt = time.perf_counter() - t0
        if mesh is None or dist.get_rank() == 0:
            toks = args.batch * args.new_tokens
            where = "" if mesh is None else f" on {mesh}"
            print(f"generated {out.shape} in {dt:.2f}s "
                  f"({toks / dt:.1f} tok/s batched){where}")
            print("sample:", out[0][:16].tolist())
        return out
    finally:
        if opened:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
