"""Batched serving on the PyTorch port: prefill + decode with KV/SSM caches
through the Engine, across three architecture families (dense GQA, hybrid
mamba+attn+MoE, pure SSM).

The steps and sizes of ``examples/serve_lm.py`` (4 prompts of 8 tokens, 24
new tokens, temperature 0.7, a 96-token cache), the Engine on
``make_smoke_mesh`` as there.  The weights are the port's own draws from
seed 0 and sampling draws from a ``torch.Generator``, so the tokens are
its own.  It fails (exit 1) unless every architecture returns
``[4, n_new]`` ids inside its vocabulary.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--new-tokens 24]
[--device cpu] (default ``cuda:0``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import model as M
from repro_torch.serve import Engine, ServeCfg

ARCHS = ("qwen3-0.6b", "jamba-v0.1-52b", "mamba2-2.7b")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = make_smoke_mesh(dev)
    out_all = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params = M.cast_params(cfg, M.init_params(cfg, seed=0, device=dev))
        engine = Engine(cfg, params, ServeCfg(max_len=96, temperature=0.7),
                        mesh=mesh)
        prompts = np.random.default_rng(0).integers(
            1, cfg.vocab, (4, 8), dtype=np.int32)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = engine.generate(prompts, n_new=args.new_tokens)
        dt = time.perf_counter() - t0
        if out.shape != (4, args.new_tokens) or out.min() < 0 \
                or out.max() >= cfg.vocab:
            raise SystemExit(f"{arch}: bad ids of shape {out.shape}")
        print(f"{arch:18s} [{cfg.family:6s}] generated {out.shape[0]}x"
              f"{out.shape[1]} tokens in {dt:5.1f}s "
              f"({out.size/dt:6.1f} tok/s)  sample: {out[0][:8].tolist()}")
        out_all[arch] = out
    return out_all


if __name__ == "__main__":
    main()
