"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
[--smoke]``.

The port of :mod:`repro.launch.serve`, with its flags and defaults (batch
4, 16-token prompts, 32 new tokens, a 128-token cache).  Weights are
random from seed 0 (``init_params``), their MLPs packed
(``quantize_model_params``) and cast once for compute (``cast_params``);
the engine serves the float route, the packed projections on the
packed-ternary matmul kernels.  No mesh: one device, ``cuda:0`` unless
``--device`` says otherwise (``--device cpu`` runs the plain CPU path).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config, get_smoke_config
from ..configs.registry import ARCH_IDS
from ..models import model as M
from ..models.quant import quantize_model_params
from ..serve import Engine, ServeCfg


def main(argv=None) -> None:
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

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = M.cast_params(cfg, quantize_model_params(
        M.init_params(cfg, seed=0, device=args.device)))
    engine = Engine(cfg, params, ServeCfg(max_len=args.max_len,
                                          temperature=args.temperature),
                    device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s batched)")
    print("sample:", out[0][:16].tolist())


if __name__ == "__main__":
    main()
