"""End-to-end training driver on the PyTorch port: train a qwen3-family
model on a learnable synthetic language; the loss must drop.

The steps, sizes and hyperparameters of ``examples/train_lm.py``: the
default is CPU-sized (~3M params, 200 steps), ``--full-100m`` the ~100M
configuration (the same code path, longer).  The batches are the
reference's, from numpy; the initial weights are the port's own draws
from seed 0, so the losses are its own.  It fails (exit 1) unless the
last loss is below 0.6 of the first ("LEARNED").

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
[--full-100m] [--device cpu] (default ``cuda:0``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import AdamWCfg
from repro_torch.train.train_step import init_train_state, make_train_step


def synthetic_batch(step: int, vocab: int, batch: int, seq: int, dev):
    """Learnable affine token chain: t_{i+1} = (7 t_i + 3) mod vocab."""
    rng = np.random.default_rng(step)
    t0 = rng.integers(0, vocab, (batch, 1))
    toks = [t0]
    for _ in range(seq):
        toks.append((7 * toks[-1] + 3) % vocab)
    seq_all = np.concatenate(toks, axis=1)
    return {"tokens": torch.as_tensor(seq_all[:, :-1], dtype=torch.int32,
                                      device=dev),
            "targets": torch.as_tensor(seq_all[:, 1:], dtype=torch.int32,
                                       device=dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.full_100m:
        cfg = ModelConfig(name="repro-100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                          d_ff=2048, vocab=32768, qk_norm=True,
                          tie_embeddings=True, remat="none")
    else:
        cfg = ModelConfig(name="repro-3m", family="dense", n_layers=4,
                          d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                          d_ff=512, vocab=512, qk_norm=True,
                          tie_embeddings=True, remat="none")
    print(f"model: {cfg.name} ({cfg.n_params/1e6:.1f}M params)")

    opt = AdamWCfg(lr=3e-3, warmup_steps=10, total_steps=args.steps,
                   weight_decay=0.01)
    state = init_train_state(cfg, seed=0, device=dev)
    step_fn = make_train_step(cfg, opt)
    t0 = time.perf_counter()
    first = last = None
    for step in range(args.steps):
        batch = synthetic_batch(step, cfg.vocab, args.batch, args.seq, dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        first = first if first is not None else loss
        last = loss
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:.4f} "
                  f"({time.perf_counter()-t0:.1f}s)")
    learned = last < first * 0.6
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if learned else 'check hyperparams'})")
    if not learned:
        raise SystemExit(1)
    return {"first": first, "last": last, "steps": args.steps}


if __name__ == "__main__":
    main()
