"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``.

The port of :mod:`repro.launch.train`, with its flags and defaults (batch
8, sequence 128, lr 3e-4, warmup a twentieth of the steps), plus
``--device`` (default ``cuda:0``; ``--device cpu`` runs on the CPU).
Builds the state from seed 0 on the device, resumes from the latest
checkpoint in ``--ckpt-dir``, runs the fault-tolerant loop and prints
``done: steps=... loss a -> b stragglers=...``.  ``--compressed-dp`` runs
the TernGrad step over every visible card (``make_elastic_mesh``; with
``--device``, that device alone); the loop checkpoints the first
replica's state.  Inside an initialised process group (one process per
rank, each given its device) the state is sharded over the elastic
(data, model) mesh by the partition rules and every step runs on it.
``main(argv)`` returns the loop's summary.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch.distributed as dist

from ..configs import get_config, get_smoke_config
from ..configs.registry import ARCH_IDS
from ..data import DataCfg, TokenSource
from ..device import resolve_device
from ..train.compression import make_compressed_dp_step, replicate
from ..train.optimizer import AdamWCfg
from ..train.runtime import RunCfg, train_loop
from ..train.train_step import (init_train_state, make_train_step,
                                shard_train_state)
from .mesh import make_elastic_mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compressed-dp", action="store_true",
                    help="pure-DP + TernGrad ternary gradient all-reduce")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.remat:
        cfg = cfg.with_(remat=args.remat)
    dev = resolve_device(args.device)
    opt_cfg = AdamWCfg(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 20))
    source = TokenSource(
        DataCfg(vocab=cfg.vocab, global_batch=args.batch, seq_len=args.seq,
                path=args.data_path))
    state = init_train_state(cfg, seed=0, device=dev)
    if dist.is_available() and dist.is_initialized():
        if args.compressed_dp:
            raise ValueError("--compressed-dp takes a list of devices, not "
                             "a process group")
        mesh = make_elastic_mesh()
        state = shard_train_state(state, mesh)
        step = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                               mesh=mesh)
    elif args.compressed_dp:
        mesh = [dev] if args.device else make_elastic_mesh()
        dp_step = make_compressed_dp_step(cfg, mesh, opt_cfg)

        def step(state, batch):
            replicas, metrics = dp_step(replicate(state, mesh), batch)
            return replicas[0], metrics
    else:
        step = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    run = RunCfg(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every)
    state, summary = train_loop(run, state, step, source, device=dev)
    print(f"done: steps={summary['final_step']} "
          f"loss {summary['loss_first']:.4f} -> {summary['loss_last']:.4f} "
          f"stragglers={summary['stragglers']}")
    return summary


if __name__ == "__main__":
    main()
