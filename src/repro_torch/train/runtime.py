"""Training runtime: loop, fault tolerance, straggler watchdog.

The port of :mod:`repro.train.runtime`:
  * resume-from-latest on start (the data pipeline is seekable by step and
    the checkpoint holds params + optimizer + step, so a restart re-enters
    the loop bit-exactly);
  * a SIGTERM/SIGINT handler makes an emergency checkpoint (preemption)
    before the loop exits;
  * a step-time watchdog flags stragglers (step > straggler_factor x the
    running median) and counts them.

Each step's batch is copied from numpy to the state's device, and the
step is timed on the host clock up to the loss on the host (a sync).
"""
from __future__ import annotations

import logging
import os
import signal
import statistics
import tempfile
import time
from dataclasses import dataclass, field

import torch

from ..device import resolve_device
from . import checkpoint as ckpt_lib
from .optimizer import tree_leaves

log = logging.getLogger("repro_torch.runtime")


@dataclass
class RunCfg:
    total_steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0


@dataclass
class Watchdog:
    factor: float = 3.0
    window: list = field(default_factory=list)
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.window) >= 8:
            med = statistics.median(self.window)
            if dt > self.factor * med:
                self.stragglers += 1
                slow = True
                log.warning("straggler step: %.3fs vs median %.3fs", dt, med)
        self.window.append(dt)
        if len(self.window) > 64:
            self.window.pop(0)
        return slow


def train_loop(run: RunCfg, state, step_fn, source, device=None,
               start_step: int | None = None) -> tuple[dict, dict]:
    """Run (or resume) training.  Returns (state, summary).

    A checkpoint in ``run.ckpt_dir`` is restored onto ``device``; ``None``
    means the given state's device, or ``cuda:0`` when ``state`` is None.
    The summary holds the reference's keys and ``step_seconds``, the host
    time of every step taken."""
    if device is None and state is not None:
        device = tree_leaves(state)[0].device
    dev = resolve_device(device)
    # ---- resume -----------------------------------------------------------
    latest = ckpt_lib.latest_step(run.ckpt_dir)
    if start_step is None:
        if latest is not None:
            state = ckpt_lib.restore(run.ckpt_dir, latest, device=dev)
            start_step = int(latest)
            log.info("resumed from step %d", start_step)
        else:
            start_step = 0

    # ---- preemption handler ------------------------------------------------
    preempted = {"flag": False}

    def on_signal(signum, frame):
        preempted["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:          # non-main thread (tests)
            pass

    watch = Watchdog(run.straggler_factor)
    losses, seconds = [], []
    step = start_step
    try:
        while step < run.total_steps:
            batch = source.batch_at(step)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))     # waits for the step
            seconds.append(time.perf_counter() - t0)
            watch.observe(seconds[-1])
            step += 1
            if step % run.log_every == 0:
                log.info("step %d loss %.4f", step, losses[-1])
            if step % run.ckpt_every == 0:
                ckpt_lib.save(run.ckpt_dir, step, state,
                              keep_last=run.keep_last)
            if preempted["flag"]:
                log.warning("preemption signal: emergency checkpoint @%d",
                            step)
                ckpt_lib.save(run.ckpt_dir, step, state, emergency=True)
                break
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    summary = {"final_step": step, "losses": losses,
               "stragglers": watch.stragglers,
               "loss_first": losses[0] if losses else None,
               "loss_last": losses[-1] if losses else None,
               "step_seconds": seconds}
    return state, summary
