"""Token data pipeline: synthetic + file-backed, seekable, sharded, prefetched.

A copy of :mod:`repro.data.pipeline` (plain numpy, no framework): the same
seeds give the same batches bit for bit.  Batches are numpy arrays; the
training loop copies them to the device.

Restart-exactness: ``batch_at(step)`` is a pure function of (seed, step), so
resuming from a checkpoint at step k replays the identical stream.
Multi-host sharding: each process materializes only its slice of the global
batch (process_index/process_count), ``global_batch // n_hosts`` rows.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class DataCfg:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    path: str | None = None        # file-backed: flat uint16 token file


class TokenSource:
    """Deterministic, seekable token batches."""

    def __init__(self, cfg: DataCfg, process_index: int = 0,
                 process_count: int = 1):
        self.cfg = cfg
        if cfg.global_batch % process_count:
            raise ValueError("global_batch must divide evenly across hosts")
        self.local_batch = cfg.global_batch // process_count
        self.process_index = process_index
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=np.uint16, mode="r")

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """-> {tokens [local_batch, S], targets [local_batch, S]}, int32."""
        cfg = self.cfg
        b, s = self.local_batch, cfg.seq_len
        if self._mm is not None:
            n_tok = self._mm.shape[0]
            # contiguous windows, strided by step and host, wrap-around
            start = (step * cfg.global_batch + self.process_index * b) \
                * (s + 1)
            idx = (start + np.arange(b)[:, None] * (s + 1)
                   + np.arange(s + 1)[None, :]) % (n_tok - 1)
            window = np.asarray(self._mm[idx], dtype=np.int32)
        else:
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, self.process_index]))
            window = rng.integers(0, cfg.vocab, size=(b, s + 1),
                                  dtype=np.int32)
        return {"tokens": window[:, :-1], "targets": window[:, 1:]}


class Prefetcher:
    """Bounded background prefetch — the straggler-mitigation buffer: a slow
    host keeps computing from the queue while its loader catches up."""

    def __init__(self, source: TokenSource, start_step: int, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            batch = self.source.batch_at(self._step)
            while not self._stop.is_set():
                try:
                    self.q.put((self._step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self._step += 1

    def next(self) -> tuple[int, dict[str, np.ndarray]]:
        return self.q.get()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
