"""Closed-loop clients: each submits a request, waits for its tokens, and
submits the next, until the window's deadline.

Traffic parameters (the cell's file): ``clients``, ``batch`` sequences a
request, ``prompt_len`` prompt tokens, ``new_tokens`` greedy tokens,
``vocab_low`` (ids are drawn from ``[vocab_low, vocab)``).  Every request
has the same sizes; the prompts are drawn from ``(seed, client)``, so a
seed changes the tokens and never the work.

The clients start together at ``t0``; none submits after
``t0 + seconds``; the window closes when the last request submitted
before the deadline has returned (each client submits at least one).
"""
from __future__ import annotations

import threading
import time

import numpy as np


def _rng(seed: int, client: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), client]))


def run(system, traffic: dict, seed: int, seconds: float,
        vocab: int) -> dict:
    """Drive ``system`` (``submit(prompts, n_new) -> handle``, ``timing(
    prompts) -> dict``) and return ``{"t0", "t_end", "records"}``; a record
    per request: prompts, tokens (None if it failed), its AP report (None
    on the float route), error, submit and return times, and the
    request's token and step times."""
    n = int(traffic["clients"])
    b, s = int(traffic["batch"]), int(traffic["prompt_len"])
    n_new = int(traffic["new_tokens"])
    low = int(traffic.get("vocab_low", 1))
    go = threading.Event()
    records: list[list[dict]] = [[] for _ in range(n)]
    clock = {}

    def client(i: int) -> None:
        rng = _rng(seed, i)
        go.wait()
        deadline = clock["t0"] + seconds
        while True:
            prompts = rng.integers(low, vocab, size=(b, s), dtype=np.int32)
            rec = {"client": i, "prompts": prompts, "tokens": None,
                   "error": None, "submitted": time.perf_counter()}
            try:
                h = system.submit(prompts, n_new)
                rec["tokens"] = np.asarray(h.result())
                rec["ap_report"] = h.ap_report()
            except Exception as e:           # a failed request is counted
                rec["error"] = f"{type(e).__name__}: {e}"
            rec["returned"] = time.perf_counter()
            rec.update(system.timing(prompts))
            records[i].append(rec)
            if rec["returned"] >= deadline or rec["error"] is not None:
                return

    threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                name=f"portbench-client{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    clock["t0"] = time.perf_counter()
    go.set()
    for t in threads:
        t.join()
    flat = [r for rs in records for r in rs]
    return {"t0": clock["t0"], "t_end": max(r["returned"] for r in flat),
            "records": flat}
