"""The comparison that decides ``correct``: served greedy tokens held
against the plain reference's logits.

For every served token, the gap by which the reference's logit of that
token lies below the reference's best logit at its position.  The widest
gap over the sample is the number compared (``logit_gap``).  With
``control``, the reference is also computed in that lower precision and
the gap of the token it puts first is read at the same positions: the
reading a control must fail.

The reference makes its weights again from the seed, one layer at a time,
and takes none of the program's: the configuration's family
(:mod:`portbench.families`) gives the weights and the reference's
forward passes.  Imports neither JAX nor the program.
"""
from __future__ import annotations

import numpy as np
import torch

from ..weights import DTYPES


# rows of the float route's reference a pass: at qwen2-72b's widths 32
# rows of 384 positions hold 7.5 GB of fp32 logits
CHUNK_ROWS = 32


def _groups(serve: dict, samples: list) -> list:
    """On the AP route a step's input is quantized over the request's
    sequences, so each sampled request runs alone and whole; on the float
    route the rows are independent and run in batches of
    ``CHUNK_ROWS``."""
    if serve.get("route") == "ap":
        return samples
    prompts = np.concatenate([p for p, _ in samples])
    served = np.concatenate([s for _, s in samples])
    return [(prompts[i:i + CHUNK_ROWS], served[i:i + CHUNK_ROWS])
            for i in range(0, len(prompts), CHUNK_ROWS)]


def read_gaps(family, model: dict, serve: dict, seed: int, device,
              samples: list, control: str | None = None,
              cache_len: int = 0) -> dict:
    """``family``: the configuration's family module, which gives the
    weights and the forward passes.  ``samples``: ``(prompts [B, S],
    served [B, N])`` int arrays, all of one shape.  Returns ``logit_gap``
    (widest), ``mean_gap``, ``mismatch`` (share of served tokens that are
    not the reference's first), ``tokens``, and with ``control`` the same
    three read at the control's first tokens (``control_logit_gap``,
    ``control_mean_gap``, ``control_mismatch``).  On the AP route the
    reference takes the positions one at a time through a cache of
    ``cache_len`` slots (the family's ``logits_stepwise``), elsewhere
    whole."""
    dtype = DTYPES[model.get("param_dtype", "float32")]
    top = family.top_params(model, seed, device, dtype)
    small = family.keeps_layer_weights(model)
    cache: dict = {}

    def layer_fn(i):
        if i in cache:
            return cache[i]
        p = family.layer_params(model, seed, i, device, dtype)
        if small:
            cache[i] = p
        return p

    if serve.get("route") == "ap":
        def forward(*a, **kw):
            return family.logits_stepwise(*a, cache_len=cache_len, **kw)
    else:
        forward = family.logits
    out = {"logit_gap": 0.0, "mean_gap": 0.0, "mismatch": 0.0, "tokens": 0}
    if control:
        out["control_logit_gap"] = 0.0
    total, wrong, c_total, c_wrong = 0.0, 0, 0.0, 0
    for prompts, served in _groups(serve, samples):
        first = prompts.shape[1] - 1
        tok = torch.as_tensor(np.concatenate([prompts, served[:, :-1]],
                                             axis=1), dtype=torch.long,
                              device=device)
        want = torch.as_tensor(served, dtype=torch.long, device=device)
        ref = forward(model, serve, layer_fn, top, tok, first)
        best = ref.amax(-1)
        gap = best - ref.gather(-1, want[..., None])[..., 0]
        out["logit_gap"] = max(out["logit_gap"], float(gap.max()))
        total += float(gap.double().sum())
        wrong += int((ref.argmax(-1) != want).sum())
        out["tokens"] += want.numel()
        if control:
            ctl = forward(model, serve, layer_fn, top, tok, first,
                          precision=control).argmax(-1)
            gc = best - ref.gather(-1, ctl[..., None])[..., 0]
            out["control_logit_gap"] = max(out["control_logit_gap"],
                                         float(gc.max()))
            c_total += float(gc.double().sum())
            c_wrong += int((gc > 0).sum())
            del ctl
        del ref
    n = max(1, out["tokens"])
    out["mean_gap"], out["mismatch"] = total / n, wrong / n
    if control:
        out["control_mean_gap"] = c_total / n
        out["control_mismatch"] = c_wrong / n
    return out
