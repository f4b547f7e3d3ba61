"""Batched serving engine: prefill (token-stepped) + greedy/sampled decode.

The engine drives :func:`repro_torch.models.model.decode_step` over a
fixed-capacity KV/SSM cache.  Batched requests of unequal prompt lengths
are right-aligned with left-padding masks folded into the cache positions
(simple token-stepped prefill: correctness first).

Serving is step-granular: :class:`Request` holds one request's cache and
token state and advances ONE model step per :meth:`Request.step` call —
prefill steps feed prompt tokens, the first generated token is sampled off
the final prefill logits, and each decode step feeds the previous sample
back.  :meth:`Engine.generate` drives a single request to completion;
``serve.batcher.BatchServer`` drives many interleaved Requests so their AP
graphs merge into shared waves.

A request that generates ``n_new`` tokens runs exactly
``s_prompt + n_new - 1`` model steps: the last sampled token is *returned*,
never fed back, so there is no trailing decode step whose output is thrown
away.

AP-backed serving: constructing the engine with ``ap_ctx`` (an
:class:`repro_torch.apc.layers.APServeContext`) routes every packed-ternary
MLP / MoE projection of every layer through the AP program-graph runtime
(one program-kernel launch per graph node, on the pool's device), and
:meth:`Engine.ap_report` returns the request's aggregated write/compare
cycles, Table XI energy, and graph-scheduler makespan.  Without it the
packed projections run on the packed-ternary matmul kernels (CUDA tensors)
or their plain version (CPU tensors).

Meshes (``Engine(..., mesh=)``): ``None`` serves on one device; a list
of one device (:func:`repro_torch.launch.mesh.make_smoke_mesh`) is that
device; a named :class:`~torch.distributed.device_mesh.DeviceMesh` (one
process per rank, every rank driving the same requests) places plain
params by the partition rules (DTensor leaves are taken as placed), each
request's cache by :func:`repro_torch.models.sharded.cache_specs`, and runs
every step through ``decode_step(..., mesh=)``; the logits are gathered
whole (``full_tensor``) before sampling, so every rank samples the same
tokens.

Sampling: greedy is ``argmax`` (the first maximum, as ``jnp.argmax``);
``temperature > 0`` draws from a ``torch.Generator`` seeded from
``(ServeCfg.seed, sample index)``, so batched serving samples what
sequential serving samples (the draws are not the JAX package's).
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ..apc import trace
from ..apc.metrics import get_registry
from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import model as M
from ..models.common import is_named_mesh, partition_spec_tree, shard_tree


@dataclass
class ServeCfg:
    max_len: int = 512
    temperature: float = 0.0       # 0 => greedy
    seed: int = 0


def _clone_tree(tree: dict) -> dict:
    """A copy of every tensor of ``tree`` (a DTensor keeps its placement:
    each rank copies its own shard)."""
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


class Request:
    """Step-granular state of one in-flight request.

    Created via :meth:`Engine.new_request`; the caller owns the execution
    context (device, ``ap_serving``, per-request AP sink) — this object
    only sequences model steps:

    - :meth:`prefill_step` x ``s_prompt`` — feed prompt token ``i`` at
      position ``i``; the last one leaves the first-token logits held.
    - :meth:`sample_first` — sample generated token 0 from those logits.
    - :meth:`decode_step` x ``n_new - 1`` — feed the last sample at its
      position, sample the next token.
    - :meth:`step` — the batcher's uniform "advance one token" move:
      dispatches to whichever of the above is due (the first-token sample
      rides along with the final prefill step, so every step() is exactly
      one model step).

    Total model steps: ``s_prompt + n_new - 1`` for ``n_new >= 1``, zero
    for ``n_new == 0``.

    ``seq``, set by a server that numbers its requests, tags the request's
    trace spans (``request``).
    """

    seq: int | None = None

    def __init__(self, engine: "Engine", prompts: np.ndarray, n_new: int,
                 cross_embeds=None):
        prompts = np.asarray(prompts)
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be [B, S], got {prompts.shape}")
        b, s_prompt = prompts.shape
        if s_prompt == 0:
            raise ValueError(
                "empty prompt (s_prompt == 0): the engine needs at least "
                "one prompt token to prefill before it can sample")
        if n_new < 0:
            raise ValueError(f"n_new must be >= 0, got {n_new}")
        self.engine = engine
        self.prompts = prompts
        self.b = b
        self.s_prompt = s_prompt
        self.n_new = n_new
        cross_len = cross_embeds.shape[1] if cross_embeds is not None else \
            (16 if engine.cfg.enc_layers else 0)
        self.cache = engine._place_cache(M.init_cache(
            engine.cfg, b, engine.serve.max_len, cross_len=cross_len,
            device=engine.device))
        self.logits = None
        self.tok = None
        self.out: list[np.ndarray] = []
        self.pos = 0                   # model steps taken so far
        self.n_model_steps = 0

    @property
    def done(self) -> bool:
        return len(self.out) >= self.n_new

    # everything step() mutates.  The cache is written IN PLACE by
    # decode_step (KV slots, SSM state), and an SSM state step is not
    # idempotent, so a checkpoint copies the cache tensors; logits and tok
    # are rebound each step, never written, so they are kept by reference
    _STEP_STATE = ("logits", "tok", "pos", "n_model_steps")

    def checkpoint(self) -> dict:
        """Snapshot the step-mutable state; the batcher takes one before
        each merged wave so a request caught in a wave abort can roll back
        and replay the step solo, bit-identically."""
        ck = {k: getattr(self, k) for k in self._STEP_STATE}
        ck["cache"] = _clone_tree(self.cache)
        ck["out"] = list(self.out)
        return ck

    def restore(self, ck: dict) -> None:
        """Roll back to a :meth:`checkpoint` (which stays valid)."""
        for k in self._STEP_STATE:
            setattr(self, k, ck[k])
        self.cache = _clone_tree(ck["cache"])
        self.out = list(ck["out"])

    def step(self) -> bool:
        """Advance one model step (+ any sampling it unlocks), as one
        ``serve.step`` span; True when the request has produced all
        ``n_new`` tokens."""
        if self.done:
            raise RuntimeError("step() on a finished request")
        prefill = self.pos < self.s_prompt
        with trace.span("serve.step", cat="serve",
                        phase="prefill" if prefill else "decode",
                        pos=self.pos, batch=self.b, request=self.seq):
            if prefill:
                self.prefill_step()
                if self.pos == self.s_prompt:
                    self.sample_first()
            else:
                self.decode_step()
        return self.done

    def prefill_step(self) -> None:
        i = self.pos
        if i >= self.s_prompt:
            raise RuntimeError("prefill already complete")
        eng = self.engine
        self.logits, self.cache = eng._step(
            eng.params, self.cache,
            torch.as_tensor(self.prompts[:, i], dtype=torch.long,
                            device=eng.device), i)
        self.pos += 1
        self.n_model_steps += 1

    def sample_first(self) -> None:
        if self.out or self.pos != self.s_prompt:
            raise RuntimeError("sample_first() wants exactly-finished "
                               "prefill and no sampled tokens yet")
        self.tok = self.engine._sample(self.logits, 0)
        self.out.append(self.tok.cpu().numpy().astype(np.int32))

    def decode_step(self) -> None:
        j = self.pos - self.s_prompt   # decode index, 0-based
        if j < 0 or self.tok is None:
            raise RuntimeError("decode_step() before prefill + first sample")
        eng = self.engine
        self.logits, self.cache = eng._step(eng.params, self.cache,
                                            self.tok, self.pos)
        self.tok = eng._sample(self.logits, j + 1)
        self.out.append(self.tok.cpu().numpy().astype(np.int32))
        self.pos += 1
        self.n_model_steps += 1

    def tokens(self) -> np.ndarray:
        """Generated ids so far, [B, n_sampled] int32 (n_sampled == n_new
        once :attr:`done`; [B, 0] when ``n_new == 0``)."""
        if not self.out:
            return np.zeros((self.b, 0), np.int32)
        return np.stack(self.out, axis=1)


class Engine:
    """Serves one model: ``params`` is a
    :func:`~repro_torch.models.model.cast_params` tree on ``device``
    (``None`` = ``cuda:0``, which raises without a card; pass ``"cpu"``
    for the plain CPU path).  Steps run eagerly; with ``ap_ctx`` every
    packed projection runs on that context's array pool.  ``mesh``: None,
    a list of one device (then ``device`` defaults to it), or a named
    ``DeviceMesh`` (then ``device`` is this rank's: the current CUDA
    device on a "cuda" mesh, else the CPU), as the module says."""

    def __init__(self, cfg: ModelConfig, params, serve: ServeCfg,
                 ap_ctx=None, slo=None, device=None, mesh=None):
        self.cfg = cfg
        self.serve = serve
        self.ap_ctx = ap_ctx
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.named = is_named_mesh(mesh)
        if self.named:
            params = shard_tree(params, partition_spec_tree(params,
                                                            mesh=mesh), mesh)
        self.params = params
        # optional live SLO monitor (serve.monitor.ServeMonitor) fed at the
        # end of every generate(); BatchServer carries its own
        if slo is not None:
            from .monitor import ServeMonitor
            self.monitor = ServeMonitor(slo)
        else:
            self.monitor = None
        # host-measured latency breakdown of the last generate() request
        # (always recorded, traced or not)
        self.last_latency: dict | None = None
        self._trace_mark = 0           # attribution slice of last request

    def device_scope(self):
        """The engine's CUDA device as the current one (a thread's own
        setting), or nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return nullcontext()

    def _place_cache(self, cache: dict) -> dict:
        """A fresh (zero) cache as DTensors placed by ``cache_specs`` on a
        named mesh, each rank slicing its own copy (no communication);
        as it is otherwise."""
        if not self.named:
            return cache
        from ..models.sharded import cache_specs
        return shard_tree(cache, cache_specs(self.cfg, cache, self.mesh),
                          self.mesh, src_data_rank=None)

    def _step(self, params, cache, tokens, pos: int):
        """One model step: (logits [B, V] whole, on this rank's device;
        the cache, written in place)."""
        with torch.no_grad():
            if not self.named:
                return M.decode_step(self.cfg, params, cache, tokens, pos)
            logits, cache = M.decode_step(self.cfg, params, cache, tokens,
                                          pos, mesh=self.mesh)
            return logits.full_tensor(), cache

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def new_request(self, prompts: np.ndarray, n_new: int,
                    cross_embeds=None) -> Request:
        """Validate + allocate the step-granular state of one request
        (raises ValueError on an empty prompt or negative ``n_new``)."""
        return Request(self, prompts, n_new, cross_embeds)

    def generate(self, prompts: np.ndarray, n_new: int,
                 cross_embeds=None) -> np.ndarray:
        """prompts [B, S_prompt] int32 (pad id 0 on the LEFT); returns
        [B, n_new] generated ids ([B, 0] for ``n_new == 0``).

        Runs exactly ``s_prompt + n_new - 1`` model steps (``n_new >= 1``);
        the recorded ``last_latency`` buckets satisfy
        ``prefill_ms + decode_ms + other_ms == request_ms``.
        """
        prompts = np.asarray(prompts)
        b, s_prompt = prompts.shape
        if self.ap_ctx is not None:
            from ..apc.layers import ap_serving
            self.ap_ctx.reset()            # per-request aggregation
            ap_guard = ap_serving(self.ap_ctx)
        else:
            ap_guard = nullcontext()
        tracer = trace.current_tracer()
        self._trace_mark = (tracer.attribution_mark()
                            if tracer is not None else 0)
        reg = get_registry()
        n_decode = max(0, n_new - 1)
        t_req = time.perf_counter()
        with self.device_scope(), ap_guard, \
                trace.span("request", cat="serve", batch=b,
                           prompt_len=s_prompt, n_new=n_new,
                           ap=self.ap_ctx is not None):
            req = self.new_request(prompts, n_new, cross_embeds)
            t_setup = time.perf_counter()
            if n_new == 0:
                # nothing to sample: zero model steps, empty [B, 0] result
                t_prefill = t_sample = t_decode = t_setup
            else:
                with trace.span("prefill", cat="serve", steps=s_prompt):
                    for _ in range(s_prompt):
                        req.prefill_step()
                    self._sync()
                t_prefill = time.perf_counter()
                req.sample_first()         # token 0, off prefill logits
                t_sample = time.perf_counter()
                for _ in range(n_decode):
                    t0 = time.perf_counter()
                    req.step()             # a decode step, host-synced
                    reg.histogram("serve.decode_step_ms").observe(
                        1e3 * (time.perf_counter() - t0))
                t_decode = time.perf_counter()
            out = req.tokens()
        t_end = time.perf_counter()
        setup_ms = 1e3 * (t_setup - t_req)
        sample_ms = 1e3 * (t_sample - t_prefill)
        finalize_ms = 1e3 * (t_end - t_decode)
        # contiguous boundary timestamps: the three headline buckets
        # partition [t_req, t_end], so they sum to request_ms exactly
        self.last_latency = {
            "request_ms": 1e3 * (t_end - t_req),
            "prefill_ms": 1e3 * (t_prefill - t_setup),
            "decode_ms": 1e3 * (t_decode - t_sample),
            "other_ms": setup_ms + sample_ms + finalize_ms,
            "setup_ms": setup_ms,
            "sample_ms": sample_ms,
            "finalize_ms": finalize_ms,
            "n_prefill_steps": s_prompt if n_new else 0,
            "n_decode_steps": n_decode if n_new else 0,
            "n_model_steps": req.n_model_steps,
        }
        reg.counter("serve.requests").inc()
        reg.histogram("serve.request_ms").observe(1e3 * (t_end - t_req))
        if self.monitor is not None:
            peak_w = None
            if self.ap_ctx is not None and self.ap_ctx.n_graphs > 0:
                # report() flushes the sink's deferred power joins
                peak_w = self.ap_ctx.report()["power"]["peak_w"]
            self.monitor.observe_request(1e3 * (t_end - t_req),
                                         power_peak_w=peak_w)
        return out

    def ap_report(self) -> dict | None:
        """Aggregated AP accounting of the last :meth:`generate` request:
        write/compare cycles, sets/resets, Table XI energy, the graph
        scheduler's makespan vs naive sequential drains, compile/serving
        cache occupancy (``cache``), the host latency breakdown
        (``latency``), and — when a tracer was active during the request —
        the per-phase cycle/energy attribution (``phases``).

        None when the engine serves without an AP context.  Raises when an
        AP context IS configured but the last request never routed a
        projection through it (``n_graphs == 0``) — that means the request
        silently bypassed ``ap_serving`` (no packed-ternary MLP/MoE params
        in this config, or :meth:`generate` has not run), and a silent
        all-zero report would be misread as a free request.
        """
        if self.ap_ctx is None:
            return None
        if self.ap_ctx.n_graphs == 0:
            raise RuntimeError(
                "Engine has ap_ctx configured but the last request served "
                "no AP projections (n_graphs == 0): either generate() has "
                "not run yet, or the model config carries no packed-ternary "
                "MLP/MoE params so every projection bypassed ap_serving. "
                "Enable ternary packing in the model config (cfg.ternary."
                "enabled) or drop ap_ctx to serve on the float path.")
        rep = self.ap_ctx.report()
        rep["cache"] = self.ap_ctx.cache_stats()
        rep["latency"] = self.last_latency
        tracer = trace.current_tracer()
        if tracer is not None:
            from ..apc.layers import N_MASKED_MAC
            from ..core.ap import APStats
            from ..core.energy import energy_from_stats
            mark = getattr(self, "_trace_mark", 0)
            phases = {}
            for phase, tot in tracer.phase_totals(start=mark).items():
                st = APStats(radix=self.ap_ctx.radix)
                st.sets, st.resets = tot["sets"], tot["resets"]
                st.n_compare_cycles = tot["compare_cycles"]
                st.n_write_cycles = tot["write_cycles"]
                h = np.asarray(tot["mismatch_hist"],
                               np.int64)[:len(st.mismatch_hist)]
                st.mismatch_hist[:len(h)] = h
                e = energy_from_stats(st, n_masked=N_MASKED_MAC)
                phases[phase] = dict(tot, energy_total_j=e.total_j)
            rep["phases"] = phases
        return rep

    def _sample(self, logits: torch.Tensor, index: int) -> torch.Tensor:
        """Token ids [B] (int64 on the logits' device): greedy argmax, or a
        draw at ``temperature`` from a generator seeded from
        ``(seed, index)``, ``index`` 0 for the first sampled token."""
        if self.serve.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        seed = int(np.random.SeedSequence(
            [self.serve.seed, index]).generate_state(1)[0])
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(seed)
        probs = torch.softmax(logits.to(torch.float32)
                              / self.serve.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]


def mesh_device(mesh, device) -> torch.device:
    """The device an engine on ``mesh`` serves from (see :class:`Engine`);
    raises where ``device`` contradicts the mesh."""
    if mesh is None:
        return resolve_device(device)
    if isinstance(mesh, (list, tuple)):
        if len(mesh) != 1:
            raise ValueError(
                f"a list mesh serves on one device, got {len(mesh)}; a "
                f"mesh of several ranks is a named DeviceMesh")
        dev = resolve_device(mesh[0])
    elif is_named_mesh(mesh):
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
    else:
        raise TypeError(f"mesh must be None, a list of one device or a "
                        f"named DeviceMesh, got {type(mesh).__name__}")
    want = None if device is None else resolve_device(device)
    if want is not None and want.type == "cuda" and want.index is None:
        want = torch.device("cuda", torch.cuda.current_device())
    if want is not None and want != dev:
        raise ValueError(f"device {device} is not the mesh's {dev}")
    return dev
