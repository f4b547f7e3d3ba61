"""AP-backed model layers: ternary projections through the graph runtime.

The serving story of the paper's AP, as :mod:`repro.apc.layers` of the JAX
package tells it: every ternary projection of a model (``models/mlp.py``
SwiGLU, ``models/moe.py`` experts) is a ternary matmul, every ternary
matmul is a K-tiled MAC program, and *independent* projections — the gate
and up projections of one MLP, the experts of one MoE layer — are
independent subgraphs of ONE :class:`~repro_torch.apc.graph.ProgramGraph`,
so the runtime interleaves their tile programs across the array bank
instead of draining them one by one.

- :class:`APLinear` — one projection ``y = (x @ w_ter) * w_scale`` with a
  per-(radix, K, width, k_tile) compiled-program cache
  (:func:`~repro_torch.apc.mac.compile_mac_tiled` is lru-cached; every
  request replays the same TiledMac).
- :class:`APServeContext` — per-request aggregation: one
  :class:`~repro_torch.core.ap.APStats` across every AP-served projection,
  graph makespan/sequential totals from the occupancy model, and a Table
  XI energy report.  Activations quantize to a signed integer grid
  (``x_levels``) per call — the AP computes exact integer dot products on
  the quantized activations; fidelity is the quantization's, exactness
  the AP's.
- :func:`ap_moe_dispatch` — sort tokens to experts and run every expert's
  projections as independent nodes of one graph.
- :func:`ap_serving` — context manager the serve engine uses to flip
  ``models.mlp.mlp`` / ``models.moe.moe_ffn`` onto the AP path without
  threading a runtime handle through the whole model stack.
- :func:`plain_ap_projections` — inside it, every projection computes its
  integer product directly instead of running its graph: the plain route
  the AP route's logits are held against, bit for bit.

Every graph node is one program-kernel launch on the pool's device
(``Runtime.run_graph`` -> ``ArrayPool.run``); there is no other route and
no fallback: a failed launch raises.
"""
from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.ap import APStats
from ..core.energy import energy_from_stats
from ..kernels.ternary_matmul.ref import quantize_ternary, unpack_ternary
from . import trace
from .caches import ResidentHandle, ResidentStore
from .graph import ProgramGraph
from .mac import (compile_mac_tiled, decode_signed_digits_jnp,
                  encode_weight_digits_jnp, mac_acc_width,
                  mac_weight_support, matmul_mac_rows, weight_digest)
from .metrics import get_registry
from .power import PowerAccum, graph_power
from .runtime import Runtime

__all__ = ["APCall", "APLinear", "APServeContext", "APSink",
           "ap_moe_dispatch", "ap_serving", "ap_request_scope",
           "current_ap_context", "plain_ap_projections", "N_MASKED_MAC"]

# compare-key mask width of the MAC sweeps: 3 LUT columns + 1 weight
# predicate column (what the Table XI matchline model charges per compare)
N_MASKED_MAC = 4

_PLAIN_AP: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("plain_ap_projections", default=False)


@contextmanager
def plain_ap_projections():
    """Inside, every :class:`APLinear` call computes ``x_int @ w_ter``
    directly (float64, exact for these integers) and then
    :meth:`APCall.decode`'s scaling, in place of the graph run: no graph
    runs, no program kernel launches, nothing is charged to a sink.  The
    accumulator is the AP's exact integer dot product, so the AP route's
    outputs must equal this route's bit for bit.  For tests and
    ``chip_smoke.py``."""
    token = _PLAIN_AP.set(True)
    try:
        yield
    finally:
        _PLAIN_AP.reset(token)


class APCall(NamedTuple):
    """Handle to one projection added to a graph: decode after the run.
    ``acc`` holds the plain route's integer accumulator [T*N] (then
    ``node`` is -1 and the results are not read)."""
    node: int
    radix: int
    t: int
    n: int
    w_scale: torch.Tensor
    acc: torch.Tensor | None = None

    def decode(self, results, x_scale) -> torch.Tensor:
        acc = self.acc if self.acc is not None else \
            decode_signed_digits_jnp(results[self.node], self.radix)
        y = acc.reshape(self.t, self.n).to(torch.float32)
        return y * torch.as_tensor(x_scale, dtype=torch.float32,
                                   device=y.device) * self.w_scale[None, :]


class APLinear:
    """One ternary projection served by the AP runtime.

    ``w_ter`` [K, N] in {-1, 0, +1}, ``w_scale`` [N] float (absmean
    per-channel scale, as produced by :func:`quantize_ternary`), both on
    the device the projection runs on.

    ``sparse`` (default on) compiles the projection's MAC against the
    weights' per-k digit support (:func:`~repro_torch.apc.mac.
    mac_weight_support`), pruning every add/sub sweep whose predicate
    digit never occurs — bit-exact by construction, since the pruned
    sweeps could not have matched any of this projection's rows.

    ``store`` (weight-stationary dataflow): a
    :class:`~repro_torch.apc.caches.ResidentStore` to pin the weight digit
    plane into at construction; every subsequent call slices the
    resident plane instead of re-encoding weight columns (:meth:`pin`
    attaches a store later — ``__call__`` auto-pins into the serving
    context's pool store).

    Construction copies the weights to the host once (the support mask and
    the content digest are host work).
    """

    def __init__(self, w_ter, w_scale, *, radix: int = 3, label: str = "",
                 store: ResidentStore | None = None, sparse: bool = True):
        self.w_ter = torch.as_tensor(w_ter).to(torch.int8)
        self.w_scale = torch.as_tensor(w_scale).to(
            device=self.w_ter.device, dtype=torch.float32)
        self.kp, self.n = self.w_ter.shape
        self.radix = radix
        self.label = label
        self.sparse = sparse
        wT = self.w_ter.T.cpu().numpy()                # [N, K'] row plane
        self._support = mac_weight_support(wT)
        self._digest = weight_digest(wT)
        self._n_zero = int((wT == 0).sum())
        self._n_weights = int(wT.size)
        self._res_key = f"lin:{label}" if label else f"lin:{self._digest}"
        self._store: ResidentStore | None = None
        self._handle: ResidentHandle | None = None
        if store is not None:
            self.pin(store)

    def _plane_fn(self) -> torch.Tensor:
        # the ONE weight-side encode of the weight-stationary dataflow:
        # runs on a pin miss only (bumps the mac.weight_encodes counter)
        return encode_weight_digits_jnp(self.w_ter.T)

    def pin(self, store: ResidentStore) -> ResidentHandle:
        """Write this projection's weight digit plane into ``store``
        (content-keyed get-or-put) and serve subsequent calls from it."""
        self._store = store
        self._handle = store.pin(self._res_key, self._digest,
                                 self._plane_fn)
        return self._handle

    @property
    def weight_sparsity(self) -> float:
        """Measured zero fraction of the ternary weights."""
        return self._n_zero / max(1, self._n_weights)

    @classmethod
    def from_packed(cls, packed: torch.Tensor, scale: torch.Tensor,
                    **kw) -> "APLinear":
        """From the 16-per-int32 packed serving weights."""
        return cls(unpack_ternary(packed, dtype=torch.int8), scale, **kw)

    @classmethod
    def from_dense(cls, w, **kw) -> "APLinear":
        """Quantize a dense float matrix to balanced ternary + scale."""
        w_ter, scale = quantize_ternary(
            torch.as_tensor(w).to(torch.float32))
        return cls(w_ter, scale, **kw)

    def __repr__(self) -> str:
        return (f"APLinear({self.kp}x{self.n}, radix={self.radix}"
                f"{', ' + self.label if self.label else ''})")

    def add_call(self, graph: ProgramGraph, x_int: torch.Tensor, *,
                 max_cols: int, max_q: int, k_tile: int | None = None
                 ) -> APCall:
        """Add this projection on ``x_int`` [T, K] (|x| <= max_q) to the
        graph as a K-tiled MAC over all T*N output rows; returns the
        decode handle.  Under :func:`plain_ap_projections` nothing is
        added: the handle carries the product itself."""
        from ..kernels.ternary_matmul.ap import default_k_tile
        t, k = x_int.shape
        if k > self.kp:
            raise ValueError(f"x has K={k}, projection K'={self.kp}")
        if k < self.kp:                   # pack-time padding rows: w == 0
            x_int = F.pad(x_int, (0, self.kp - k))
        if _PLAIN_AP.get():
            acc = (x_int.to(torch.float64)
                   @ self.w_ter.to(torch.float64)).to(torch.int32)
            return APCall(-1, self.radix, t, self.n, self.w_scale,
                          acc.reshape(-1))
        width = mac_acc_width(self.radix, self.kp, max_q)
        kt = k_tile if k_tile is not None else default_k_tile(max_cols,
                                                              width)
        tiled = compile_mac_tiled(
            self.radix, self.kp, width, min(kt, self.kp), max_cols=max_cols,
            support=self._support if self.sparse else None)
        resident = None
        if self._store is not None:
            # re-pin (get-or-put): a hit returns the live handle with zero
            # encode work, an eviction transparently re-encodes once
            prev = self._handle
            resident = self._store.pin(self._res_key, self._digest,
                                       self._plane_fn)
            self._handle = resident
            graph.bump("resident_hits" if resident is prev
                       else "resident_misses", 1)
        else:
            graph.bump("resident_misses", 1)
        graph.bump("weight_zeros", self._n_zero)
        graph.bump("weight_digits", self._n_weights)
        if resident is None:
            x_rows, w_rows = matmul_mac_rows(x_int, self.w_ter)  # [T*N, K']
        else:
            # weight rows come from the resident plane (same matmul_mac_rows
            # ordering: row t*N + n holds w_ter.T[n]) — never materialized
            x_rows, w_rows = torch.repeat_interleave(x_int, self.n,
                                                     dim=0), None
        node = graph.add_mac_tiled(x_rows, w_rows, tiled,
                                   label=f"{self.label}:" if self.label
                                   else "", resident=resident,
                                   charge_upload=True)
        return APCall(node, self.radix, t, self.n, self.w_scale)

    def __call__(self, x: torch.Tensor, ctx: "APServeContext"
                 ) -> torch.Tensor:
        """Standalone projection: quantize, one-node graph, run, decode.

        Auto-pins the weights into the context pool's resident store on
        first use, so repeat calls are weight-stationary."""
        if self._store is None:
            store = getattr(ctx.runtime.pool, "resident", None)
            if store is not None:
                self.pin(store)
        graph = ProgramGraph()
        x_int, s = ctx.quantize(x)
        call = self.add_call(graph, x_int, max_cols=ctx.max_cols,
                             max_q=ctx.x_levels)
        res = ctx.run_graph(graph)
        return call.decode(res, s).to(x.dtype)


class APSink:
    """Per-request aggregation target: one :class:`APStats` plus the
    occupancy-model totals (makespan/sequential cycles and ns) and graph
    counts a request accumulates across its AP-served projections.

    A sequential :class:`APServeContext` owns one default sink; the
    continuous-batching path (``serve/batcher.py``) gives every in-flight
    request its own sink via :func:`ap_request_scope`, so many requests can
    share one context (and one merged graph run) while keeping bit-exact
    per-request accounting.
    """

    # builder-side meta counters folded from ProgramGraph.meta: sparsity
    # pruning totals + resident-bank hit tracking + measured weight zeros
    META_KEYS = ("pruned_write_cycles", "pruned_compare_cycles",
                 "emitted_passes", "pruned_passes",
                 "resident_hits", "resident_misses",
                 "weight_zeros", "weight_digits")

    def __init__(self, radix: int = 3):
        self.radix = radix
        self.reset()

    def reset(self) -> None:
        self.stats = APStats(radix=self.radix)
        self.makespan_cycles = 0
        self.sequential_cycles = 0
        self.makespan_ns = 0.0
        self.sequential_ns = 0.0
        self.n_graphs = 0
        self.n_programs = 0
        for k in self.META_KEYS:
            setattr(self, k, 0)
        # per-request power rollup: per-array Table XI energy + busy time
        # + peak W, folded from every graph run's (schedule, counters) join
        self.power = PowerAccum(radix=self.radix, n_masked=N_MASKED_MAC)
        # deferred counter attributions: (traced, compiled, n_rows, label).
        # The batcher defers the device->host counter sync so the host can
        # encode wave k+1 while wave k's launches drain; flush() settles
        # them into ``stats`` (report() flushes implicitly).
        self._deferred: list[tuple] = []
        # deferred power joins: (schedule, traced_map, labels, n_arrays) —
        # same deferred-sync contract as ``_deferred``
        self._deferred_power: list[tuple] = []

    def defer(self, traced, compiled, n_rows: int, label: str = "") -> None:
        """Queue one traced-counter attribution without syncing the device."""
        self._deferred.append((traced, compiled, n_rows, label))

    def defer_power(self, schedule: list, traced: dict, labels: dict,
                    n_arrays_local: int) -> None:
        """Queue one graph run's power join (schedule intervals + per-node
        counters) without syncing the device."""
        self._deferred_power.append((schedule, traced, labels,
                                     n_arrays_local))

    def flush(self) -> None:
        """Settle deferred attributions into ``stats`` (host sync)."""
        from .stats import accumulate
        pend, self._deferred = self._deferred, []
        for traced, compiled, n_rows, label in pend:
            accumulate(self.stats, traced, compiled, n_rows, label=label)
        pend_p, self._deferred_power = self._deferred_power, []
        for schedule, traced, labels, nal in pend_p:
            self.power.add(graph_power(
                schedule, traced, radix=self.radix, n_masked=N_MASKED_MAC,
                n_arrays_local=nal, labels=labels))

    # everything a merged serve WAVE can mutate: the occupancy scalars +
    # meta counters (add_report/add_meta) and the deferred lists (defer/
    # defer_power).  stats and power only move at flush(), which the
    # batcher never calls mid-wave — so a scalar snapshot + list lengths
    # is a complete wave-granular checkpoint.
    _WAVE_SCALARS = ("makespan_cycles", "sequential_cycles", "makespan_ns",
                     "sequential_ns", "n_graphs", "n_programs") + META_KEYS

    def checkpoint(self) -> tuple:
        """Snapshot the wave-mutable state (see ``_WAVE_SCALARS``): the
        batcher takes one before each merged wave so an aborted sibling
        can roll back and re-run solo without double-charging."""
        scalars = {k: getattr(self, k) for k in self._WAVE_SCALARS}
        return (scalars, len(self._deferred), len(self._deferred_power))

    def restore(self, ck: tuple) -> None:
        """Roll back to a :meth:`checkpoint` (scalars reset, deferred
        lists truncated to their checkpointed lengths)."""
        scalars, n_def, n_pow = ck
        for k, v in scalars.items():
            setattr(self, k, v)
        del self._deferred[n_def:]
        del self._deferred_power[n_pow:]

    def add_report(self, report: dict) -> None:
        """Fold one graph run's occupancy report into the totals."""
        self.makespan_cycles += report["makespan_cycles"]
        self.sequential_cycles += report["sequential_cycles"]
        self.makespan_ns += report["makespan_ns"]
        self.sequential_ns += report["sequential_ns"]
        self.n_graphs += 1
        self.n_programs += report["n_nodes"]

    def add_meta(self, meta: dict) -> None:
        """Fold one graph's builder-side meta (sparsity + residency)."""
        for k in self.META_KEYS:
            setattr(self, k, getattr(self, k) + meta.get(k, 0))

    def report(self, n_masked: int = N_MASKED_MAC) -> dict:
        """Aggregated per-request accounting: functional-simulator counters
        + Table XI energy + graph-scheduler occupancy + sparsity/residency
        attribution (pruned vs emitted passes, resident-bank hit rate)."""
        self.flush()
        rep = energy_from_stats(self.stats, n_masked=n_masked)
        total_pins = self.resident_hits + self.resident_misses
        return {
            "write_cycles": self.stats.n_write_cycles,
            "compare_cycles": self.stats.n_compare_cycles,
            "sets": int(self.stats.sets),
            "resets": int(self.stats.resets),
            "energy_write_j": rep.write_energy_j,
            "energy_compare_j": rep.compare_energy_j,
            "energy_total_j": rep.total_j,
            "makespan_cycles": self.makespan_cycles,
            "sequential_cycles": self.sequential_cycles,
            "makespan_ns": self.makespan_ns,
            "sequential_ns": self.sequential_ns,
            "n_graphs": self.n_graphs,
            "n_programs": self.n_programs,
            "pruned_write_cycles": self.pruned_write_cycles,
            "pruned_compare_cycles": self.pruned_compare_cycles,
            "emitted_passes": self.emitted_passes,
            "pruned_passes": self.pruned_passes,
            "resident_hits": self.resident_hits,
            "resident_misses": self.resident_misses,
            "resident_hit_rate": (self.resident_hits / total_pins
                                  if total_pins else 0.0),
            "weight_sparsity": (self.weight_zeros / self.weight_digits
                                if self.weight_digits else 0.0),
            # per-array power rollup; its energy_j is the SAME integer
            # counters priced through the SAME Table XI conversion as
            # energy_total_j, so the two agree bit-exactly
            "power": self.power.report(),
        }


class APServeContext:
    """Per-request AP serving state: runtime + aggregated stats/energy.

    ``x_levels`` is the activation quantization grid (|x_int| <= x_levels,
    e.g. 7 = a signed 4-level-per-sign 3-bit grid); the AP arithmetic on
    the quantized integers is exact, so output fidelity is set entirely by
    this knob.  ``reset()`` starts a fresh request; ``report()`` renders
    the aggregate as write/compare cycles, Table XI energy, and the
    occupancy model's makespan vs naive sequential drains.
    """

    def __init__(self, runtime: Runtime, *, radix: int = 3,
                 x_levels: int = 7, max_cols: int | None = None):
        self.runtime = runtime
        self.radix = radix
        self.x_levels = int(x_levels)
        self.max_cols = max_cols if max_cols is not None \
            else runtime.pool.cols
        # weight -> APLinear cache, id()-keyed with the source tensor pinned
        # in the value; FIFO-capped like ArrayPool._schedules so a caller
        # feeding fresh tensors per request cannot grow it without bound
        self._linears: dict = {}
        self._max_linears = 64
        self._default_sink = APSink(radix=self.radix)

    def reset(self) -> None:
        self._default_sink.reset()

    def _sink(self) -> APSink:
        scope = _AP_SCOPE.get()
        return self._default_sink if scope is None else scope[0]

    # Aggregates read the *active* sink, so engine/report code written for
    # the sequential one-request-per-context contract keeps working both
    # standalone and inside an ap_request_scope.
    @property
    def stats(self) -> APStats:
        return self._sink().stats

    @property
    def makespan_cycles(self) -> int:
        return self._sink().makespan_cycles

    @property
    def sequential_cycles(self) -> int:
        return self._sink().sequential_cycles

    @property
    def makespan_ns(self) -> float:
        return self._sink().makespan_ns

    @property
    def sequential_ns(self) -> float:
        return self._sink().sequential_ns

    @property
    def n_graphs(self) -> int:
        return self._sink().n_graphs

    @property
    def n_programs(self) -> int:
        return self._sink().n_programs

    # -- projection cache ---------------------------------------------------

    def _resident_store(self) -> ResidentStore | None:
        return getattr(self.runtime.pool, "resident", None)

    def linear(self, key, packed: torch.Tensor, scale: torch.Tensor,
               label: str = "") -> APLinear:
        """Cached APLinear for packed weights (one unpack per weight);
        weights pin resident into the pool's bank at construction.  A
        miss is an ``ap.linear_build`` span and one ``ap.linear.builds``."""
        ck = (key, id(packed))
        hit = self._linears.get(ck)
        if hit is None:
            with trace.span("ap.linear_build", cat="serve", label=label):
                hit = (packed, APLinear.from_packed(
                    packed, scale, radix=self.radix, label=label,
                    store=self._resident_store()))
            get_registry().counter("ap.linear.builds").inc()
            self._cache_put(ck, hit)       # pin packed so id() stays valid
        return hit[1]

    def expert_linears(self, key, w_stack: torch.Tensor,
                       label: str = "") -> list[APLinear]:
        """Cached per-expert APLinears from stacked dense [E, K, N];
        every expert's weights pin resident at construction.  A miss is
        one ``ap.linear_build`` span and one ``ap.linear.builds``."""
        ck = (key, id(w_stack))
        hit = self._linears.get(ck)
        if hit is None:
            with trace.span("ap.linear_build", cat="serve", label=label):
                lins = [APLinear.from_dense(w_stack[e], radix=self.radix,
                                            label=f"{label}e{e}",
                                            store=self._resident_store())
                        for e in range(w_stack.shape[0])]
            get_registry().counter("ap.linear.builds").inc()
            hit = (w_stack, lins)
            self._cache_put(ck, hit)
        return hit[1]

    def _cache_put(self, ck, value) -> None:
        while len(self._linears) >= self._max_linears:    # FIFO evict
            self._linears.pop(next(iter(self._linears)))
        self._linears[ck] = value

    # -- quantization -------------------------------------------------------

    def quantize(self, x: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """x float [T, K] -> (x_int int32 with |x| <= x_levels, scale), in
        the reference's fp32 operation order (round half to even)."""
        xf = x.to(torch.float32)
        s = torch.clamp_min(xf.abs().max() / self.x_levels, 1e-8)
        xi = torch.clamp(torch.round(xf / s), -self.x_levels,
                         self.x_levels).to(torch.int32)
        return xi, s

    # -- execution + aggregation --------------------------------------------

    def run_graph(self, graph: ProgramGraph):
        if _PLAIN_AP.get():
            if len(graph):
                raise RuntimeError("a graph was built under "
                                   "plain_ap_projections()")
            return {}
        scope = _AP_SCOPE.get()
        sink = self._default_sink if scope is None else scope[0]
        # builder-side meta (sparsity pruning, resident hits) folds here so
        # both the sequential and the wave-merged route account it
        sink.add_meta(graph.meta)
        if scope is not None and scope[1] is not None:
            # batched serving: hand the graph to the wave merger, which
            # coalesces it with the other in-flight requests' graphs and
            # settles this request's sink from its slice of the merged run
            return scope[1].run_graph(self, graph, scope[0])
        with trace.span("serve.graph", cat="serve", n_nodes=len(graph),
                        graph_index=sink.n_graphs):
            res = self.runtime.run_graph(graph, stats=sink.stats,
                                         collect_stats=True)
        sink.add_report(res.report)
        sink.defer_power(
            res.schedule, dict(res.traced),
            {i: n.label for i, n in enumerate(graph.nodes)},
            self.runtime.pool.n_arrays)
        return res

    def cache_stats(self) -> dict:
        """Occupancy of every compilation/serving cache this context rides:
        the process-wide bounded compile caches (:mod:`repro_torch.apc.
        caches`), the pool's uploaded-schedule store, and the per-context
        APLinear cache — the numbers to watch in a long-running
        serve.Engine."""
        from .caches import cache_stats
        out = {
            "compile": cache_stats(),
            "pool_schedules": len(self.runtime.pool._schedules),
            "pool_schedules_max": self.runtime.pool._max_schedules,
            "linears": len(self._linears),
            "linears_max": self._max_linears,
        }
        store = self._resident_store()
        if store is not None:
            out["resident"] = store.stats()
        return out

    def report(self, n_masked: int = N_MASKED_MAC) -> dict:
        """Aggregated per-request accounting: functional-simulator counters
        + Table XI energy + graph-scheduler occupancy (of the active
        sink — the default one outside :func:`ap_request_scope`)."""
        rep = self._sink().report(n_masked=n_masked)
        rep["n_arrays_total"] = getattr(self.runtime.pool, "total_arrays",
                                        self.runtime.pool.n_arrays)
        return rep


# ---------------------------------------------------------------------------
# MoE dispatch: every expert an independent subgraph of one ProgramGraph
# ---------------------------------------------------------------------------

def ap_moe_dispatch(ctx: APServeContext, x2d: torch.Tensor,
                    expert_ids: torch.Tensor, gates: torch.Tensor,
                    w1_lins: list[APLinear], w3_lins: list[APLinear],
                    w2_lins: list[APLinear],
                    act: Callable[[torch.Tensor], torch.Tensor]
                    ) -> torch.Tensor:
    """SwiGLU MoE FFN with every expert projection AP-served.

    ``x2d`` [T, d] float, ``expert_ids``/``gates`` [T, k] (router top-k).
    Token rows sort to their experts on the host (the AP path is the
    functional simulator — exactness over dispatch latency), then TWO
    graphs run: one with all experts' gate+up projections (2E independent
    tiled-MAC subgraphs, interleaved across the bank), one with the down
    projections after the float combine.  Returns [T, d_out] fp32; the
    combine adds each expert's gated rows in expert order
    (``index_add_``; a token meets an expert at most once, so every row's
    sum is taken in the reference's order).

    Degenerate inputs short-circuit before any graph is built: empty
    expert lists raise, and when no (token, expert) pair routes anywhere
    (T == 0, or top-k == 0) the result is all-zeros and ``ctx.n_graphs``
    does not move — an empty dispatch runs zero graphs, not two empty
    ones.
    """
    if not (len(w1_lins) == len(w3_lins) == len(w2_lins)):
        raise ValueError(
            f"expert list lengths disagree: w1={len(w1_lins)} "
            f"w3={len(w3_lins)} w2={len(w2_lins)}")
    if not w2_lins:
        raise ValueError("ap_moe_dispatch needs at least one expert")
    t, k = expert_ids.shape
    n_out = w2_lins[0].n
    dev = x2d.device
    eids = expert_ids.reshape(-1).cpu().numpy()           # host dispatch
    flat_gates = gates.reshape(-1)
    groups = []                                            # (e, pair_idx)
    for e in range(len(w1_lins)):
        pair_idx = np.nonzero(eids == e)[0]
        if pair_idx.size:
            groups.append((e, pair_idx))
    if not groups:                         # T == 0 or k == 0: nothing routed
        return torch.zeros((t, n_out), dtype=torch.float32, device=dev)

    x_int, s_x = ctx.quantize(x2d)
    g1 = ProgramGraph()
    calls = []
    for e, pair_idx in groups:
        tok = torch.as_tensor(pair_idx // k, dtype=torch.long, device=dev)
        sub = x_int[tok]
        c1 = w1_lins[e].add_call(g1, sub, max_cols=ctx.max_cols,
                                 max_q=ctx.x_levels)
        c3 = w3_lins[e].add_call(g1, sub, max_cols=ctx.max_cols,
                                 max_q=ctx.x_levels)
        calls.append((e, pair_idx, tok, c1, c3))
    res1 = ctx.run_graph(g1)

    g2 = ProgramGraph()
    down = []
    for e, pair_idx, tok, c1, c3 in calls:
        h = act(c1.decode(res1, s_x)) * c3.decode(res1, s_x)
        h_int, s_h = ctx.quantize(h)
        c2 = w2_lins[e].add_call(g2, h_int, max_cols=ctx.max_cols,
                                 max_q=ctx.x_levels)
        down.append((pair_idx, tok, s_h, c2))
    res2 = ctx.run_graph(g2)

    y2d = torch.zeros((t, n_out), dtype=torch.float32, device=dev)
    for pair_idx, tok, s_h, c2 in down:
        y_e = c2.decode(res2, s_h)
        gsel = flat_gates[torch.as_tensor(pair_idx, dtype=torch.long,
                                          device=dev)]
        y2d.index_add_(0, tok, y_e * gsel[:, None].to(torch.float32))
    return y2d


# ---------------------------------------------------------------------------
# Serving hook: flip models' ternary projections onto the AP path
# ---------------------------------------------------------------------------

_AP_CTX: contextvars.ContextVar[APServeContext | None] = \
    contextvars.ContextVar("ap_serve_ctx", default=None)

# (sink, merger | None): set per request by the continuous-batching path so
# many requests can share one APServeContext without sharing accounting
_AP_SCOPE: contextvars.ContextVar[tuple | None] = \
    contextvars.ContextVar("ap_request_scope", default=None)


@contextmanager
def ap_request_scope(sink: APSink, merger=None):
    """Route this (thread's) AP work into ``sink`` instead of the context's
    default sink; with a ``merger`` (``serve.batcher.WaveMerger``), graph
    runs additionally rendezvous with the other in-flight requests into one
    row-concatenated merged graph per wave."""
    token = _AP_SCOPE.set((sink, merger))
    try:
        yield sink
    finally:
        _AP_SCOPE.reset(token)


def current_ap_context() -> APServeContext | None:
    """The active AP serving context, if any — None in ordinary float
    serving AND while the current CUDA stream is capturing a graph (the AP
    path is host-orchestrated, with host syncs, and cannot be captured;
    a captured step inside ``ap_serving`` records the float path)."""
    ctx = _AP_CTX.get()
    if ctx is None:
        return None
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return None
    return ctx


@contextmanager
def ap_serving(ctx: APServeContext):
    """While active, ``models.mlp.mlp`` (packed params) and
    ``models.moe.moe_ffn`` route their projections through ``ctx`` — the
    model code needs no plumbing, and the serve engine simply wraps its
    step."""
    token = _AP_CTX.set(ctx)
    try:
        yield ctx
    finally:
        _AP_CTX.reset(token)
