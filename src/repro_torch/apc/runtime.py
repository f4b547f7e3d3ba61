"""AP runtime: program-graph scheduler over a device-sharded array pool.

Two layers on top of :class:`~repro_torch.apc.pool.ArrayPool`:

- :class:`DevicePool` — the pool's array bank generalized to span a
  *mesh*, a sequence of torch devices (the reference shards over a JAX
  mesh's data axes; here ``[cuda:0]`` on one card, and a device may
  repeat): ONE pool of ``n_arrays * n_devices`` physical MvCAM arrays.
  Whole ``rows``-row blocks shard over the devices, every device replays
  the same schedule against its shard, and the per-block counter tensors
  are summed elementwise across shards (the reference's ``psum``), so
  output digits and accumulated APStats stay bit-identical to a
  single-array :func:`~repro_torch.apc.exec.execute`.

- :class:`Runtime` — executes a :class:`~repro_torch.apc.graph.ProgramGraph`:
  nodes run in topological wavefronts, dependency results flow
  node-to-node on the device, and each node's schedule-static cycles +
  traced counters fold into one APStats.  :meth:`Runtime.makespan` prices
  the same graph with the per-array occupancy model
  (:func:`~repro_torch.apc.graph.graph_makespan`) — the graph
  generalization of ``ArrayPool.wall_cycles``.
"""
from __future__ import annotations

import torch

from ..core.ap import APStats
from ..device import as_digits
from ..kernels.tap_pass.ops import _pad_rows
from . import trace
from .exec import mesh_devices, sharded_program_run
from .faults import FaultDetected
from .graph import ProgramGraph, graph_makespan
from .lower import CompiledProgram
from .metrics import get_registry
from .pool import ArrayPool, _empty_counts, drain_fault_charges
from .stats import TracedStats, accumulate

__all__ = ["DevicePool", "Runtime", "GraphResult"]


class DevicePool(ArrayPool):
    """An :class:`ArrayPool` whose bank spans the devices of a mesh.

    ``mesh=None`` degrades to the single-device ArrayPool on ``device``
    (same dispatch); with a mesh (a sequence of devices), ``run`` splits
    the rows into one shard of whole blocks per device, each device
    streaming its shard through ``n_arrays`` local arrays.  Digits come
    back on ``mesh[0]``.
    """

    def __init__(self, mesh=None, *, n_arrays: int = 4, rows: int = 4096,
                 cols: int = 256, kernel_variant: str | None = None,
                 resident_slots: int = 256, faults=None, device=None):
        devices = None if mesh is None else mesh_devices(mesh)
        super().__init__(n_arrays=n_arrays, rows=rows, cols=cols,
                         kernel_variant=kernel_variant,
                         resident_slots=resident_slots, faults=faults,
                         device=device if devices is None else devices[0])
        if devices is not None and self.fault_model is not None:
            raise NotImplementedError(
                "fault injection runs on the host pool path; the sharded "
                "route has no per-block recovery hook yet")
        self.mesh = devices
        self.n_devices = 1 if devices is None else len(devices)

    def __repr__(self) -> str:
        return (f"DevicePool(n_devices={self.n_devices}, "
                f"n_arrays={self.n_arrays}, rows={self.rows}, "
                f"cols={self.cols})")

    @property
    def total_arrays(self) -> int:
        return self.n_arrays * self.n_devices

    def n_blocks_per_device(self, n_rows: int) -> int:
        return -(-self.n_blocks(n_rows) // self.n_devices)

    def wall_cycles(self, n_rows: int, n_compare_cycles: int,
                    n_write_cycles: int) -> dict[str, int]:
        """Pipelined wall clock: blocks split over devices first, then each
        device's share streams over its local arrays —
        ``ceil(ceil(blocks / devices) / arrays)`` replay waves."""
        waves = max(1, -(-self.n_blocks_per_device(max(1, n_rows))
                         // self.n_arrays))
        return {"waves": waves,
                "compare_cycles": waves * n_compare_cycles,
                "write_cycles": waves * n_write_cycles}

    def run(self, arr, compiled: CompiledProgram, *,
            collect_stats: bool = False, kernel_variant: str | None = None,
            block_valid: tuple[int, ...] | None = None,
            radix: int | None = None
            ) -> tuple[torch.Tensor, TracedStats | None]:
        """Stream [rows, cols] digit rows through the device-spanning bank.

        Bit-identical output and (when ``collect_stats``) APStats to the
        single-array :func:`~repro_torch.apc.exec.execute` — padding rows
        are masked per shard and the per-block counters summed across
        devices.
        """
        if self.mesh is None:
            return super().run(arr, compiled, collect_stats=collect_stats,
                               kernel_variant=kernel_variant,
                               block_valid=block_valid, radix=radix)
        if block_valid is not None:
            raise NotImplementedError(
                "row-concatenated (block_valid) launches run on the host "
                "pool path; the sharded route masks per-shard rows only")
        arr = as_digits(arr, self.device)
        n_rows, n_cols = arr.shape
        self.validate(compiled, n_cols=n_cols)
        if n_rows == 0:
            return arr, _empty_counts(arr.device) if collect_stats else None
        scheds = []
        for dev in self.mesh:
            sched, variant, pack = self._device_schedule(
                compiled, kernel_variant, dev)
            scheds.append(sched)
        d = self.n_devices
        # per-device shard: whole blocks of self.rows (the kernel's block
        # grid splits the shard back into per-array blocks); padding rows
        # are masked per shard and the counters summed by the shared
        # scaffolding
        rows_per_dev = -(-n_rows // d)
        shard_rows = self.rows * max(1, -(-rows_per_dev // self.rows))
        padded, _ = _pad_rows(arr, d * shard_rows)
        with trace.span("devicepool.run", cat="pool", rows=n_rows,
                        n_devices=d, n_arrays=self.n_arrays,
                        steps=compiled.n_steps, variant=variant):
            out, raw = sharded_program_run(
                padded, scheds, self.mesh, n_rows, self.rows,
                collect_stats=collect_stats, pack=pack)
        out = out[:n_rows]
        return out, (TracedStats(raw) if collect_stats else None)


class GraphResult(dict):
    """``{node_id: result tensor}`` plus the run's occupancy report.

    ``traced`` carries each node's per-block
    :class:`~repro_torch.apc.stats.TracedStats` when the run collected
    counters (``stats`` given or ``collect_stats=True``) — a batching
    layer splits these per request slice
    (:class:`~repro_torch.apc.graph.MergedSlice`) to attribute a shared
    wave's counters exactly.

    ``schedule`` is the occupancy model's per-(node, array) interval
    record (see :func:`~repro_torch.apc.graph.graph_makespan`) — together
    with ``traced`` it is everything
    :func:`repro_torch.apc.power.graph_power` needs to build the per-array
    power timeline.
    """

    def __init__(self, results: dict[int, torch.Tensor],
                 report: dict[str, float],
                 traced: dict[int, "TracedStats | None"] | None = None,
                 schedule: list[dict] | None = None):
        super().__init__(results)
        self.report = report
        self.traced = traced or {}
        self.schedule = schedule or []


class Runtime:
    """Schedules :class:`ProgramGraph` nodes over an array pool.

    One runtime per pool; graphs are transient.  ``stats`` accumulation is
    per node (schedule-static cycles + traced counters), so running a
    graph charges exactly what running each program alone would.
    """

    def __init__(self, pool: ArrayPool, *,
                 kernel_variant: str | None = None):
        self.pool = pool
        self.kernel_variant = kernel_variant
        self.last_report: dict[str, float] | None = None

    def __repr__(self) -> str:
        return f"Runtime(pool={self.pool!r})"

    @property
    def n_devices(self) -> int:
        return getattr(self.pool, "n_devices", 1)

    def check_knobs(self, *, kernel_variant: str | None = None) -> None:
        """Reject a per-call ``kernel_variant`` the runtime route cannot
        honor.

        Graph execution always runs with the variant configured on the
        Runtime itself; a caller passing a different explicit value would
        otherwise be silently ignored — raise instead and point at the
        constructor.  An explicit value that merely restates what an
        unconfigured (None) Runtime resolves to anyway is compatible.
        """
        from .lower import default_kernel_variant
        val, own = kernel_variant, self.kernel_variant
        if val is None or val == own:
            return
        if own is None and val == default_kernel_variant():
            return
        raise ValueError(
            f"kernel_variant={val!r} conflicts with Runtime("
            f"kernel_variant={own!r}) — the graph route runs with the "
            f"Runtime's knobs; set it on the Runtime constructor")

    def makespan(self, graph: ProgramGraph,
                 record: list | None = None) -> dict[str, float]:
        """Occupancy-model makespan of ``graph`` on this runtime's bank
        (``record`` captures the per-array schedule; see
        :func:`~repro_torch.apc.graph.graph_makespan`)."""
        return graph_makespan(graph, n_arrays=self.pool.n_arrays,
                              rows_per_array=self.pool.rows,
                              n_devices=self.n_devices, record=record,
                              dead_arrays=getattr(self.pool, "dead_arrays",
                                                  ()))

    def run_graph(self, graph: ProgramGraph, *,
                  stats: APStats | None = None,
                  order: list[int] | None = None,
                  collect_stats: bool = False) -> GraphResult:
        """Execute the graph; returns every node's result keyed by node id.

        ``order`` overrides the default wavefront order with any valid
        topological linearization — results are bit-identical regardless
        (node builds are pure functions of dependency results).

        ``collect_stats=True`` collects per-node traced counters into
        ``GraphResult.traced`` without aggregating them anywhere — the
        route of a batching layer, which attributes each merged node's
        counters to its per-request slices itself.

        Under a fault model a node whose pool run raises
        :class:`~repro_torch.apc.faults.FaultDetected` is re-executed, up
        to ``cfg.node_retries`` times, with the node id set on the error.
        """
        nodes = graph.nodes
        waves = graph.wavefronts()
        if order is None:
            order = [nid for wave in waves for nid in wave]
        if sorted(order) != list(range(len(nodes))):
            raise ValueError("order must be a permutation of all node ids")
        done: set[int] = set()
        results: dict[int, torch.Tensor] = {}
        traced: list[tuple[int, TracedStats | None]] = []
        collect = stats is not None or collect_stats
        tracer = trace.current_tracer()
        wave_of = {nid: w for w, ws in enumerate(waves) for nid in ws}
        with trace.span("run_graph", cat="runtime", n_nodes=len(nodes),
                        n_waves=len(waves)) as gspan:
            # per-wavefront spans: a new one opens whenever the dispatch
            # order crosses a wavefront boundary, so a custom (non-wave-
            # major) order shows up as the same wavefront re-opening —
            # predicted occupancy vs actual dispatch order, on one track
            wave_span = None
            cur_wave = None
            try:
                for pos, nid in enumerate(order):
                    node = nodes[nid]
                    if any(d not in done for d in node.deps):
                        raise ValueError(
                            f"order runs node {nid} before its dependencies "
                            f"{tuple(d for d in node.deps if d not in done)}")
                    if tracer is not None and wave_of[nid] != cur_wave:
                        if wave_span is not None:
                            wave_span.__exit__(None, None, None)
                        cur_wave = wave_of[nid]
                        wave_span = tracer.span(
                            f"wavefront{cur_wave}", cat="runtime",
                            wave=cur_wave,
                            width=len(waves[cur_wave])).__enter__()
                    with trace.span(node.label or f"node{nid}", cat="node",
                                    node=nid, rows=node.rows,
                                    dispatch_order=pos, wave=wave_of[nid],
                                    compare_cycles=(
                                        node.compiled.n_compare_cycles),
                                    write_cycles=node.compiled.n_write_cycles,
                                    deps=list(node.deps)):
                        arr = node.build(*(results[d] for d in node.deps))
                        if arr.ndim != 2 or arr.shape[0] != node.rows:
                            raise ValueError(
                                f"node {nid} ({node.label or 'unlabeled'}) "
                                f"built a {tuple(arr.shape)} array, "
                                f"declared rows={node.rows}")
                        fm = getattr(self.pool, "fault_model", None)
                        attempts = 1 + (fm.cfg.node_retries
                                        if fm is not None else 0)
                        for t in range(attempts):
                            try:
                                out, tr = self.pool.run(
                                    arr, node.compiled,
                                    collect_stats=collect,
                                    kernel_variant=self.kernel_variant,
                                    block_valid=node.block_valid,
                                    radix=graph.radix)
                                break
                            except FaultDetected as e:
                                # re-execute ONLY this node: deps are done
                                # and their results live; the whole-node
                                # replay redraws transient faults on a
                                # (possibly just-degraded) bank
                                e.node = nid
                                if t + 1 >= attempts:
                                    raise
                                get_registry().counter(
                                    "faults.node_retries").inc()
                                trace.fault("node_retry", node=nid,
                                            attempt=t + 1)
                    results[nid] = node.result(out)
                    traced.append((nid, tr))
                    done.add(nid)
            finally:
                if wave_span is not None:
                    wave_span.__exit__(None, None, None)
            if stats is not None:
                for nid, tr in traced:
                    accumulate(stats, tr, nodes[nid].compiled,
                               n_rows=nodes[nid].rows,
                               label=nodes[nid].label or f"node{nid}")
            drain_fault_charges(self.pool, stats)
            rec: list = []
            res = GraphResult(results, self.makespan(graph, record=rec),
                              traced=dict(traced) if collect else None,
                              schedule=rec)
            if tracer is not None:
                gspan.set(makespan_cycles=res.report["makespan_cycles"],
                          sequential_cycles=res.report["sequential_cycles"],
                          makespan_ns=res.report["makespan_ns"],
                          sequential_ns=res.report["sequential_ns"])
                # render the occupancy model's per-array schedule as the
                # model-time timeline, anchored under this graph's host span
                base = gspan.ts_ns
                for iv in rec:
                    dev, a = divmod(iv["array"], self.pool.n_arrays)
                    tracer.model_span(
                        nodes[iv["node"]].label or f"node{iv['node']}",
                        track=f"dev{dev}/arr{a}",
                        start_ns=base + iv["start_ns"],
                        dur_ns=iv["end_ns"] - iv["start_ns"],
                        node=iv["node"], blocks=iv["blocks"],
                        cycles=iv["end_cycles"] - iv["start_cycles"])
                if collect:
                    # power counter tracks: the same schedule joined with
                    # the per-node traced counters (exact partition)
                    from .layers import N_MASKED_MAC
                    from .power import emit_counter_tracks, graph_power
                    tl = graph_power(
                        rec, res.traced, radix=graph.radix or 3,
                        n_masked=N_MASKED_MAC,
                        n_arrays_local=self.pool.n_arrays,
                        labels={i: n.label for i, n in enumerate(nodes)})
                    emit_counter_tracks(tracer, tl, base_ns=base)
        self.last_report = res.report
        return res

    def run_mac_graph(self, macs, *, stats: APStats | None = None
                      ) -> list[torch.Tensor]:
        """Run many independent K-tiled MACs as ONE graph.

        ``macs`` is a sequence of ``(x, w_ter, tiled)`` triples (see
        :meth:`ProgramGraph.add_mac_tiled`); returns the [R, width]
        accumulator digit block of each MAC, scheduled with all tile
        programs interleaved across the bank.
        """
        graph = ProgramGraph()
        finals = [graph.add_mac_tiled(x, w, tiled, label=f"mac{i}:")
                  for i, (x, w, tiled) in enumerate(macs)]
        res = self.run_graph(graph, stats=stats)
        return [res[f] for f in finals]
