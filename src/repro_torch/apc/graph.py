"""Program graphs: dependency DAGs of compiled-program launches.

The AP's systems problem at scale is not single-array latency — it is
*occupancy*: many independent arithmetic programs resident in the CAM bank
at once, tiles of different matmuls interleaved into idle arrays while a
reduction waits on its partials (the multi-array scheduling framing of the
Fouda et al. AP tutorial, and the bank-occupancy argument of Yavits-style
3D AP work).  This module gives that structure a first-class object:

- :class:`GraphNode` — one :class:`~repro_torch.apc.lower.CompiledProgram`
  launch over ``rows`` CAM rows.  ``build(*dep_results)`` packs the node's
  input digit array from its dependencies' results (pure tensor code, so
  execution order of independent nodes can never change the digits),
  ``result_cols`` is the column slice carried forward as this node's
  result.
- :class:`ProgramGraph` — append-only DAG (``deps`` must reference earlier
  nodes, so it is acyclic by construction) with topological wavefronts.
- :func:`graph_makespan` — the per-array occupancy model extending
  :meth:`~repro_torch.apc.pool.ArrayPool.wall_cycles` from one launch to a
  whole graph: list-schedule every node's row-blocks onto the
  earliest-free array of the ``n_arrays x n_devices`` bank, never starting
  a node before its dependencies finish.  ``sequential_cycles`` is the
  naive baseline (drain each launch completely before the next); the
  scheduler's makespan is <= that sum by construction and strictly below
  it whenever independent programs leave arrays idle mid-drain.
- :func:`mac_fold_plan` / :func:`add_mac_tiled` — the K-tiled MAC
  (:class:`~repro_torch.apc.mac.TiledMac`) as a graph: tile partial-sum
  programs are the roots, each ripple-add reduction stage depends on the
  partials it folds.  The fold plan is THE shared description of the
  reduction chain — :func:`repro_torch.apc.pool.run_mac_tiled` replays the
  same plan sequentially, so cycle accounting lives here, in one place.
- :func:`coalesce_graphs` — many independent graphs merged into one,
  like nodes row-concatenated at block granularity
  (``GraphNode.block_valid``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import torch

from ..core.energy import T_EVALUATE_NS, T_PRECHARGE_NS, T_WRITE_NS
from . import trace
from .caches import ResidentEvicted, ResidentHandle, ResidentStale
from .lower import CompiledProgram
from .metrics import get_registry
from .mac import (TiledMac, assemble_mac_rows_jnp, encode_mac_rows_jnp,
                  encode_mac_x_rows_jnp, mac_layout)

T_COMPARE_NS = T_PRECHARGE_NS + T_EVALUATE_NS

CARRIED = -1          # fold-plan sentinel: previous stage's folded result


def _resolve_or_repin(handle: ResidentHandle):
    """A resident handle's digit plane, surviving store churn.

    Graphs are built (handles pinned) before they execute, so a bounded
    store under concurrent serving can evict — or re-pin under the same
    key — between pin and node build.  Eviction is recoverable: the
    handle carries its own plane copy, so re-pin the same content and
    continue (a re-upload, not a failure; ``resident.repins`` counts it).
    A re-pin under the key is recoverable only while the live digest
    still matches the handle's (a newer pin epoch of identical content);
    a genuine weight swap propagates :class:`ResidentStale` — the graph
    was built against columns that no longer exist."""
    try:
        return handle.resolve()
    except ResidentEvicted:
        plane = handle.store.pin(handle.key, handle.digest,
                                 lambda: handle.plane).plane
    except ResidentStale:
        cur = handle.store.get(handle.key)
        if cur is None or cur.digest != handle.digest:
            raise
        plane = cur.plane
    get_registry().counter("resident.repins").inc()
    trace.instant("resident_repin", cat="pool", key=handle.key)
    return plane


class FoldStage(NamedTuple):
    """One ripple-add reduction stage of a K-tiled MAC fold.

    ``parts`` are indices into the tile-partial list (:data:`CARRIED` means
    the previous stage's result rides along as the first operand);
    ``out_lo:out_hi`` is the digit-column slice of the stage's output row
    holding the folded sum.
    """
    prog: CompiledProgram
    parts: tuple[int, ...]
    out_lo: int
    out_hi: int


def mac_fold_plan(tiled: TiledMac) -> tuple[FoldStage, ...]:
    """The reduction chain of a :class:`TiledMac` as explicit fold stages.

    Single source of truth for which partials feed which reduction program
    (and hence for tiled cycle accounting): ``run_mac_tiled`` replays these
    stages sequentially, :func:`add_mac_tiled` turns them into graph nodes.
    """
    stages: list[FoldStage] = []
    width = tiled.width
    nxt = 0
    for j, (g, prog) in enumerate(zip(tiled.reduce_groups,
                                      tiled.reduce_programs)):
        fresh = g if j == 0 else g - 1       # later stages carry one partial
        parts = tuple(range(nxt, nxt + fresh))
        if j:
            parts = (CARRIED,) + parts
        nxt += fresh
        stages.append(FoldStage(prog, parts, (g - 1) * width, g * width))
    return tuple(stages)


def fold_stage_input(group: list[torch.Tensor]) -> torch.Tensor:
    """Pack a reduction stage's row: partial digit blocks side by side plus
    the zeroed carry column."""
    rows = group[0].shape[0]
    return torch.cat(
        [g.to(torch.int8) for g in group]
        + [torch.zeros((rows, 1), dtype=torch.int8,
                       device=group[0].device)], dim=1)


# ---------------------------------------------------------------------------
# The graph
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GraphNode:
    """One compiled-program launch over ``rows`` CAM rows.

    ``block_valid`` (optional) marks the node as a *row-concatenated*
    launch: the built array is a sequence of row blocks (the pool's block
    size) where block ``b`` carries ``block_valid[b]`` valid rows at its
    top and zero padding below — the executor masks the padding out of
    the counters per block (exactly as it masks the tail block of an
    ordinary launch) and compacts the output to the valid rows.  This is
    how independent requests share one schedule replay: their row
    segments ride the same launch while per-block counters stay an exact
    per-segment partition.

    ``upload_cycles`` is the per-block operand-upload charge (one write
    cycle per digit column that must be freshly written into the array
    before the program sweeps; 0 keeps the historical model).  Resident
    weight columns charge nothing here — that is the weight-stationary
    win the occupancy model sees.  ``resident_key`` tags the node with
    the ``(key, generation)`` of the resident plane it reads, so
    :func:`coalesce_graphs` merges only launches that agree on the
    resident bank contents.
    """
    compiled: CompiledProgram
    rows: int
    build: Callable[..., torch.Tensor]          # (*dep_results) -> [rows, cols]
    deps: tuple[int, ...] = ()
    result_cols: tuple[int, int] | None = None
    label: str = ""
    block_valid: tuple[int, ...] | None = None
    upload_cycles: int = 0
    resident_key: tuple | None = None

    @property
    def cycles(self) -> int:
        """One replay of this node's program, in compare + write cycles —
        the scalar duration the occupancy model schedules with."""
        return self.compiled.n_compare_cycles + self.compiled.n_write_cycles

    @property
    def cycles_ns(self) -> float:
        return (self.compiled.n_compare_cycles * T_COMPARE_NS
                + self.compiled.n_write_cycles * T_WRITE_NS)

    @property
    def block_cycles(self) -> int:
        """Program replay + operand upload — the per-block duration the
        occupancy model schedules with."""
        return self.cycles + self.upload_cycles

    @property
    def block_cycles_ns(self) -> float:
        return self.cycles_ns + self.upload_cycles * T_WRITE_NS

    def result(self, out: torch.Tensor) -> torch.Tensor:
        if self.result_cols is None:
            return out
        lo, hi = self.result_cols
        return out[:, lo:hi]


@dataclass
class ProgramGraph:
    """Append-only DAG of program launches (acyclic by construction: a
    node's ``deps`` may only reference already-added nodes).

    ``meta`` carries accounting gathered while the graph is built, not
    derivable from the nodes alone (sparsity pruning totals, resident
    hit/miss counts); the reference's serving layer
    (``APServeContext.run_graph``) folds it into the active request
    sink.

    ``radix`` is a hint set while building (by :meth:`add_mac_tiled`) the
    power exporter uses to price counters through Table XI; ``None``
    means unknown (generic programs), priced at the default radix 3."""
    nodes: list[GraphNode] = field(default_factory=list)
    meta: dict = field(default_factory=dict)
    radix: int | None = None

    def __len__(self) -> int:
        return len(self.nodes)

    def bump(self, key: str, n: int) -> None:
        """Accumulate a ``meta`` counter."""
        self.meta[key] = self.meta.get(key, 0) + n

    def add(self, compiled: CompiledProgram, *, rows: int,
            build: Callable[..., torch.Tensor], deps: tuple[int, ...] = (),
            result_cols: tuple[int, int] | None = None,
            label: str = "",
            block_valid: tuple[int, ...] | None = None,
            upload_cycles: int = 0,
            resident_key: tuple | None = None) -> int:
        if rows < 0:
            raise ValueError(f"rows must be >= 0, got {rows}")
        if upload_cycles < 0:
            raise ValueError(f"upload_cycles must be >= 0, got "
                             f"{upload_cycles}")
        nid = len(self.nodes)
        for d in deps:
            if not 0 <= d < nid:
                raise ValueError(
                    f"node {nid} depends on {d}, which is not an "
                    f"already-added node (graphs are built in topological "
                    f"order)")
        self.nodes.append(GraphNode(compiled, rows, build, tuple(deps),
                                    result_cols, label, block_valid,
                                    upload_cycles, resident_key))
        return nid

    def wavefronts(self) -> list[list[int]]:
        """Topological levels: wavefront k holds every node whose longest
        dependency chain has k predecessors — the ready sets a hardware
        sequencer would issue together."""
        level: list[int] = []
        for n in self.nodes:
            level.append(1 + max((level[d] for d in n.deps), default=-1))
        waves: list[list[int]] = [[] for _ in range(max(level, default=-1)
                                                    + 1)]
        for nid, lv in enumerate(level):
            waves[lv].append(nid)
        return waves

    def sinks(self) -> list[int]:
        """Nodes no other node consumes (the graph's outputs)."""
        consumed = {d for n in self.nodes for d in n.deps}
        return [i for i in range(len(self.nodes)) if i not in consumed]

    def total_cycles(self) -> dict[str, int]:
        """Schedule-static totals charged to the energy model (one replay
        per program, row-parallel; independent of pool geometry)."""
        return {
            "compare_cycles": sum(n.compiled.n_compare_cycles
                                  for n in self.nodes),
            "write_cycles": sum(n.compiled.n_write_cycles
                                for n in self.nodes),
        }

    # -- K-tiled MAC as a subgraph ------------------------------------------

    def add_mac_tiled(self, x, w_ter, tiled: TiledMac,
                      label: str = "", *,
                      resident: ResidentHandle | None = None,
                      charge_upload: bool = False) -> int:
        """Add one K-tiled ternary MAC (``ACC = sum_k w_k * x_k`` over
        ``x``/``w_ter`` [R, K]) as tile nodes + fold-stage nodes; returns
        the node id whose result is the [R, width] accumulator digit block.

        All tile nodes are mutually independent — across two added MACs the
        scheduler interleaves their tiles freely, which is exactly the
        program-level pipelining the runtime exists for.

        ``resident`` (weight-stationary dataflow): a
        :class:`~repro_torch.apc.caches.ResidentHandle` whose ``[R_w, K]`` digit
        plane replaces the weight-side encode in every tile build (``R_w``
        must divide R; the plane is row-tiled, matching
        :func:`~repro_torch.apc.mac.matmul_mac_rows` ordering), and tile nodes
        carry its ``(key, generation)`` as ``resident_key`` so coalescing
        only merges launches that agree on the bank contents.  Staleness
        is checked at build time (graph execution), raising rather than
        reusing dead columns.

        ``charge_upload=True`` prices operand uploads into the occupancy
        model: streaming tile nodes charge one write cycle per x AND
        weight digit column, resident tile nodes charge the x columns
        only, reduce nodes their fresh partial columns.  The default
        (False) keeps the historical upload-free model.
        """
        x = torch.as_tensor(x)
        if w_ter is not None:             # None: the weights are resident
            w_ter = torch.as_tensor(w_ter)
        R, K = x.shape
        if K != tiled.K:
            raise ValueError(f"x has K={K}, tiled program compiled for "
                             f"K={tiled.K}")
        if resident is not None:
            rw, kw = resident.plane.shape
            if kw != K or R % rw:
                raise ValueError(
                    f"resident plane is {rw}x{kw}, rows R={R} K={K} need "
                    f"a [R_w, K] plane with R_w dividing R")
        radix, width = tiled.radix, tiled.width
        self.radix = radix if self.radix is None else self.radix
        rkey = None if resident is None else (resident.key,
                                              resident.generation)
        if tiled.support is not None:
            self.bump("pruned_write_cycles", tiled.n_pruned_write_cycles)
            self.bump("pruned_compare_cycles",
                      tiled.n_pruned_compare_cycles)
        self.bump("emitted_passes", tiled.n_emitted_passes)
        self.bump("pruned_passes", tiled.n_pruned_passes)
        tile_ids: list[int] = []
        for t, ((lo, hi), prog) in enumerate(zip(tiled.tiles,
                                                 tiled.programs)):
            kt = hi - lo
            base = mac_layout(kt, width)["acc_base"]

            if resident is None:
                def build_tile(*, _lo=lo, _hi=hi):
                    return encode_mac_rows_jnp(x[:, _lo:_hi],
                                               w_ter[:, _lo:_hi],
                                               radix, width)
            else:
                def build_tile(*, _lo=lo, _hi=hi, _h=resident):
                    wd = _resolve_or_repin(_h)[:, _lo:_hi].to(x.device)
                    if R // wd.shape[0] > 1:
                        wd = wd.repeat(R // wd.shape[0], 1)
                    return assemble_mac_rows_jnp(
                        encode_mac_x_rows_jnp(x[:, _lo:_hi], radix, width),
                        wd, width)

            upload = 0
            if charge_upload:
                upload = kt * width + (0 if resident is not None else kt)
            tile_ids.append(self.add(
                prog, rows=R, build=build_tile,
                result_cols=(base, base + width),
                label=f"{label}tile{t}[{lo}:{hi}]",
                upload_cycles=upload, resident_key=rkey))
        last = tile_ids[0]
        for j, stage in enumerate(mac_fold_plan(tiled)):
            deps = tuple(last if p == CARRIED else tile_ids[p]
                         for p in stage.parts)
            last = self.add(
                stage.prog, rows=R,
                build=lambda *parts: fold_stage_input(list(parts)),
                deps=deps, result_cols=(stage.out_lo, stage.out_hi),
                label=f"{label}reduce{j}",
                upload_cycles=(len(stage.parts) * width if charge_upload
                               else 0))
        return last


# ---------------------------------------------------------------------------
# Occupancy model: wall_cycles generalized to graph makespan
# ---------------------------------------------------------------------------

def graph_makespan(graph: ProgramGraph, *, n_arrays: int,
                   rows_per_array: int, n_devices: int = 1,
                   record: list | None = None,
                   dead_arrays: tuple[int, ...] = ()) -> dict[str, float]:
    """List-schedule the graph onto ``n_arrays * n_devices`` arrays.

    Each node expands into ``ceil(rows / rows_per_array)`` block-tasks of
    duration ``node.cycles`` (one program replay per resident block); a
    node becomes ready when all dependencies finish, and its blocks are
    dealt round-robin over the arrays sorted by earliest free time (the
    earliest-free arrays take the remainder blocks).  The returned
    ``makespan_cycles`` is the pipelined wall clock of the whole graph;
    ``sequential_cycles`` is the naive drain-each-launch-in-turn baseline
    (``sum(ceil(ceil(blocks/devices)/arrays) * cycles)``, the cost the
    array pool charges when programs run back to back).  Since no array
    receives more than ``ceil(blocks / total)`` blocks of one node,
    every free time grows by at most one sequential-wave term per node —
    ``makespan <= sequential`` by construction, and strictly below it
    whenever a drain would leave arrays idle (independent programs in
    flight, or a tail wave that does not fill the bank).

    ``record`` (a list, appended in place) captures the schedule itself:
    one ``{node, label, array, blocks, start_ns, end_ns, start_cycles,
    end_cycles}`` entry per (node, array) assignment — what the tracer
    renders as the per-device/array model-time timeline
    (:meth:`repro_torch.apc.trace.Tracer.model_span`) and what
    :func:`repro_torch.apc.power.graph_power` joins with per-node traced
    counters into the per-array power timeline.

    ``dead_arrays`` names retired arrays (fault-model degradation): their
    slots take no blocks — array identity is preserved in ``record`` —
    and both the pipelined and sequential prices reprice over the
    surviving ``n_arrays_alive`` arrays.
    """
    if n_arrays < 1 or n_devices < 1 or rows_per_array < 1:
        raise ValueError(
            f"pool geometry must be positive, got n_arrays={n_arrays}, "
            f"n_devices={n_devices}, rows={rows_per_array}")
    total = n_arrays * n_devices
    dead = frozenset(dead_arrays)
    if any(not 0 <= d < total for d in dead):
        raise ValueError(f"dead_arrays {sorted(dead)} outside bank of "
                         f"{total} arrays")
    alive = [i for i in range(total) if i not in dead]
    if not alive:
        raise ValueError("every array is retired — nothing to schedule on")
    n_alive = len(alive)
    free = [0] * total
    free_ns = [0.0] * total
    finish: list[int] = []
    finish_ns: list[float] = []
    seq = 0
    seq_ns = 0.0
    for nid, node in enumerate(graph.nodes):
        ready = max((finish[d] for d in node.deps), default=0)
        ready_ns = max((finish_ns[d] for d in node.deps), default=0.0)
        blocks = max(1, math.ceil(node.rows / rows_per_array))
        end, end_ns = ready, ready_ns
        order = sorted(alive, key=free.__getitem__)
        for j, i in enumerate(order):
            nb = blocks // n_alive + (1 if j < blocks % n_alive else 0)
            if nb == 0:
                break
            start = max(free[i], ready)
            start_ns = max(free_ns[i], ready_ns)
            free[i] = start + nb * node.block_cycles
            end = max(end, free[i])
            # ns rides the SAME block assignment (Table-XI-timed rendering
            # of the cycle schedule), so makespan_ns <= sequential_ns by
            # the identical per-node wave bound
            free_ns[i] = start_ns + nb * node.block_cycles_ns
            end_ns = max(end_ns, free_ns[i])
            if record is not None:
                record.append({"node": nid, "label": node.label,
                               "array": i, "blocks": nb,
                               "start_ns": start_ns, "end_ns": free_ns[i],
                               "start_cycles": start,
                               "end_cycles": free[i]})
        finish.append(end)
        finish_ns.append(end_ns)
        if dead:
            waves = math.ceil(blocks / n_alive)
        else:
            waves = math.ceil(math.ceil(blocks / n_devices) / n_arrays)
        seq += waves * node.block_cycles
        seq_ns += waves * node.block_cycles_ns
    return {"makespan_cycles": max(finish, default=0),
            "sequential_cycles": seq,
            "makespan_ns": max(finish_ns, default=0.0),
            "sequential_ns": seq_ns,
            "n_arrays_total": total,
            "n_arrays_alive": n_alive,
            "n_nodes": len(graph.nodes)}


# ---------------------------------------------------------------------------
# Coalescing: row-concatenate many graphs' like nodes into shared launches
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MergedSlice:
    """Where one source node landed inside a coalesced graph.

    ``node`` is the merged node id; ``res_lo:res_hi`` is the source node's
    row range in the merged node's *compacted* result (the executor drops
    per-block padding rows, so result offsets count valid rows only);
    ``block_lo:block_hi`` is its block range in the merged launch — the
    per-block :class:`~repro_torch.apc.stats.TracedStats` counters of those
    blocks are exactly the counters the source node's standalone launch
    would have produced.
    """
    node: int
    rows: int
    res_lo: int
    res_hi: int
    block_lo: int
    block_hi: int


class MergedGraphView:
    """One source graph's results, sliced out of a coalesced run.

    Duck-types the ``{node_id: result}`` mapping of
    :class:`~repro_torch.apc.runtime.GraphResult` for the source graph's
    node ids, so code that decodes a graph's results (the reference's
    ``APCall``) works unchanged on batched results.  ``report`` carries the *standalone*
    occupancy report of the source graph (what this request would cost
    alone — the per-request number sequential serving records), not the
    shared wave's.
    """

    def __init__(self, result, slices: dict[int, "MergedSlice"],
                 report: dict):
        self._result = result
        self._slices = slices
        self.report = report

    def __getitem__(self, nid: int):
        sl = self._slices[nid]
        return self._result[sl.node][sl.res_lo:sl.res_hi]

    def __contains__(self, nid: int) -> bool:
        return nid in self._slices

    def __len__(self) -> int:
        return len(self._slices)


def _block_split(rows: int, block_rows: int) -> tuple[int, ...]:
    """Per-block valid row counts of a ``rows``-row segment."""
    nb = max(1, math.ceil(rows / block_rows))
    return tuple([block_rows] * (nb - 1) + [rows - (nb - 1) * block_rows])


def coalesce_graphs(graphs: list[ProgramGraph], *, block_rows: int
                    ) -> tuple[ProgramGraph, list[dict[int, MergedSlice]]]:
    """Merge many independent graphs into ONE, row-concatenating like
    nodes along the pool's row/batch axis.

    Nodes merge when they run the *same* :class:`CompiledProgram` (object
    identity — the compile caches make equal programs identical), carry
    the same ``result_cols``, and their dependencies merged into the same
    nodes positionally.  A merged node's input is the segments' built rows
    concatenated at **block granularity** (each segment zero-padded to a
    multiple of ``block_rows``, with the padding masked per block via
    ``GraphNode.block_valid``): every segment occupies whole blocks, so

    - each segment's digits and per-block counters are bit-identical to
      its standalone launch (same rows, same masking), and
    - the per-segment counter split is an exact partition of the merged
      launch's :class:`~repro_torch.apc.stats.TracedStats`.

    The hardware win is shared scheduling: one schedule replay sweeps all
    segments' blocks through the bank as a single wave instead of one
    drain per request.  Returns the merged graph plus, per source graph,
    the ``{source node id: MergedSlice}`` mapping used for result slicing
    and per-request stats attribution.

    The pass is pure graph surgery — results of every source node are
    bit-identical to running its graph alone, because node builds are
    pure functions of dependency results and the executor masks padding
    per block.
    """
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    merged = ProgramGraph()
    merged.radix = next((g.radix for g in graphs if g.radix is not None),
                        None)
    maps: list[dict[int, MergedSlice]] = [{} for _ in graphs]
    levels: list[list[int]] = []
    for g in graphs:
        lv: list[int] = []
        for n in g.nodes:
            if n.block_valid is not None:
                raise ValueError(
                    "cannot coalesce a graph that already carries "
                    "block_valid nodes (graphs merge once)")
            lv.append(1 + max((lv[d] for d in n.deps), default=-1))
        levels.append(lv)
    max_level = max((max(lv, default=-1) for lv in levels), default=-1)
    for level in range(max_level + 1):
        groups: dict[tuple, list[tuple[int, int, GraphNode]]] = {}
        for gi, g in enumerate(graphs):
            for nid, node in enumerate(g.nodes):
                if levels[gi][nid] != level:
                    continue
                if node.rows == 0:            # degenerate: keep solo
                    key: tuple = ("solo", gi, nid)
                else:
                    dep_targets = tuple(maps[gi][d].node for d in node.deps)
                    # residency is part of launch identity: only waves that
                    # agree on the resident plane generation (and the
                    # upload price) may share a schedule replay
                    key = (id(node.compiled), dep_targets, node.result_cols,
                           node.resident_key, node.upload_cycles)
                groups.setdefault(key, []).append((gi, nid, node))
        for members in groups.values():
            _merge_group(merged, members, maps, block_rows)
    return merged, maps


def _merge_group(merged: ProgramGraph,
                 members: list[tuple[int, int, "GraphNode"]],
                 maps: list[dict[int, MergedSlice]],
                 block_rows: int) -> None:
    """Append one merged node for ``members`` and record their slices."""
    solo = len(members) == 1
    gi0, nid0, node0 = members[0]
    dep_slices = [[maps[gi][d] for d in node.deps]
                  for gi, nid, node in members]
    deps = tuple(sl.node for sl in dep_slices[0])
    segments = []                  # (build, dep_slices, rows, pad_rows)
    block_valid: list[int] = []
    res_lo = 0
    total_pad = 0
    mnid = len(merged.nodes)
    for (gi, nid, node), dsl in zip(members, dep_slices):
        if solo:
            # un-padded launch: the pool masks the tail block itself, and
            # every block of the launch belongs to this one source node
            bv: tuple[int, ...] = ()
            n_blocks = max(1, math.ceil(node.rows / block_rows))
            pad_rows = node.rows
        else:
            bv = _block_split(node.rows, block_rows)
            n_blocks = len(bv)
            pad_rows = n_blocks * block_rows
        maps[gi][nid] = MergedSlice(
            node=mnid, rows=node.rows,
            res_lo=res_lo, res_hi=res_lo + node.rows,
            block_lo=len(block_valid),
            block_hi=len(block_valid) + n_blocks)
        segments.append((node.build, dsl, node.rows, pad_rows))
        block_valid.extend(bv)
        res_lo += node.rows
        total_pad += pad_rows

    # a solo segment whose deps are themselves whole (un-merged) nodes can
    # reuse the original build untouched — the sequential path stays
    # zero-overhead through coalescing.  "Whole" must mean the slice IS
    # the entire merged dep (same row count), not merely that it starts
    # at row 0: a solo node whose sibling deps merged with other graphs'
    # nodes still needs the slicing wrapper, or its build would consume
    # the full row-concatenated dep result
    plain_deps = solo and all(
        sl.res_lo == 0 and sl.rows == sl.res_hi
        and sl.rows == merged.nodes[sl.node].rows
        for sl in dep_slices[0])

    if plain_deps:
        build = node0.build
    else:
        def build(*dep_results, _segments=segments):
            parts = []
            for seg_build, dsl, rows, pad_rows in _segments:
                args = [dep_results[j][sl.res_lo:sl.res_hi]
                        for j, sl in enumerate(dsl)]
                arr = seg_build(*args)
                arr = torch.as_tensor(arr).to(torch.int8)
                if pad_rows > arr.shape[0]:
                    arr = torch.cat([arr, arr.new_zeros(
                        (pad_rows - arr.shape[0], arr.shape[1]))], dim=0)
                parts.append(arr)
            return parts[0] if len(parts) == 1 else \
                torch.cat(parts, dim=0)

    label = node0.label if solo else \
        f"{node0.label or 'node'}+{len(members) - 1}"
    merged.add(node0.compiled, rows=total_pad, build=build, deps=deps,
               result_cols=node0.result_cols, label=label,
               block_valid=tuple(block_valid) if not solo else None,
               upload_cycles=node0.upload_cycles,
               resident_key=node0.resident_key)
