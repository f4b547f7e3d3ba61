"""Continuous-batching AP serving: merge in-flight requests into shared waves.

The port of :mod:`repro.serve.batcher`.  The AP's batch axis is the pool's
ROW axis: independent requests' token rows can share one schedule replay
(`ArrayPool.run` streams row blocks through the bank either way), so
serving requests one at a time leaves the bank under-occupied for no
reason.  This module drives many step-granular
:class:`~repro_torch.serve.engine.Request` objects in lockstep *waves* —
each wave advances every in-flight request by exactly one model step — and
merges the AP graphs those steps emit into ONE row-concatenated
:class:`~repro_torch.apc.graph.ProgramGraph` per graph call
(:func:`~repro_torch.apc.graph.coalesce_graphs`).

Bit-exactness contract: a request served through the batcher produces the
same tokens AND the same per-request :class:`~repro_torch.core.ap.APStats` as
sequential `Engine.generate` serving.  Tokens because row concatenation is
block-aligned (every request's rows land in their own kernel blocks, padded
and masked exactly like a standalone tail block); stats because each merged
node's per-block traced counters are an exact partition over the source
requests (split by :class:`~repro_torch.apc.graph.MergedSlice` block
ranges) and the schedule-static compare/write cycles are charged per
source node, just like a sequential run.

Moving parts:

- :class:`WaveMerger` — the per-wave rendezvous.  Every request thread's
  ``ctx.run_graph`` (routed here by :func:`~repro_torch.apc.layers.
  ap_request_scope`) deposits its graph and double-waits on a barrier; the
  elected leader coalesces, runs the merged graph once
  (``collect_stats=True``), and splits results + counters per request.
  Counter syncs are *deferred* into each request's
  :class:`~repro_torch.apc.layers.APSink` so the host encodes wave k+1 while
  wave k's launches drain.
- :class:`BatchServer` — submission queue (:class:`~repro_torch.serve.queue.
  IterableQueue`) + dispatcher thread + admission control.  Admission
  prices a hypothetical wave (every active request's recorded per-step
  node profile, plus the candidate's) with
  :func:`~repro_torch.apc.graph.graph_makespan` and admits only while the
  makespan fits ``AdmissionCfg.max_wave_cycles`` (policy ``"queue"`` holds
  the candidate back; ``"reject"`` fails it with
  :class:`AdmissionRejected`).

The lockstep design assumes the model's AP graph cadence is config-static
(every request's step issues the same number of ``ctx.run_graph`` calls —
true for the packed-ternary MLP stack, where each layer runs exactly two
graphs).  A request that falls out of cadence (its step ends while a peer
waits at a graph call, or makes a graph call after a peer's step ended)
breaks the barrier, which surfaces as :class:`WaveAborted` rather than a
hang.

Threads: each request of a merged wave steps in a worker thread, which
starts with empty contextvars and its own grad mode and current device, so
it enters the engine's device, ``ap_serving`` and its ``ap_request_scope``
itself.  Only the wave's leader launches the merged graph's program
kernels, on the device's current stream; the dispatcher reads the kernels'
launch counts after the joins.

Tracing: the dispatcher and the workers record into the process's
installed tracer (:func:`~repro_torch.apc.trace.tracing`), each thread on
its own span stack.  A wave is ``serve.wave`` on the dispatcher, with its
pre-wave ``serve.checkpoint`` of each request inside; between waves the
dispatcher's ``serve.admit`` and ``serve.retire`` (a finished request's
``ap.sink_flush`` inside); on a worker, the request's ``serve.step``, and
inside it each wait at the rendezvous (``serve.wave_wait``) and, on the
leader, ``serve.wave_merge`` around the merged run.

On a named mesh (``engine.mesh`` a ``DeviceMesh``; one process per rank,
each with its own server, every rank submitting the same requests in the
same order) every step issues collectives, which the ranks' process
groups match by the order they are issued in.  So the ranks must step the
same requests in the same order, and do: rank 0 alone decides admission
and broadcasts its decisions and each wave's membership
(:class:`_MeshOrder`).  Two threads of the server issue collectives on a
rank, the dispatcher and, during a merged AP wave, its workers:

- the dispatcher thread issues :class:`_MeshOrder`'s, on a process group
  of the server's own (a ``new_group`` over the world, made on every rank
  when the server starts): rank 0's decisions, its heartbeat while idle,
  and after each wave the count of ranks on which each step failed.  No
  other thread uses that group, so the heartbeat cannot fall between two
  collectives of the model or of the caller;
- the steps of a float wave, and the solo replays after a wave abort,
  run on the dispatcher thread too, one request after another;
- a merged AP wave's worker threads take turns (:class:`WaveMerger` with
  ``ordered``): slot 0 runs its step up to its next graph call, then slot
  1, and so on, and again after each merged run, so each rank issues the
  model's collectives (on the mesh's groups) in slot order, one thread at
  a time, while the dispatcher waits for them.

No thread or group of the server outlives it: the dispatcher returns on
every rank after rank 0 has shared its last decision, the wave's threads
are joined before the next wave, and :meth:`BatchServer.close` frees the
server's group.  No wave reads a clock (on a mesh, a wave abort decided
by one rank's clock would replay steps solo there and leave the other
ranks' collectives unmatched): the turns and the barrier wait until the
peers come or one of them breaks the wave (:meth:`WaveMerger.finish`),
and the process group's own timeout ends a rank that never comes.  A
step that fails on some ranks only, after its last collective (in
sampling, say), fails on every rank with no solo replay: the peers of a
merged wave still run their steps to the end, and the ranks then count
each step's failures.  A step that fails on some ranks before a
collective it would have issued leaves the other ranks waiting in that
collective until the process group's timeout.  The turns are not free: phase
3h of ``chip_smoke.py`` measured an ordered merged AP wave at 1.34-1.51x
the host time of an unordered one on the card, since the slots' host
work (their APLinear builds above all) runs one slot at a time; the
merged graph still runs once for the wave.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..apc import trace
from ..apc.graph import (MergedGraphView, ProgramGraph, coalesce_graphs,
                         graph_makespan)
from ..apc.layers import APSink, ap_request_scope, ap_serving
from ..apc.metrics import get_registry
from ..apc.stats import TracedStats
from .engine import Engine, Request
from .monitor import ServeMonitor, SLOCfg
from .queue import ClosedQueue, IterableQueue

__all__ = ["AdmissionCfg", "AdmissionRejected", "BatchServer",
           "RequestHandle", "SLOCfg", "ServeMonitor", "WaveAborted",
           "WaveDiverged", "WaveMerger"]


class WaveAborted(RuntimeError):
    """A wave's rendezvous broke (a peer errored or fell out of cadence)."""


class WaveDiverged(RuntimeError):
    """On a named mesh, a request's step failed on some ranks only: it
    fails on every rank, with no solo replay."""


class AdmissionRejected(RuntimeError):
    """Admission control shed this request (policy='reject')."""


def _never_build(*_a):   # shadow-graph nodes are priced, never executed
    raise AssertionError("admission shadow graph is never run")


class WaveMerger:
    """Rendezvous that merges one wave's per-request graphs into one run.

    ``n_slots`` request threads each call :meth:`run_graph` once per graph
    call (after :meth:`bind`-ing their slot).  The call double-waits on a
    shared barrier: after the first wait every slot's graph is deposited
    and the elected leader coalesces + runs the merged graph; after the
    second, every thread picks up its own result view, charges its sink
    the standalone occupancy report of its OWN graph (identical numbers
    to sequential serving), and defers its slice of the traced counters.
    The barrier is reusable, so the same merger serves every graph call
    of one wave.  No wait has a clock: a slot whose step ends while a peer
    waits at a graph call (:meth:`finish`), or that makes a graph call
    after a peer's step ended, breaks the rendezvous.
    """

    def __init__(self, runtime, n_slots: int, *, track_power: bool = False,
                 ordered: bool = False):
        self.runtime = runtime
        self.n_slots = n_slots
        self._barrier = threading.Barrier(n_slots)
        # ordered: the slots run their stretches between graph calls one at
        # a time, in slot order (the turn passes at each graph call and at
        # the end of a step; the leader hands it back to slot 0 after each
        # merged run), so the collectives they issue keep one order
        self._ordered = ordered
        self._turn = 0
        self._cv = threading.Condition()
        self._aborted = False
        self._arrived = 0          # slots waiting at this graph call
        self._finished = 0         # slots whose step has ended
        self._tls = threading.local()
        self._graphs: list[ProgramGraph | None] = [None] * n_slots
        self._views: list[MergedGraphView | None] = [None] * n_slots
        self._reports: list[dict | None] = [None] * n_slots
        self._accums: list[list[tuple]] = [[] for _ in range(n_slots)]
        self._power_defers: list[tuple | None] = [None] * n_slots
        self._run_error: BaseException | None = None
        # when on, the leader also builds the MERGED wave's power timeline
        # (a host counter sync — gated because it defeats the deferred-
        # sync overlap; the per-request power joins stay deferred either
        # way) and records the bank peak in ``last_wave_peak_w``
        self.track_power = track_power
        self.last_wave_peak_w: float | None = None
        # per-slot, per-graph-call node profiles
        # (compiled, rows, deps, upload_cycles) — the admission oracle's
        # raw material (upload priced so resident-weight waves cost less)
        self.profiles: list[list[list[tuple]]] = [[] for _ in range(n_slots)]
        self.n_merged_runs = 0
        self.merged_nodes = 0
        self.source_nodes = 0

    def bind(self, slot: int) -> None:
        """Register the calling thread as ``slot`` for this wave."""
        self._tls.slot = slot

    def abort(self) -> None:
        """Break the rendezvous (peers see :class:`WaveAborted`)."""
        with self._cv:
            self._aborted = True
            self._cv.notify_all()
        self._barrier.abort()

    def enter(self, slot: int) -> None:
        """With ``ordered``, wait until it is ``slot``'s turn."""
        if not self._ordered:
            return
        with trace.span("serve.wave_wait", cat="serve", slot=slot,
                        at="turn"), self._cv:
            self._cv.wait_for(lambda: self._turn == slot or self._aborted)
            if self._turn != slot:
                raise WaveAborted(f"slot {slot}'s turn never came")

    def leave(self, slot: int) -> None:
        """With ``ordered``, pass the turn on from ``slot`` (if held)."""
        if not self._ordered:
            return
        with self._cv:
            if self._turn == slot:
                self._turn = slot + 1
                self._cv.notify_all()

    def finish(self, slot: int) -> None:
        """``slot``'s step has ended: pass its turn on, and break the
        rendezvous if a peer waits at a graph call that this slot will not
        make (out of cadence)."""
        with self._cv:
            self._finished += 1
            stranded = self._arrived > 0
        if stranded:
            self.abort()
        self.leave(slot)

    def run_graph(self, ctx, graph: ProgramGraph, sink: APSink):
        slot = self._tls.slot
        self._graphs[slot] = graph
        self.profiles[slot].append(
            [(n.compiled, n.rows, n.deps, n.upload_cycles)
             for n in graph.nodes])
        with self._cv:
            late = self._finished > 0         # a peer's step has ended
            self._arrived += not late
        if late:
            self.abort()
            raise WaveAborted(f"slot {slot} made a graph call after a "
                              f"peer's step ended (out of cadence)")
        self.leave(slot)
        try:
            with trace.span("serve.wave_wait", cat="serve", slot=slot,
                            at="deposit"):
                leader = self._barrier.wait() == 0   # all deposited
            if leader:
                with self._cv:
                    self._arrived = 0
                try:
                    with trace.span("serve.wave_merge", cat="serve",
                                    n_slots=self.n_slots):
                        self._merge_and_run(ctx)
                except BaseException as e:       # peers must not hang
                    self._run_error = e
                with self._cv:
                    self._turn = 0
            with trace.span("serve.wave_wait", cat="serve", slot=slot,
                            at="results"):
                self._barrier.wait()             # results ready
        except threading.BrokenBarrierError as e:
            raise WaveAborted("wave rendezvous broke") from e
        self.enter(slot)
        if self._run_error is not None:
            raise WaveAborted("merged wave run failed") from self._run_error
        view = self._views[slot]
        sink.add_report(self._reports[slot])
        for acc in self._accums[slot]:
            sink.defer(*acc)
        if self._power_defers[slot] is not None:
            sink.defer_power(*self._power_defers[slot])
        self._graphs[slot] = None
        return view

    def _merge_and_run(self, ctx) -> None:
        graphs = [g for g in self._graphs]
        if any(g is None for g in graphs):       # pragma: no cover
            raise RuntimeError("wave slot missing a graph")
        merged, maps = coalesce_graphs(graphs,
                                       block_rows=self.runtime.pool.rows)
        res = self.runtime.run_graph(merged, collect_stats=True)
        self.n_merged_runs += 1
        self.merged_nodes += len(merged)
        self.source_nodes += sum(len(g) for g in graphs)
        n_arrays_local = self.runtime.pool.n_arrays
        for slot, g in enumerate(graphs):
            m = maps[slot]
            # the standalone occupancy of this request's own graph: the
            # exact numbers sequential serving would have recorded (and,
            # via ``rec``, the schedule its power timeline is placed on)
            rec: list = []
            self._reports[slot] = self.runtime.makespan(g, record=rec)
            self._views[slot] = MergedGraphView(res, m, self._reports[slot])
            accums = []
            traced_map: dict[int, TracedStats] = {}
            labels: dict[int, str] = {}
            for nid, node in enumerate(g.nodes):
                sl = m[nid]
                tr = res.traced.get(sl.node)
                sliced = (TracedStats(
                    tr.block_counts[sl.block_lo:sl.block_hi])
                    if tr is not None else None)
                accums.append((sliced, node.compiled, node.rows,
                               node.label or f"node{nid}"))
                if sliced is not None:
                    traced_map[nid] = sliced
                labels[nid] = node.label or f"node{nid}"
            self._accums[slot] = accums
            # the per-request power join stays deferred (lazy device
            # slices; the sink syncs at flush) — same contract as the
            # counter defers above
            self._power_defers[slot] = (rec, traced_map, labels,
                                        n_arrays_local)
        if self.track_power:
            from ..apc.layers import N_MASKED_MAC
            from ..apc.power import graph_power
            tl = graph_power(
                res.schedule, res.traced, radix=merged.radix or 3,
                n_masked=N_MASKED_MAC, n_arrays_local=n_arrays_local)
            peak = 0.0
            for iv in tl.intervals:
                peak = max(peak, iv.power_w)
            self.last_wave_peak_w = peak


# ---------------------------------------------------------------------------
# Admission control: price the next wave before letting a request in
# ---------------------------------------------------------------------------

@dataclass
class AdmissionCfg:
    """Knobs gating how much concurrent work the bank accepts.

    ``max_inflight`` caps lockstep width outright.  ``max_wave_cycles``
    prices a hypothetical wave — every active request's recorded per-step
    node profile plus the candidate's — with the occupancy model and
    admits only while the makespan fits.  ``policy``: ``"queue"`` keeps
    inadmissible candidates waiting, ``"reject"`` fails them with
    :class:`AdmissionRejected`.
    """
    max_inflight: int = 8
    max_wave_cycles: int | None = None
    policy: str = "queue"          # "queue" | "reject"

    def __post_init__(self):
        if self.policy not in ("queue", "reject"):
            raise ValueError(f"policy must be 'queue' or 'reject', "
                             f"got {self.policy!r}")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")


def wave_cost_cycles(profiles, *, n_arrays: int, rows_per_array: int,
                     n_devices: int = 1,
                     dead_arrays: tuple[int, ...] = ()) -> int:
    """Occupancy-model makespan (cycles) of one wave built from per-request
    step profiles (lists of per-graph-call ``(compiled, rows, deps)`` or
    ``(compiled, rows, deps, upload_cycles)`` node lists — the 4th entry
    prices operand uploads, so resident-weight waves cost less)."""
    shadow = ProgramGraph()
    for prof in profiles:
        for gnodes in prof:
            base = len(shadow.nodes)
            for compiled, rows, deps, *rest in gnodes:
                shadow.add(compiled, rows=rows, build=_never_build,
                           deps=tuple(base + d for d in deps),
                           upload_cycles=rest[0] if rest else 0)
    if not len(shadow):
        return 0
    rep = graph_makespan(shadow, n_arrays=n_arrays,
                         rows_per_array=rows_per_array, n_devices=n_devices,
                         dead_arrays=dead_arrays)
    return int(rep["makespan_cycles"])


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------

class RequestHandle:
    """Future for one submitted request."""

    def __init__(self, prompts: np.ndarray, n_new: int, cross_embeds=None,
                 seq: int = 0):
        self.seq = seq                  # submission index on this server
        self.prompts = np.asarray(prompts)
        self.n_new = int(n_new)
        self.cross_embeds = cross_embeds
        self.submitted_at = time.perf_counter()
        self._event = threading.Event()
        self._tokens: np.ndarray | None = None
        self._error: BaseException | None = None
        self._ap_report: dict | None = None
        self.latency_ms: float | None = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Generated ids [B, n_new]; raises the request's failure, or
        TimeoutError if it is not finished within ``timeout``."""
        if not self._event.wait(timeout):
            raise TimeoutError("request not finished")
        if self._error is not None:
            raise self._error
        return self._tokens

    def ap_report(self, timeout: float | None = None) -> dict | None:
        """Per-request AP accounting (None on the float path)."""
        self.result(timeout)
        return self._ap_report

    def _finish(self, tokens=None, error: BaseException | None = None,
                ap_report: dict | None = None) -> None:
        self._tokens = tokens
        self._error = error
        self._ap_report = ap_report
        self.latency_ms = 1e3 * (time.perf_counter() - self.submitted_at)
        self._event.set()


class _Active:
    """Dispatcher-side state of one admitted request."""

    def __init__(self, handle: RequestHandle, request: Request,
                 sink: APSink | None):
        self.handle = handle
        self.request = request
        self.sink = sink
        self.profile: list[list[tuple]] | None = None   # last step's nodes
        self.error: BaseException | None = None


class BatchServer:
    """Continuous-batching front end over one :class:`Engine`.

    ``submit()`` enqueues; a dispatcher thread admits requests (admission
    control above), then drives all in-flight requests in lockstep waves —
    one model step per request per wave, AP graphs merged per graph call
    via :class:`WaveMerger`.  Requests join mid-stream (continuous
    batching: a new request's prefill steps ride the same waves as its
    neighbors' decode steps) and retire as they finish.

    With ``engine.ap_ctx is None`` the server still batches request
    *scheduling* (queue, admission by ``max_inflight``, lockstep waves)
    but each step runs the ordinary float path (the packed-matmul
    kernels) with nothing to merge.

    ``wave_timeout`` is accepted as the reference's server takes it and is
    read nowhere: no wave reads a clock (the module's docstring).
    """

    def __init__(self, engine: Engine, *,
                 admission: AdmissionCfg | None = None,
                 queue_maxsize: int = 0, wave_timeout: float | None = None,
                 slo: SLOCfg | None = None):
        del wave_timeout         # the reference's; no wave reads a clock
        self.engine = engine
        self.admission = admission or AdmissionCfg()
        self.queue = IterableQueue(queue_maxsize)
        self._pending: deque[RequestHandle] = deque()
        self._active: list[_Active] = []
        self.n_waves = 0
        self.monitor = ServeMonitor(slo)
        # a power SLO needs per-wave bank peaks, which cost a host sync
        # inside the wave — only pay for it when asked
        self._track_power = slo is not None and slo.peak_power_w is not None
        self.n_admitted = 0
        self.n_rejected = 0
        self.n_queued = 0
        self.max_queue_depth = 0
        self._closed = False
        self._last_profile: list[list[tuple]] | None = None
        self._n_submitted = 0
        self._submit_lock = threading.Lock()
        self._order = (_MeshOrder(engine.mesh, engine.device)
                       if engine.named else None)
        self._dispatcher = threading.Thread(target=self._dispatch,
                                            name="ap-serve-dispatch",
                                            daemon=True)
        self._dispatcher.start()

    # -- client side --------------------------------------------------------

    def submit(self, prompts: np.ndarray, n_new: int,
               cross_embeds=None) -> RequestHandle:
        """Enqueue one request; returns a :class:`RequestHandle` future.

        Raises ``RuntimeError`` once the server is closed or its
        dispatcher has exited — a handle is only ever returned when the
        request actually entered the queue, so no caller can block forever
        on a future nothing will resolve."""
        if self._closed or not self._dispatcher.is_alive():
            raise RuntimeError("BatchServer is closed")
        with self._submit_lock:          # seq and queue order agree
            h = RequestHandle(prompts, n_new, cross_embeds,
                              seq=self._n_submitted)
            try:
                self.queue.put(h)
            except ClosedQueue:
                raise RuntimeError("BatchServer is closed") from None
            self._n_submitted += 1
        return h

    def close(self, wait: bool = True) -> None:
        """Stop accepting requests; drain in-flight + queued work.

        ``wait=True`` joins the dispatcher and then FAILS (never strands)
        any handle that raced into the queue after the dispatcher exited,
        so ``result()`` on every submitted handle eventually returns or
        raises; on a named mesh it then frees the server's process group
        (every rank closes its server)."""
        if not self._closed:
            self._closed = True
            try:
                self.queue.close()
            except ClosedQueue:              # pragma: no cover - benign race
                pass
        if wait:
            self._dispatcher.join()
            self._fail_stranded(get_registry())
            if self._order is not None:
                self._order.close()

    def __enter__(self) -> "BatchServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(wait=True)

    # -- dispatcher side ----------------------------------------------------

    def _dispatch(self) -> None:
        reg = get_registry()
        order = self._order
        try:
            while True:
                if order is not None and not order.leader:
                    if not self._follow(reg):
                        return
                else:
                    self._drain_submissions(
                        block=not (self._active or self._pending),
                        timeout=None if order is None else order.heartbeat)
                    with trace.span("serve.admit", cat="serve"):
                        decisions = self._admit(reg)
                    stop = (not self._active and self.queue.closed
                            and self.queue.qsize() == 0
                            and not self._pending)
                    if order is not None:
                        order.share({"decisions": decisions, "stop": stop,
                                     "wave": self._wave_seqs()})
                    if stop:
                        return
                    # nothing active: wait for submissions (pending but
                    # inadmissible with nothing active cannot happen: an
                    # empty bank admits)
                    if not self._active:
                        continue
                self._run_wave(reg)
                with trace.span("serve.retire", cat="serve"):
                    self._retire(reg)
        finally:
            # normal drain leaves nothing behind; a crashed dispatcher
            # must not strand queued/active handles on never-set events
            self._fail_stranded(reg)

    def _fail_stranded(self, reg) -> None:
        """Terminal cleanup: fail every handle still queued, pending, or
        active with a clear error (idempotent; close() re-runs it after
        join to catch submissions that raced the dispatcher's exit)."""
        err = RuntimeError(
            "BatchServer dispatcher exited before this request ran")
        while True:
            try:
                self._pending.append(self.queue.get(timeout=0))
            except (StopIteration, _queue.Empty):
                break
        for h in self._pending:
            if not h.done:
                h._finish(error=err)
                reg.counter("serve.stranded").inc()
        self._pending.clear()
        for act in self._active:
            if not act.handle.done:
                act.handle._finish(error=err)
                reg.counter("serve.stranded").inc()
        self._active = []

    def _drain_submissions(self, block: bool,
                           timeout: float | None = None) -> None:
        """Move queued submissions to the pending deque; with ``block``,
        wait for the first (at most ``timeout`` seconds)."""
        while True:
            try:
                item = self.queue.get(timeout=timeout if block else 0)
            except StopIteration:
                return
            except _queue.Empty:
                return
            self._pending.append(item)
            block = False

    def _admissible(self, reg) -> bool:
        if len(self._active) >= self.admission.max_inflight:
            return False
        mwc = self.admission.max_wave_cycles
        if mwc is None or self.engine.ap_ctx is None:
            return True
        cand = self._last_profile
        if cand is None:                 # no profile yet: let it define one
            return not self._active
        profiles = [a.profile or cand for a in self._active] + [cand]
        pool = self.engine.ap_ctx.runtime.pool
        cost = wave_cost_cycles(
            profiles, n_arrays=pool.n_arrays, rows_per_array=pool.rows,
            n_devices=getattr(pool, "n_devices", 1),
            dead_arrays=getattr(pool, "dead_arrays", ()))
        reg.gauge("serve.admission_wave_cycles").set(cost)
        return cost <= mwc

    def _admit(self, reg) -> list[tuple[int, bool]]:
        """Admit or reject pending requests; the decisions, ``(seq,
        admitted)`` in order."""
        decisions = []
        while self._pending:
            if self._admissible(reg):
                h = self._pending.popleft()
                decisions.append((h.seq, True))
                self._start(h, reg)
            elif self.admission.policy == "reject":
                h = self._pending.popleft()
                decisions.append((h.seq, False))
                self._reject(h, reg)
            else:
                break                        # policy=queue: wait
        # per-handle queued accounting: a request counts as "queued" once,
        # the first time admission leaves it in the pending deque
        for h in self._pending:
            if not getattr(h, "_was_queued", False):
                h._was_queued = True
                self.n_queued += 1
        self.max_queue_depth = max(self.max_queue_depth, len(self._pending))
        reg.gauge("serve.inflight").set(len(self._active))
        reg.gauge("serve.queued").set(len(self._pending))
        return decisions

    def _start(self, h: RequestHandle, reg) -> None:
        """Admit ``h``: its request and sink join the active set (a request
        the engine refuses fails alone)."""
        try:
            sink = (APSink(radix=self.engine.ap_ctx.radix)
                    if self.engine.ap_ctx is not None else None)
            req = self.engine.new_request(h.prompts, h.n_new,
                                          h.cross_embeds)
        except Exception as e:               # bad request: fail just it
            h._finish(error=e)
            return
        req.seq = h.seq
        self._active.append(_Active(h, req, sink))
        self.n_admitted += 1
        reg.counter("serve.admitted").inc()

    def _reject(self, h: RequestHandle, reg) -> None:
        h._finish(error=AdmissionRejected(
            "admission control: bank saturated "
            f"(inflight={len(self._active)}, "
            f"max_inflight={self.admission.max_inflight}, "
            f"max_wave_cycles={self.admission.max_wave_cycles})"))
        self.n_rejected += 1
        reg.counter("serve.rejected").inc()

    def _wave_seqs(self) -> list[int]:
        return [a.handle.seq for a in self._active if not a.request.done]

    def _take(self, seq: int) -> RequestHandle:
        """This rank's handle of submission ``seq`` (waiting for it)."""
        while not self._pending or self._pending[-1].seq < seq:
            try:
                self._pending.append(self.queue.get(timeout=None))
            except StopIteration:
                raise RuntimeError(
                    f"rank 0 admitted request {seq}, which this rank's "
                    f"server was never given") from None
        h = self._pending.popleft()
        if h.seq != seq:
            raise RuntimeError(f"rank 0 decided on request {seq} where "
                               f"this rank has {h.seq} next")
        return h

    def _follow(self, reg) -> bool:
        """A rank other than 0 on a named mesh: apply rank 0's admission
        decisions; False when rank 0 stops.  Raises where this rank's wave
        would differ from rank 0's."""
        plan = self._order.share(None)
        for seq, admitted in plan["decisions"]:
            h = self._take(seq)
            if admitted:
                self._start(h, reg)
            else:
                self._reject(h, reg)
        if plan["stop"]:
            return False
        if self._wave_seqs() != plan["wave"]:
            raise RuntimeError(f"wave {self._wave_seqs()} differs from rank "
                               f"0's {plan['wave']}")
        return True

    def _run_wave(self, reg) -> None:
        stepping = [a for a in self._active if not a.request.done]
        if not stepping:
            return
        t0 = time.perf_counter()
        ctx = self.engine.ap_ctx
        merger = None
        with trace.span("serve.wave", cat="serve", wave=self.n_waves,
                        width=len(stepping)):
            if ctx is None:
                for act in stepping:
                    self._step_float(act)
                self._agree(stepping)
            else:
                # a lone request still goes through the merger (Barrier(1)
                # passes immediately): one code path, and the wave records
                # the step profile the admission oracle prices with
                merger = WaveMerger(ctx.runtime, len(stepping),
                                    track_power=self._track_power,
                                    ordered=self._order is not None)
                # pre-wave checkpoints: if a slot errors before a graph
                # call its siblings wait at, the barrier breaks and they
                # see WaveAborted mid-step —
                # these snapshots are what lets them roll back and re-run
                # solo instead of dying with the poison request
                ckpts = []
                for act in stepping:
                    with trace.span("serve.checkpoint", cat="serve",
                                    request=act.handle.seq):
                        ckpts.append((act.request.checkpoint(),
                                      act.sink.checkpoint()))
                threads = [threading.Thread(
                    target=self._step_merged,
                    args=(act, ctx, merger, slot),
                    name=f"ap-serve-w{self.n_waves}s{slot}", daemon=True)
                    for slot, act in enumerate(stepping)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                for slot, act in enumerate(stepping):
                    if act.error is None and merger.profiles[slot]:
                        act.profile = merger.profiles[slot]
                        self._last_profile = act.profile
                self._agree(stepping)
                self._recover_errored(reg, ctx, stepping, ckpts)
        wave_ms = 1e3 * (time.perf_counter() - t0)
        reg.histogram("serve.wave_ms").observe(wave_ms)
        self.monitor.observe_wave(
            wave_ms, inflight=len(stepping), queued=len(self._pending),
            bank_peak_w=merger.last_wave_peak_w if merger is not None
            else None)
        self.n_waves += 1

    def _agree(self, stepping) -> None:
        """On a named mesh: a step that failed on some ranks only fails on
        every rank (:class:`WaveDiverged`, never replayed solo)."""
        if self._order is None:
            return
        counts = self._order.count([a.error is not None for a in stepping])
        for act, n in zip(stepping, counts):
            if 0 < n < self._order.world:
                err = WaveDiverged(
                    f"request {act.handle.seq}'s step failed on {n} of "
                    f"{self._order.world} ranks")
                err.__cause__ = act.error
                act.error = err

    def _step_float(self, act: _Active) -> None:
        try:
            with self.engine.device_scope():
                act.request.step()
        except BaseException as e:
            act.error = e

    def _recover_errored(self, reg, ctx, stepping, ckpts) -> None:
        """Wave-abort blast-radius control (poison-request isolation).

        Any act that errored inside a merged wave — its own failure, or
        :class:`WaveAborted` collateral from a peer breaking the barrier —
        rolls back to its pre-wave checkpoint and replays the step SOLO on
        the dispatcher thread via the exact sequential serving path
        (:func:`~repro_torch.apc.layers.ap_request_scope` with no merger), so
        recovered siblings keep bit-identical tokens and stats.  Only a
        request that fails its solo replay too keeps an error on its
        handle; siblings and subsequent waves continue, on the (possibly
        degraded) bank."""
        errored = [(act, ck) for act, ck in zip(stepping, ckpts)
                   if act.error is not None
                   and not isinstance(act.error, WaveDiverged)]
        if not errored:
            return
        reg.counter("serve.wave_aborts").inc()
        for act, (req_ck, sink_ck) in errored:
            first = act.error
            act.request.restore(req_ck)
            act.sink.restore(sink_ck)
            act.error = None
            try:
                with trace.span("serve.solo_rerun", cat="serve"), \
                        self.engine.device_scope(), ap_serving(ctx), \
                        ap_request_scope(act.sink):
                    act.request.step()
            except BaseException as e:
                # deterministic failure: this is the poison request — it
                # fails alone (the original wave error is chained for the
                # handle's traceback)
                if not isinstance(first, WaveAborted):
                    e.__cause__ = first
                act.error = e
                reg.counter("serve.poisoned").inc()
            else:
                reg.counter("serve.solo_reruns").inc()

    def _step_merged(self, act: _Active, ctx, merger: WaveMerger,
                     slot: int) -> None:
        try:
            merger.bind(slot)
            merger.enter(slot)
            # worker threads start with a fresh context: enter the device
            # and the AP hook themselves, and route stats into this
            # request's sink
            with self.engine.device_scope(), ap_serving(ctx), \
                    ap_request_scope(act.sink, merger):
                act.request.step()
        except BaseException as e:
            # the peers go on: ``finish`` breaks the wave where one waits
            # for a graph call this slot will not make, and one past its
            # last graph call runs its step (on a mesh, its collectives)
            # to the end
            act.error = e
        finally:
            merger.finish(slot)

    def _retire(self, reg) -> None:
        still = []
        for act in self._active:
            if act.error is not None:
                act.handle._finish(error=act.error)
                reg.counter("serve.failed").inc()
            elif act.request.done:
                rep = None
                if act.sink is not None and act.sink.n_graphs > 0:
                    with trace.span("ap.sink_flush", cat="serve",
                                    request=act.handle.seq):
                        act.sink.flush()    # settle deferred counters
                    rep = act.sink.report()
                    pool = self.engine.ap_ctx.runtime.pool
                    rep["n_arrays_total"] = getattr(
                        pool, "total_arrays", pool.n_arrays)
                act.handle._finish(tokens=act.request.tokens(),
                                   ap_report=rep)
                reg.counter("serve.requests").inc()
                reg.histogram("serve.request_ms").observe(
                    act.handle.latency_ms)
                self.monitor.observe_request(
                    act.handle.latency_ms,
                    power_peak_w=(rep["power"]["peak_w"]
                                  if rep and rep.get("power") else None))
            else:
                still.append(act)
        self._active = still
        reg.gauge("serve.inflight").set(len(self._active))


class _MeshOrder:
    """The collectives a server on a named mesh (``engine.mesh``, which
    must span the world) issues besides the model's, all on the
    dispatcher thread and on a process group of their own (``group``, a
    ``new_group`` over the world that every rank makes when its server
    starts, and that no other code uses): rank 0's serving decisions,
    broadcast to the other ranks (:meth:`share`), and after each wave the
    count of ranks on which each step failed (:meth:`count`).  While rank
    0 has nothing to serve it still broadcasts every ``heartbeat``
    seconds, so the others' waits stay short of the group's timeout.
    :meth:`close` frees the group."""

    heartbeat = 10.0

    def __init__(self, mesh, device):
        import torch.distributed as dist
        self.world = dist.get_world_size()
        if mesh.mesh.numel() != self.world:
            raise ValueError(
                f"a BatchServer serves on a mesh of every rank: the mesh "
                f"has {mesh.mesh.numel()}, the world {self.world}")
        self.leader = dist.get_rank() == 0
        self.device = device if device.type == "cuda" else None
        self.group = dist.new_group(list(range(self.world)))

    def share(self, obj):
        """Rank 0's ``obj`` on every rank (picklable)."""
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self.device)
        return box[0]

    def count(self, flags: list[bool]) -> list[int]:
        """For each flag, how many ranks raised it."""
        import torch
        import torch.distributed as dist
        t = torch.tensor([int(f) for f in flags], dtype=torch.int32,
                         device=self.device or "cpu")
        dist.all_reduce(t, group=self.group)
        return t.tolist()

    def close(self) -> None:
        """Free ``group`` once this rank's dispatcher has returned: a last
        count first, so that no rank frees it while another still uses
        it."""
        import torch.distributed as dist
        if self.group is None:
            return
        self.count([False])
        dist.destroy_process_group(self.group)
        self.group = None
