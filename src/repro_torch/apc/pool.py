"""Array-pool pipelined executor: many MvCAM arrays, one schedule.

The paper's AP is not one array — it is a *bank* of MvCAM arrays, each with
a bounded row count and column budget.  :class:`ArrayPool` models that bank
for the fused program executor, on one device (``device=None`` =
``cuda:0``, see :mod:`repro_torch.device`):

- **Column budget.**  A program only runs if its ``min_cols`` fits the
  pool's per-array ``cols``; serving-scale MAC programs that do not fit go
  through the K-tiled compile (:func:`~repro_torch.apc.mac.compile_mac_tiled`)
  whose per-tile partial sums and reduction rows all respect the budget.
- **Row-block streaming.**  An input taller than one array streams through
  the pool in ``rows``-row blocks, block ``b`` on array ``b % n_arrays``
  in wave ``b // n_arrays``.  The reference issues one kernel launch per
  block; here one launch of the program kernel covers every block of a
  :meth:`ArrayPool.run` (``block_rows = rows``), and the kernel writes one
  counter row per block, so the per-block counters are the reference's.
- **One schedule tensor set.**  The schedule of a
  :class:`~repro_torch.apc.lower.CompiledProgram` is uploaded once per
  pool (per program and variant) and shared by every launch (the AP
  sequencer's single microcode store), so the program kernel's slot
  records are encoded once too.
- **Global stats.**  Per-block :class:`~repro_torch.apc.stats.TracedStats`
  counters are row sums, invariant to how rows were split across arrays,
  so ``accumulate`` yields APStats bit-identical to a single-array
  :func:`~repro_torch.apc.exec.execute`.  :meth:`ArrayPool.wall_cycles`
  gives the *pipelined* wall-clock cycle count instead:
  ``ceil(n_blocks / n_arrays) * program_cycles``.
- **Faults.**  With a :class:`~repro_torch.apc.faults.FaultConfig` the
  pool models the array writes (stuck cells, flips, dead arrays), verifies
  each stored block by running the IR-compiled checksum through the
  program kernel, retries on the next healthy array and retires arrays,
  in the reference's host loop (:meth:`ArrayPool._run_faulty`).

:func:`run_mac_tiled` drives a whole K-tiled ternary MAC through the pool:
device-side encode of each tile's rows, one pooled run per tile program,
then the ripple-add reduction chain over the partial-accumulator digit
blocks, with every program's counters folded into one APStats.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.ap import APStats
from ..core.energy import T_EVALUATE_NS, T_PRECHARGE_NS, T_WRITE_NS
from ..device import as_digits, resolve_device
from ..kernels.tap_pass.kernel import program_tensors_on, tap_run_program
from ..kernels.tap_pass.ops import _pad_rows
from . import trace
from .caches import (ResidentEvicted, ResidentHandle, ResidentStale,
                     ResidentStore)
from .faults import (FaultConfig, FaultDetected, FaultModel, expected_checksum,
                     fault_config_from_env, faults_enabled, validate_digits)
from .lower import CompiledProgram, compile_checksum, resolve_schedule
from .metrics import get_registry
from .mac import (TiledMac, assemble_mac_rows_jnp, decode_signed_digits_jnp,
                  encode_mac_rows_jnp, encode_mac_x_rows_jnp,
                  encode_weight_digits_jnp, mac_layout, weight_digest)
from .stats import HIST_BINS, TracedStats, accumulate

MAX_MASKS = 64                   # block_valid tuples whose masks are kept


def resident_enabled() -> bool:
    """The ``REPRO_AP_RESIDENT`` env knob: when truthy,
    :func:`run_mac_tiled` auto-pins weight digit planes into the pool's
    resident store (content-keyed) even when the caller passes no handle,
    to prove the weight-stationary path stays bit-exact."""
    return os.environ.get("REPRO_AP_RESIDENT", "0").lower() in (
        "1", "true", "yes", "on")


def _empty_counts(device) -> TracedStats:
    return TracedStats(torch.zeros((1, 2 + HIST_BINS), dtype=torch.int32,
                                   device=device))


class ArrayPool:
    """A bank of ``n_arrays`` MvCAM arrays of ``rows`` x ``cols`` digits on
    ``device`` (``None`` = ``cuda:0``)."""

    def __init__(self, n_arrays: int = 4, rows: int = 4096,
                 cols: int = 256, *, kernel_variant: str | None = None,
                 resident_slots: int = 256,
                 faults: FaultConfig | None = None, device=None):
        if n_arrays < 1:
            raise ValueError(f"n_arrays must be >= 1, got {n_arrays}")
        if rows < 1 or cols < 1:
            raise ValueError(f"array shape {rows}x{cols} must be positive")
        self.n_arrays = n_arrays
        self.rows = rows
        self.cols = cols
        self.device = resolve_device(device)
        # device fault model: explicit config wins, else the
        # REPRO_AP_FAULTS env knob; None keeps every path bit-identical
        # to a fault-free pool (one attribute check per run)
        if faults is None and faults_enabled():
            faults = fault_config_from_env()
        self.fault_model = (FaultModel(faults, n_arrays, rows, cols)
                            if faults is not None else None)
        # honest pricing of fault handling: checksum verifies and retry
        # replays append (traced, compiled, n_rows, label) charges here;
        # whichever caller owns the APStats drains them via
        # consume_fault_charges (bounded so an undrained pool can't grow)
        self._fault_charges: list[
            tuple[TracedStats, CompiledProgram, int, str]] = []
        # weight-stationary resident-operand store: digit planes written
        # into the bank once and reused across calls (bounded, visible in
        # caches.cache_stats)
        self.resident = ResidentStore(maxsize=resident_slots)
        # pool-level execution knob: per-call kwargs override, None means
        # the default variant (apc.lower.default_kernel_variant)
        self.kernel_variant = kernel_variant
        # one uploaded schedule per (compiled program, resolved variant,
        # device), shared by every launch; the CompiledProgram is pinned in
        # the value so its id (the key) can never be recycled onto a
        # different program
        self._schedules: dict[
            tuple[int, str, str],
            tuple[CompiledProgram, tuple[torch.Tensor, ...], str, int]] = {}
        self._max_schedules = 64
        # block_valid tuple -> (counts on the device, index of the valid
        # rows in the launch), built once per tuple
        self._masks: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def __repr__(self) -> str:
        return (f"ArrayPool(n_arrays={self.n_arrays}, rows={self.rows}, "
                f"cols={self.cols})")

    # -- validation ---------------------------------------------------------

    def validate(self, compiled: CompiledProgram,
                 n_cols: int | None = None) -> None:
        """Up-front column-budget checks, before any schedule upload or
        launch: the program's row width (``compiled.min_cols``, the widest
        compare/write column + 1) must fit the pool's per-array ``cols``,
        and the row array must carry at least that many but no more than
        ``cols`` digit columns."""
        if compiled.min_cols > self.cols:
            raise ValueError(
                f"program is {compiled.min_cols} columns wide, pool arrays "
                f"have {self.cols} — compile a tiled program "
                f"(compile_mac_tiled) or widen the pool")
        if n_cols is None:
            return
        if n_cols < compiled.min_cols:
            raise ValueError(
                f"array has {n_cols} columns, program is "
                f"{compiled.min_cols} columns wide")
        if n_cols > self.cols:
            raise ValueError(
                f"rows carry {n_cols} digit columns, pool arrays hold "
                f"{self.cols}")

    def _check_block_valid(self, n_rows: int,
                           block_valid: tuple[int, ...] | None) -> None:
        if block_valid is None:
            return
        if n_rows == 0 or n_rows % self.rows:
            raise ValueError(
                f"block_valid launches must be whole {self.rows}-row "
                f"blocks, got {n_rows} rows")
        if len(block_valid) != n_rows // self.rows:
            raise ValueError(
                f"block_valid has {len(block_valid)} entries for "
                f"{n_rows // self.rows} blocks")
        if any(not 1 <= v <= self.rows for v in block_valid):
            raise ValueError(
                f"block_valid entries must be in [1, {self.rows}], "
                f"got {block_valid}")

    # -- schedule store -----------------------------------------------------

    def _device_schedule(self, compiled: CompiledProgram,
                         kernel_variant: str | None = None, device=None
                         ) -> tuple[tuple[torch.Tensor, ...], str, int]:
        """Schedule tensors on ``device`` (the pool's by default) for the
        resolved kernel variant, uploaded once per (program, variant,
        device); returns ``(sched, variant, pack)`` ready for
        ``tap_run_program``."""
        kernel_variant = (self.kernel_variant if kernel_variant is None
                          else kernel_variant)
        device = self.device if device is None else device
        host, variant, pack, name = resolve_schedule(compiled,
                                                     kernel_variant)
        key = (id(compiled), name, str(device))
        hit = self._schedules.get(key)
        if hit is not None:
            get_registry().counter("pool.schedule_reuse").inc()
            return hit[1], hit[2], hit[3]
        sched = program_tensors_on(host, device)
        while len(self._schedules) >= self._max_schedules:   # FIFO evict
            self._schedules.pop(next(iter(self._schedules)))
        self._schedules[key] = (compiled, sched, variant, pack)
        get_registry().counter("pool.schedule_uploads").inc()
        trace.instant("schedule_upload", cat="pool", program=name,
                      steps=compiled.n_steps, variant=variant)
        return sched, variant, pack

    def _block_mask(self, block_valid: tuple[int, ...]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``block_valid`` as an int32 tensor on the device, and the index
        of the valid rows of a launch of ``len(block_valid)`` blocks (the
        compaction), built once per tuple."""
        hit = self._masks.get(block_valid)
        if hit is None:
            bv = torch.tensor(block_valid, dtype=torch.int32,
                              device=self.device)
            local = torch.arange(self.rows, device=self.device)
            keep = (local[None, :] < bv[:, None]).reshape(-1)
            idx = torch.nonzero(keep).squeeze(1)
            if len(self._masks) >= MAX_MASKS:
                self._masks.pop(next(iter(self._masks)))
            hit = self._masks[block_valid] = (bv, idx)
        return hit

    # -- bank health --------------------------------------------------------

    @property
    def dead_arrays(self) -> tuple[int, ...]:
        """Retired array indices (empty without a fault model)."""
        if self.fault_model is None:
            return ()
        return tuple(sorted(self.fault_model.retired))

    def healthy_arrays(self) -> list[int]:
        """Surviving array indices; raises :class:`FaultDetected` when
        the whole bank has been retired."""
        if self.fault_model is None:
            return list(range(self.n_arrays))
        h = self.fault_model.healthy()
        if not h:
            raise FaultDetected("every array in the bank is retired")
        return h

    def consume_fault_charges(self) -> list[
            tuple[TracedStats, CompiledProgram, int, str]]:
        """Drain the pending checksum/retry stat charges (the caller
        accumulates them into its APStats)."""
        out, self._fault_charges = self._fault_charges, []
        return out

    def _charge(self, traced: TracedStats, compiled: CompiledProgram,
                n_rows: int, label: str) -> None:
        if len(self._fault_charges) < 4096:
            self._fault_charges.append((traced, compiled, n_rows, label))
        else:
            get_registry().counter("faults.charges_dropped").inc()

    # -- cost model ---------------------------------------------------------

    def n_blocks(self, n_rows: int) -> int:
        return -(-n_rows // self.rows)

    def wall_cycles(self, n_rows: int, n_compare_cycles: int,
                    n_write_cycles: int) -> dict[str, int]:
        """Pipelined wall-clock cycles: arrays run blocks in parallel, so a
        program over ``n_rows`` costs ``ceil(n_blocks / n_alive)``
        sequential replays per array (a degraded bank has fewer arrays to
        deal blocks over, so its waves stretch — the repriced cost model)."""
        alive = self.n_arrays if self.fault_model is None \
            else max(1, len(self.fault_model.healthy()))
        waves = max(1, -(-self.n_blocks(max(1, n_rows)) // alive))
        return {"waves": waves,
                "compare_cycles": waves * n_compare_cycles,
                "write_cycles": waves * n_write_cycles}

    def program_ns(self, compiled: CompiledProgram) -> float:
        """Table-XI-ns duration of one program replay (one wave)."""
        return (compiled.n_compare_cycles
                * (T_PRECHARGE_NS + T_EVALUATE_NS)
                + compiled.n_write_cycles * T_WRITE_NS)

    def block_intervals(self, n_blocks: int, compiled: CompiledProgram
                        ) -> list[tuple[int, int, int, float, float]]:
        """The launch grid of one :meth:`run` on the model-time axis:
        ``(block, array, wave, start_ns, end_ns)`` per block (block ``b``
        on array ``b % n_arrays`` in wave ``b // n_arrays``, one
        ``program_ns`` per wave) — the join key
        :func:`repro_torch.apc.power.pool_power` uses to place each block's
        traced counters in time."""
        p_ns = self.program_ns(compiled)
        if self.fault_model is None:
            healthy = None
        else:
            # degraded bank: blocks deal over the surviving arrays only
            # (array identity preserved).  Retirement mid-run makes this a
            # post-hoc approximation of where earlier blocks actually ran.
            healthy = self.healthy_arrays()
        out = []
        for b in range(n_blocks):
            if healthy is None:
                w, a = divmod(b, self.n_arrays)
            else:
                w, i = divmod(b, len(healthy))
                a = healthy[i]
            out.append((b, a, w, w * p_ns, (w + 1) * p_ns))
        return out

    # -- execution ----------------------------------------------------------

    def _launch(self, padded: torch.Tensor, n_rows: int, sched, pack: int,
                collect_stats: bool, block_valid: tuple[int, ...] | None):
        """One program-kernel launch over every block of ``padded``: one
        counter row per block, padding masked as the reference's per-block
        launches mask it."""
        bv = None if block_valid is None else self._block_mask(block_valid)[0]
        return tap_run_program(padded, *sched, n_rows, block_rows=self.rows,
                               collect_stats=collect_stats, pack=pack,
                               block_valid=bv)

    def run(self, arr, compiled: CompiledProgram, *,
            collect_stats: bool = False, kernel_variant: str | None = None,
            block_valid: tuple[int, ...] | None = None,
            radix: int | None = None
            ) -> tuple[torch.Tensor, TracedStats | None]:
        """Stream [rows, cols] digit rows through the pool.

        Output and (when ``collect_stats``) accumulated APStats are
        bit-identical to single-array :func:`~repro_torch.apc.exec.execute`
        for every kernel variant; ``kernel_variant`` defaults to the
        pool-level knob, then the backend default.  The counters hold one
        row per ``rows``-row block.

        ``block_valid`` marks a row-concatenated launch (see
        :class:`~repro_torch.apc.graph.GraphNode`): block ``b`` carries
        ``block_valid[b]`` valid rows at its top, the rest is padding.
        Padding rows are masked out of the counters exactly like an
        ordinary launch's tail block, and the returned digit array is
        compacted to the valid rows (``sum(block_valid)`` rows) on the
        device — so each segment's digits and per-block counters are
        bit-identical to launching it alone.

        ``radix`` declares the program's digit levels for fault
        verification; it is ignored (and the fault path never taken) when
        the pool has no fault model installed.
        """
        if self.fault_model is not None:
            return self._run_faulty(
                arr, compiled, collect_stats=collect_stats,
                kernel_variant=kernel_variant, block_valid=block_valid,
                radix=radix)
        arr = as_digits(arr, self.device)
        n_rows, n_cols = arr.shape
        self.validate(compiled, n_cols=n_cols)
        self._check_block_valid(n_rows, block_valid)
        if n_rows == 0:
            return arr, _empty_counts(arr.device) if collect_stats else None
        sched, variant, pack = self._device_schedule(compiled,
                                                     kernel_variant)
        n_blocks = self.n_blocks(n_rows)
        padded, _ = _pad_rows(arr, self.rows)
        program_ns = self.program_ns(compiled)
        wall = self.wall_cycles(n_rows, compiled.n_compare_cycles,
                                compiled.n_write_cycles)
        with trace.span("pool.run", cat="pool", rows=n_rows,
                        blocks=n_blocks, n_arrays=self.n_arrays,
                        steps=compiled.n_steps, variant=variant,
                        predicted_waves=wall["waves"],
                        predicted_compare_cycles=wall["compare_cycles"],
                        predicted_write_cycles=wall["write_cycles"],
                        predicted_ns=wall["waves"] * program_ns
                        ) as run_span:
            out, raw = self._launch(padded, n_rows, sched, pack,
                                    collect_stats, block_valid)
            if run_span is not None:
                self._trace_blocks(run_span, compiled, n_rows, block_valid)
        get_registry().counter("pool.launches").inc(n_blocks)
        if block_valid is None:
            out = out[:n_rows]
        else:
            out = out.index_select(0, self._block_mask(block_valid)[1])
        return out, (TracedStats(raw) if collect_stats else None)

    def _trace_blocks(self, run_span, compiled: CompiledProgram,
                      n_rows: int, block_valid: tuple[int, ...] | None
                      ) -> None:
        """The reference's per-block events of one run, inside its
        ``pool.run`` span: one span per wave (predicted cycles in args),
        one launch instant per block, and the Table-XI-timed rendering of
        each block on its array's model-time track."""
        tr = run_span.tracer
        program_ns = self.program_ns(compiled)
        n_blocks = self.n_blocks(n_rows)
        for w in range(-(-n_blocks // self.n_arrays)):
            first = w * self.n_arrays
            with tr.span(f"wave{w}", cat="pool",
                         blocks=min(self.n_arrays, n_blocks - first),
                         predicted_compare_cycles=compiled.n_compare_cycles,
                         predicted_write_cycles=compiled.n_write_cycles,
                         predicted_ns=program_ns):
                for b in range(first, min(first + self.n_arrays, n_blocks)):
                    valid = (min(self.rows, n_rows - b * self.rows)
                             if block_valid is None else block_valid[b])
                    tr.instant("launch", cat="pool", block=b,
                               array=b - first, rows=valid)
                    tr.model_span(f"block{b}", track=f"arr{b - first}",
                                  start_ns=run_span.ts_ns + w * program_ns,
                                  dur_ns=program_ns, block=b, rows=valid)

    # -- faulty execution ---------------------------------------------------

    def _run_faulty(self, arr, compiled, *, collect_stats, kernel_variant,
                    block_valid, radix):
        """:meth:`run` over a bank with an installed fault model.

        One launch computes every block's intended digits with the kernel;
        then, block by block on the host (recovery needs the stored digits
        there anyway), model the array write — stuck cells + transient
        flips corrupt what the array stores — and verify the stored block
        against the mod-r checksum of the intended digits (the IR-compiled
        fold, cycles charged) plus digit-range validation.  A failed verify
        retries on the next healthy array, rotating, up to
        ``cfg.max_retries`` remaps; arrays crossing ``cfg.retire_after``
        detections are retired permanently.  Exhausted retries raise
        :class:`FaultDetected` with the failing (block, array).  The host
        loop is the reference's, attempt for attempt, so the seeded draws
        advance identically.
        """
        fm = self.fault_model
        r = fm.cfg.radix if radix is None else int(radix)
        arr = as_digits(arr, self.device)
        n_rows, n_cols = arr.shape
        self.validate(compiled, n_cols=n_cols)
        self._check_block_valid(n_rows, block_valid)
        if n_rows == 0:
            return arr, _empty_counts(arr.device) if collect_stats else None
        sched, variant, pack = self._device_schedule(compiled,
                                                     kernel_variant)
        reg = get_registry()
        n_blocks = self.n_blocks(n_rows)
        padded, _ = _pad_rows(arr, self.rows)
        outs = []
        with trace.span("pool.run_faulty", cat="pool", rows=n_rows,
                        blocks=n_blocks, variant=variant):
            out, raw = self._launch(padded, n_rows, sched, pack,
                                    collect_stats, block_valid)
            intent = out.cpu().numpy()          # the intended digits
            for b in range(n_blocks):
                lo = b * self.rows
                valid = (min(self.rows, n_rows - lo) if block_valid is None
                         else block_valid[b])
                true_np = intent[lo:lo + self.rows]
                healthy = self.healthy_arrays()
                base = b % len(healthy)
                stored = a = None
                for attempt in range(fm.cfg.max_retries + 1):
                    healthy = self.healthy_arrays()
                    a = healthy[(base + attempt) % len(healthy)]
                    fm.record_write(a, compiled.n_write_cycles)
                    if attempt:
                        # a retry replays the whole program on the remap
                        # target: charge another schedule-static replay
                        # (per-row set/reset counters are not re-measured
                        # — a documented approximation)
                        reg.counter("faults.retries").inc()
                        self._charge(_empty_counts(self.device), compiled,
                                     self.rows, f"fault_retry:b{b}")
                        trace.fault("fault_retry", block=b, array=a,
                                    attempt=attempt)
                    cand = fm.corrupt(true_np, a, r)
                    bad = self._verify_block(cand, true_np, valid, r)
                    if bad is None:
                        stored = cand
                        break
                    reg.counter("faults.detected").inc()
                    trace.fault("fault_detected", block=b, array=a,
                                rows=len(bad))
                    if fm.record_detection(a):
                        reg.counter("faults.retired").inc()
                        reg.gauge("faults.retired_arrays").set(
                            len(fm.retired))
                        trace.fault("array_retired", array=a,
                                    detections=fm.detections[a])
                if stored is None:
                    raise FaultDetected(
                        f"block {b} failed verification after "
                        f"{fm.cfg.max_retries + 1} attempts "
                        f"(last array {a})", block=b, array=a)
                outs.append(stored[:valid])
        reg.counter("pool.launches").inc(n_blocks)
        out = torch.from_numpy(np.concatenate(outs, axis=0)).to(self.device)
        return out, (TracedStats(raw) if collect_stats else None)

    def _verify_block(self, stored, true_np, valid, radix):
        """Detection: digit-range validation + mod-r checksum verify of a
        stored block against the intended digits.  Returns None when
        clean, else the failing row indices.

        The checksum is computed by running the IR-compiled fold
        (:func:`~repro_torch.apc.lower.compile_checksum`) through the
        program kernel over the stored block with a spare checksum column
        appended — so detection costs real compare/write cycles, charged
        via :meth:`consume_fault_charges`.  When the program already uses
        every pool column there is no spare column; the verify falls back
        to a host-side sum and counts the fallback."""
        sv = stored[:valid]
        oob = (sv < 0) | (sv >= radix)
        if oob.any():
            return np.nonzero(oob.any(axis=1))[0]
        expected = expected_checksum(true_np[:valid], radix)
        n_cols = stored.shape[1]
        if n_cols < self.cols:
            cs_prog = compile_checksum(n_cols, radix)
            cs_in = np.concatenate(
                [stored, np.zeros((stored.shape[0], 1), np.int8)], axis=1)
            sched, _, pack = self._device_schedule(cs_prog)
            out, raw = tap_run_program(
                torch.from_numpy(cs_in).to(self.device), *sched, valid,
                block_rows=self.rows, collect_stats=True, pack=pack)
            got = out[:valid, n_cols].cpu().numpy().astype(np.int64)
            self._charge(TracedStats(raw), cs_prog, self.rows,
                         "fault_checksum")
            get_registry().counter("faults.checksum_runs").inc()
        else:
            get_registry().counter("faults.checksum_host_fallback").inc()
            got = sv.astype(np.int64).sum(axis=1) % radix
        bad = np.nonzero(got != expected)[0]
        return bad if bad.size else None


def run_pooled(arr, compiled: CompiledProgram, pool: ArrayPool, *,
               stats: APStats | None = None,
               kernel_variant: str | None = None) -> torch.Tensor:
    """Driver-style front door: pool.run + optional APStats accumulate
    (mirrors :func:`repro_torch.apc.exec.run` for the single-array path).
    ``pool.run`` validates the column budget before any schedule upload."""
    with trace.span("run_pooled", cat="pool", rows=arr.shape[0]):
        out, traced = pool.run(arr, compiled,
                               collect_stats=stats is not None,
                               kernel_variant=kernel_variant)
        if stats is not None:
            accumulate(stats, traced, compiled, n_rows=arr.shape[0])
        drain_fault_charges(pool, stats)
    return out


def drain_fault_charges(pool: ArrayPool | None,
                        stats: APStats | None) -> None:
    """Fold the pool's pending fault-handling charges (checksum verifies,
    retry replays) into ``stats`` — or discard them when no APStats owner
    exists, so charges can never leak into a later caller's accounting.
    No-op (and zero-cost) without a fault model."""
    if pool is None or pool.fault_model is None:
        return
    for traced, compiled, n_rows, label in pool.consume_fault_charges():
        if stats is not None:
            accumulate(stats, traced, compiled, n_rows=n_rows, label=label)


def run_mac_tiled(x, w_ter, tiled: TiledMac, *, pool: ArrayPool | None = None,
                  stats: APStats | None = None,
                  block_rows: int | None = None,
                  kernel_variant: str | None = None,
                  resident: ResidentHandle | None = None,
                  device=None) -> torch.Tensor:
    """ACC = sum_k w_k * x_k through the K-tiled programs, over a pool.

    ``x`` [R, K] integers, ``w_ter`` [R, K] in {-1, 0, +1} (tensors or
    numpy, moved to the pool's device, else to ``device``; ``None`` =
    ``cuda:0``).  Each tile's partial-accumulator digit block is carried
    forward on the device into the ripple-add reduction rows; the return
    value is the signed int32 dot product per row, decoded on the device —
    the caller's conversion is the ONE host sync.

    ``pool=None`` runs every program on the single-array executor (same
    digits, same counters) — the tiled-vs-untiled equivalence oracle.

    ``resident`` (weight-stationary dataflow): a
    :class:`~repro_torch.apc.caches.ResidentHandle` whose digit plane is
    ``[R_w, K]`` with ``R_w`` dividing R; the weight-side encode is
    SKIPPED entirely and each tile's weight columns are sliced from the
    resident plane (row-tiled up to R, matching
    :func:`~repro_torch.apc.mac.matmul_mac_rows` ordering).  A stale or
    evicted handle is re-pinned from ``w_ter`` when there is a pool, and
    raises without one.  With :func:`resident_enabled` and a pool, an
    auto-handle is pinned content-keyed into ``pool.resident`` when the
    caller passes none — hits skip the weight encode just the same.
    """
    from .exec import execute                       # lazy: import cycle
    from .graph import CARRIED, fold_stage_input, mac_fold_plan
    dev = pool.device if pool is not None else resolve_device(device)
    x = torch.as_tensor(x).to(dev)
    w_ter = torch.as_tensor(w_ter).to(dev)
    R, K = x.shape
    if K != tiled.K:
        raise ValueError(f"x has K={K}, tiled program compiled for "
                         f"K={tiled.K}")
    if pool is not None and block_rows is not None:
        raise ValueError("block_rows only applies without pool=; the "
                         "pool's own rows govern block streaming")
    if pool is not None:
        for prog in tiled.programs + tiled.reduce_programs:
            pool.validate(prog)                     # fail before any launch
    radix, width = tiled.radix, tiled.width
    if resident is None and pool is not None and resident_enabled():
        digest = weight_digest(w_ter)
        resident = pool.resident.pin(
            f"auto:{digest}", digest,
            lambda: encode_weight_digits_jnp(w_ter))
    plane = None
    if resident is not None:
        try:
            plane = resident.resolve()
        except (ResidentStale, ResidentEvicted):
            # churn recovery: the plane fell out of the bounded store (or
            # was re-pinned under the same key) between pin and use —
            # re-pin from the always-available source weights and go on
            if pool is None or w_ter is None:
                raise                       # no source to re-encode from
            get_registry().counter("resident.repins").inc()
            trace.instant("resident_repin", cat="pool", key=resident.key)
            digest = weight_digest(w_ter)
            resident = pool.resident.pin(
                resident.key, digest,
                lambda: encode_weight_digits_jnp(w_ter))
            plane = resident.resolve()
        plane = plane.to(dev)
        rw, kw = plane.shape
        if kw != K or R % rw:
            raise ValueError(
                f"resident plane is {rw}x{kw}, rows R={R} K={K} need a "
                f"[R_w, K] plane with R_w dividing R")
        reps = R // rw

    def _run(arr, compiled, label):
        if pool is not None:
            out, traced = pool.run(arr, compiled,
                                   collect_stats=stats is not None,
                                   kernel_variant=kernel_variant,
                                   radix=radix)
            drain_fault_charges(pool, stats)
        else:
            out, traced = execute(arr, compiled,
                                  collect_stats=stats is not None,
                                  block_rows=block_rows,
                                  kernel_variant=kernel_variant, device=dev)
        if stats is not None:
            accumulate(stats, traced, compiled, n_rows=R, label=label)
        return out

    with trace.span("run_mac_tiled", cat="pool", rows=R, k=K,
                    tiles=len(tiled.tiles), k_tile=tiled.k_tile):
        partials: list[torch.Tensor] = []           # [R, width] digit blocks
        for t, ((lo, hi), prog) in enumerate(zip(tiled.tiles,
                                                 tiled.programs)):
            kt = hi - lo
            if plane is None:
                arr_t = encode_mac_rows_jnp(x[:, lo:hi], w_ter[:, lo:hi],
                                            radix, width)
            else:
                # weight-stationary: x-side encode only, weight digits
                # sliced from the resident plane (zero weight encode work)
                wd = plane[:, lo:hi]
                if reps > 1:
                    wd = wd.repeat(reps, 1)
                arr_t = assemble_mac_rows_jnp(
                    encode_mac_x_rows_jnp(x[:, lo:hi], radix, width),
                    wd, width)
            out = _run(arr_t, prog, f"tile{t}[{lo}:{hi}]")
            base = mac_layout(kt, width)["acc_base"]
            partials.append(out[:, base:base + width])
        # sequential replay of the shared fold plan (graph.mac_fold_plan is
        # the single source of truth for which partials feed which
        # reduction)
        carried = partials[0]
        for j, stage in enumerate(mac_fold_plan(tiled)):
            group = [carried if p == CARRIED else partials[p]
                     for p in stage.parts]
            out = _run(fold_stage_input(group), stage.prog, f"reduce{j}")
            carried = out[:, stage.out_lo:stage.out_hi]
        if pool is not None and pool.fault_model is not None:
            # decode-time digit-range validation: the last detection line
            # before corrupted digits would silently decode into values
            validate_digits(carried.cpu().numpy(), radix,
                            what="mac accumulator digits")
        return decode_signed_digits_jnp(carried, radix)
