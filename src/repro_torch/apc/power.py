"""Per-array power timelines from scheduled intervals + exact attribution.

The occupancy model already produces two things this module joins:

- **where the time goes** — ``graph_makespan(record=)`` emits one entry
  per (node, array) assignment with Table-XI-ns start/end timestamps,
  and :class:`~repro_torch.apc.pool.ArrayPool` launches blocks round-robin on
  a fixed wave grid (``block_intervals``);
- **where the energy goes** — :class:`~repro_torch.apc.stats.TracedStats`
  carries exact per-block integer counters (sets, resets, mismatch
  histogram), the same integers Table XI prices via
  :func:`repro_torch.core.energy.energy_from_stats`.

A :class:`PowerTimeline` is the join: a list of :class:`PowerInterval`
(array, time window, integer counters).  Because the counters are an
exact partition of the run's totals — blocks are dealt to intervals by
the same rule the scheduler used, or by a largest-remainder integer
split when block counts disagree — summing interval energy reproduces
``energy_from_stats(Tracer.total_ap_stats(radix), n_masked).total_j``
**bit-exactly**: the conversion to joules happens once, on summed
integers, never on per-interval floats.

From the exact timeline everything else is derived and explicitly
approximate: binned W-vs-t series (energy deposited by overlap
fraction), a rolling EWMA thermal-density proxy per array (window ->
``alpha = 1 - exp(-bin/window)``), and bank-level summaries (peak W,
avg W, hottest array, time over threshold).  Export to Perfetto counter
tracks via :func:`emit_counter_tracks`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterable, Mapping, NamedTuple, Sequence

import numpy as np
import torch

from ..core.ap import APStats
from ..core.energy import CellParams, EnergyReport, energy_from_stats
from .stats import HIST_BINS, TracedStats

__all__ = [
    "Counters", "PowerInterval", "PowerTimeline", "PowerAccum",
    "graph_power", "pool_power", "partition_blocks",
    "emit_counter_tracks", "DEFAULT_EWMA_WINDOW_NS",
]

DEFAULT_EWMA_WINDOW_NS = 200.0


def _host_rows(rows) -> np.ndarray:
    """Counter rows (a tensor on any device, or array-like) as int64
    numpy."""
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return np.asarray(rows, np.int64)


class Counters(NamedTuple):
    """Exact integer energy counters for one interval (Table XI inputs)."""
    sets: int
    resets: int
    hist: tuple  # mismatch histogram, HIST_BINS ints

    @staticmethod
    def zero() -> "Counters":
        return Counters(0, 0, (0,) * HIST_BINS)

    @staticmethod
    def from_rows(rows: np.ndarray) -> "Counters":
        """Fold ``(n, 2 + HIST_BINS)`` TracedStats block rows into one."""
        rows = _host_rows(rows)
        if rows.size == 0:
            return Counters.zero()
        tot = rows.sum(axis=0)
        return Counters(int(tot[0]), int(tot[1]),
                        tuple(int(v) for v in tot[2:2 + HIST_BINS]))

    def __add__(self, other: "Counters") -> "Counters":  # type: ignore[override]
        return Counters(
            self.sets + other.sets, self.resets + other.resets,
            tuple(a + b for a, b in zip(self.hist, other.hist)))

    def energy(self, radix: int, n_masked: int,
               params: CellParams | None = None) -> EnergyReport:
        """Price via Table XI.  Exact-by-construction: the integers go
        through the same :func:`energy_from_stats` as the run totals."""
        stats = APStats(radix=radix)
        stats.sets = self.sets
        stats.resets = self.resets
        h = np.asarray(self.hist, np.int64)
        nb = len(stats.mismatch_hist)
        if len(h) > nb:
            h = np.concatenate([h[:nb - 1], [h[nb - 1:].sum()]])
        stats.mismatch_hist[:len(h)] += h
        return energy_from_stats(stats, n_masked, params=params)


@dataclass(frozen=True)
class PowerInterval:
    """One scheduled busy window of one array, with its exact counters."""
    node: int                 # graph node id (or block index on pool runs)
    label: str
    array: int                # flat array index across the device mesh
    start_ns: float
    end_ns: float
    counters: Counters
    radix: int
    n_masked: int

    @property
    def duration_ns(self) -> float:
        return max(self.end_ns - self.start_ns, 0.0)

    @property
    def energy_j(self) -> float:
        return self.counters.energy(self.radix, self.n_masked).total_j

    @property
    def power_w(self) -> float:
        """Average power over the interval: Table XI joules / model ns."""
        d = self.duration_ns
        return self.energy_j / (d * 1e-9) if d > 0 else 0.0


@dataclass
class PowerTimeline:
    """Per-array power intervals on the model-time axis + derived series."""
    intervals: list
    radix: int
    n_masked: int
    n_arrays_local: int = 1   # arrays per device, for dev/arr track names

    # -- exact aggregates ---------------------------------------------------

    def total_counters(self) -> Counters:
        tot = Counters.zero()
        for iv in self.intervals:
            tot = tot + iv.counters
        return tot

    def total_energy_j(self) -> float:
        """One conversion on integer sums — bit-exact vs the run totals."""
        return self.total_counters().energy(self.radix, self.n_masked).total_j

    def arrays(self) -> list:
        return sorted({iv.array for iv in self.intervals})

    def track_name(self, array: int) -> str:
        dev, a = divmod(array, max(self.n_arrays_local, 1))
        return f"dev{dev}/arr{a}"

    def per_array(self) -> dict:
        """array -> dict of exact energy + busy time + avg/peak W."""
        out: dict = {}
        for iv in self.intervals:
            e = out.setdefault(iv.array, {
                "counters": Counters.zero(), "busy_ns": 0.0, "peak_w": 0.0})
            e["counters"] = e["counters"] + iv.counters
            e["busy_ns"] += iv.duration_ns
            e["peak_w"] = max(e["peak_w"], iv.power_w)
        for a, e in out.items():
            e["energy_j"] = e["counters"].energy(
                self.radix, self.n_masked).total_j
            e["avg_w"] = (e["energy_j"] / (e["busy_ns"] * 1e-9)
                          if e["busy_ns"] > 0 else 0.0)
            e["track"] = self.track_name(a)
        return out

    def span_ns(self) -> tuple:
        if not self.intervals:
            return (0.0, 0.0)
        return (min(iv.start_ns for iv in self.intervals),
                max(iv.end_ns for iv in self.intervals))

    # -- derived series -----------------------------------------------------

    def series(self, n_bins: int = 64) -> dict:
        """Binned per-array power: energy deposited by overlap fraction.

        Returns ``{"t_ns": (n_bins,), "bin_ns": float,
        "power_w": {array: (n_bins,)}, "total_w": (n_bins,)}``.  The sum
        of ``power_w * bin_ns * 1e-9`` over all bins equals per-array
        interval energy up to float rounding (the exact path is
        :meth:`total_energy_j`, not the binned series).
        """
        lo, hi = self.span_ns()
        n_bins = max(int(n_bins), 1)
        span = hi - lo
        if span <= 0:
            span = 1.0
        bin_ns = span / n_bins
        edges = lo + bin_ns * np.arange(n_bins + 1)
        t = edges[:-1]
        power: dict = {a: np.zeros(n_bins) for a in self.arrays()}
        for iv in self.intervals:
            d = iv.duration_ns
            if d <= 0:
                continue
            e_j = iv.energy_j
            b0 = min(max(int((iv.start_ns - lo) / bin_ns), 0), n_bins - 1)
            b1 = min(max(int(math.ceil((iv.end_ns - lo) / bin_ns)), b0 + 1),
                     n_bins)
            for b in range(b0, b1):
                ov = (min(iv.end_ns, edges[b + 1])
                      - max(iv.start_ns, edges[b]))
                if ov <= 0:
                    continue
                power[iv.array][b] += (e_j * (ov / d)) / (bin_ns * 1e-9)
        total = np.zeros(n_bins)
        for arr in power.values():
            total += arr
        return {"t_ns": t, "bin_ns": bin_ns, "power_w": power,
                "total_w": total}

    def ewma(self, window_ns: float = DEFAULT_EWMA_WINDOW_NS,
             n_bins: int = 64) -> dict:
        """Rolling EWMA of each array's binned power — a thermal-density
        proxy (hot = sustained power, not an instantaneous spike).

        ``alpha = 1 - exp(-bin_ns / window_ns)``: a ~window_ns burst
        reaches ~63% of its steady-state level.
        """
        ser = self.series(n_bins)
        alpha = 1.0 - math.exp(-ser["bin_ns"] / max(window_ns, 1e-9))
        out: dict = {}
        for a, pw in ser["power_w"].items():
            acc = np.zeros_like(pw)
            level = 0.0
            for i, v in enumerate(pw):
                level += alpha * (v - level)
                acc[i] = level
            out[a] = acc
        return {"t_ns": ser["t_ns"], "bin_ns": ser["bin_ns"],
                "thermal_w": out, "alpha": alpha}

    def summary(self, *, threshold_w: float | None = None,
                window_ns: float = DEFAULT_EWMA_WINDOW_NS,
                n_bins: int = 64) -> dict:
        """Bank-level rollup: peak/avg W, hotspot, time over threshold."""
        per = self.per_array()
        lo, hi = self.span_ns()
        span_ns = hi - lo
        energy_j = self.total_energy_j()
        peak_w = max((e["peak_w"] for e in per.values()), default=0.0)
        hottest = None
        hottest_w = 0.0
        over_ns = 0.0
        if self.intervals:
            ew = self.ewma(window_ns, n_bins)
            for a, tw in ew["thermal_w"].items():
                m = float(tw.max()) if len(tw) else 0.0
                if hottest is None or m > hottest_w:
                    hottest, hottest_w = a, m
            if threshold_w is not None:
                ser = self.series(n_bins)
                over_ns = float(
                    (ser["total_w"] > threshold_w).sum() * ser["bin_ns"])
        return {
            "n_intervals": len(self.intervals),
            "n_arrays": len(per),
            "span_ns": span_ns,
            "energy_j": energy_j,
            "avg_w": energy_j / (span_ns * 1e-9) if span_ns > 0 else 0.0,
            "peak_w": peak_w,
            "hottest_array": hottest,
            "hottest_track": (self.track_name(hottest)
                              if hottest is not None else None),
            "hottest_thermal_w": hottest_w,
            "threshold_w": threshold_w,
            "time_over_threshold_ns": over_ns,
            "per_array": {self.track_name(a): {
                "energy_j": e["energy_j"], "busy_ns": e["busy_ns"],
                "avg_w": e["avg_w"], "peak_w": e["peak_w"]}
                for a, e in sorted(per.items())},
        }


# ---------------------------------------------------------------------------
# Exact block partitioning
# ---------------------------------------------------------------------------

def partition_blocks(rows: np.ndarray, wanted: Sequence[int]) -> list:
    """Split TracedStats block rows into exact integer counter groups.

    Two modes, both exact partitions (group sums == total):

    - when ``len(rows) == sum(wanted)`` the executor's blocks align 1:1
      with the scheduler's — deal them out consecutively, matching the
      round-robin order :func:`~repro_torch.apc.graph.graph_makespan` assigned;
    - otherwise (device-mesh padding, psummed counters) fold the node
      total and split it by largest-remainder on the ``wanted`` weights,
      so every integer lands in exactly one group.
    """
    rows = _host_rows(rows)
    n = int(rows.shape[0]) if rows.ndim == 2 else 0
    want = [max(int(w), 0) for w in wanted]
    total_want = sum(want)
    if total_want == 0:
        return [Counters.zero() for _ in want]
    if n == total_want:
        out = []
        at = 0
        for w in want:
            out.append(Counters.from_rows(rows[at:at + w]))
            at += w
        return out
    tot = Counters.from_rows(rows)
    fields = [tot.sets, tot.resets, *tot.hist]
    split = [[0] * len(fields) for _ in want]
    for fi, val in enumerate(fields):
        base = [val * w // total_want for w in want]
        rem = val - sum(base)
        # distribute the remainder by largest fractional part (stable)
        fracs = sorted(range(len(want)),
                       key=lambda i: (-(val * want[i] % total_want), i))
        for i in fracs[:rem]:
            base[i] += 1
        for i, b in enumerate(base):
            split[i][fi] = b
    return [Counters(s[0], s[1], tuple(s[2:])) for s in split]


# ---------------------------------------------------------------------------
# Timeline builders
# ---------------------------------------------------------------------------

def graph_power(schedule: Iterable[Mapping], traced: Mapping,
                *, radix: int, n_masked: int,
                n_arrays_local: int = 1,
                labels: Mapping | None = None) -> PowerTimeline:
    """Join a ``graph_makespan(record=)`` schedule with per-node
    :class:`TracedStats` into an exact power timeline.

    ``schedule`` entries are the record dicts (node/array/blocks/
    start_ns/end_ns); ``traced`` maps node id -> TracedStats (or a
    ``(n, 2+HIST_BINS)`` array).  Counters for each node are split over
    its scheduled intervals by :func:`partition_blocks` — an exact
    integer partition either way, so the timeline's total energy is
    bit-identical to the run's.
    """
    labels = labels or {}
    by_node: dict = {}
    for ent in schedule:
        by_node.setdefault(int(ent["node"]), []).append(ent)
    intervals: list = []
    for nid, ents in by_node.items():
        ts = traced.get(nid)
        if ts is None:
            rows = np.zeros((0, 2 + HIST_BINS), np.int64)
        else:
            rows = ts.block_counts if isinstance(ts, TracedStats) else ts
        parts = partition_blocks(rows, [ent["blocks"] for ent in ents])
        for ent, c in zip(ents, parts):
            intervals.append(PowerInterval(
                node=nid, label=str(labels.get(nid, "")),
                array=int(ent["array"]),
                start_ns=float(ent["start_ns"]),
                end_ns=float(ent["end_ns"]),
                counters=c, radix=radix, n_masked=n_masked))
    intervals.sort(key=lambda iv: (iv.start_ns, iv.array, iv.node))
    return PowerTimeline(intervals=intervals, radix=radix,
                         n_masked=n_masked, n_arrays_local=n_arrays_local)


def pool_power(pool, compiled, traced: TracedStats, *, radix: int,
               n_masked: int, label: str = "") -> PowerTimeline:
    """Power timeline for one :meth:`ArrayPool.run` launch: block ``b``
    ran on array ``b % n_arrays`` in wave ``b // n_arrays``, one
    ``program_ns`` per wave (the pool's launch loop), and TracedStats
    rows align 1:1 with blocks."""
    rows = _host_rows(traced.block_counts)
    grid = pool.block_intervals(rows.shape[0], compiled)
    intervals = []
    for (b, array, _wave, start_ns, end_ns), row in zip(grid, rows):
        intervals.append(PowerInterval(
            node=b, label=label, array=int(array),
            start_ns=float(start_ns), end_ns=float(end_ns),
            counters=Counters.from_rows(row[None, :]),
            radix=radix, n_masked=n_masked))
    return PowerTimeline(intervals=intervals, radix=radix,
                         n_masked=n_masked, n_arrays_local=pool.n_arrays)


# ---------------------------------------------------------------------------
# Cross-run accumulation (per-request / per-engine rollup)
# ---------------------------------------------------------------------------

@dataclass
class PowerAccum:
    """Bounded accumulator over many timelines (a request runs one graph
    per AP-backed layer call — keeping every interval would grow without
    bound, so this folds to per-array integers + busy time + peak W)."""
    radix: int
    n_masked: int
    n_arrays_local: int = 1
    counters: dict = field(default_factory=dict)   # array -> Counters
    busy_ns: dict = field(default_factory=dict)    # array -> float
    peak_w: dict = field(default_factory=dict)     # array -> float
    span_ns: float = 0.0
    n_timelines: int = 0

    def add(self, tl: PowerTimeline) -> None:
        self.n_timelines += 1
        self.n_arrays_local = max(self.n_arrays_local, tl.n_arrays_local)
        lo, hi = tl.span_ns()
        self.span_ns += max(hi - lo, 0.0)
        for iv in tl.intervals:
            a = iv.array
            self.counters[a] = self.counters.get(a, Counters.zero()) \
                + iv.counters
            self.busy_ns[a] = self.busy_ns.get(a, 0.0) + iv.duration_ns
            self.peak_w[a] = max(self.peak_w.get(a, 0.0), iv.power_w)

    def total_counters(self) -> Counters:
        tot = Counters.zero()
        for c in self.counters.values():
            tot = tot + c
        return tot

    def total_energy_j(self) -> float:
        return self.total_counters().energy(self.radix, self.n_masked).total_j

    def report(self) -> dict:
        """Rollup dict of the accumulated timelines."""
        nal = max(self.n_arrays_local, 1)

        def track(a: int) -> str:
            dev, i = divmod(a, nal)
            return f"dev{dev}/arr{i}"

        per = {}
        hottest = None
        hottest_w = 0.0
        for a in sorted(self.counters):
            e_j = self.counters[a].energy(self.radix, self.n_masked).total_j
            busy = self.busy_ns.get(a, 0.0)
            avg = e_j / (busy * 1e-9) if busy > 0 else 0.0
            per[track(a)] = {"energy_j": e_j, "busy_ns": busy,
                             "avg_w": avg, "peak_w": self.peak_w.get(a, 0.0)}
            if hottest is None or avg > hottest_w:
                hottest, hottest_w = track(a), avg
        energy_j = self.total_energy_j()
        peak = max(self.peak_w.values(), default=0.0)
        return {
            "energy_j": energy_j,
            "model_span_ns": self.span_ns,
            "avg_w": (energy_j / (self.span_ns * 1e-9)
                      if self.span_ns > 0 else 0.0),
            "peak_w": peak,
            "hottest_array": hottest,
            "n_timelines": self.n_timelines,
            "per_array": per,
        }


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------

def emit_counter_tracks(tracer, tl: PowerTimeline, *, base_ns: float = 0.0,
                        n_bins: int = 64,
                        window_ns: float = DEFAULT_EWMA_WINDOW_NS) -> int:
    """Render a timeline as Perfetto counter tracks on the model (pid 1)
    timeline: one ``power devD/arrA`` track per array (power_w +
    thermal_w series) plus a ``power bank`` total track.  Emits a
    trailing zero sample so the area chart closes.  Returns the number
    of samples emitted."""
    if not tl.intervals:
        return 0
    ser = tl.series(n_bins)
    ew = tl.ewma(window_ns, n_bins)
    n = 0
    for a in tl.arrays():
        track = f"power {tl.track_name(a)}"
        pw = ser["power_w"][a]
        tw = ew["thermal_w"][a]
        for i, t in enumerate(ser["t_ns"]):
            tracer.counter("ap.power", track=track,
                           ts_ns=base_ns + t,
                           power_w=float(pw[i]), thermal_w=float(tw[i]))
            n += 1
        end = base_ns + ser["t_ns"][-1] + ser["bin_ns"]
        tracer.counter("ap.power", track=track, ts_ns=end,
                       power_w=0.0, thermal_w=0.0)
        n += 1
    for i, t in enumerate(ser["t_ns"]):
        tracer.counter("ap.power.bank", track="power bank",
                       ts_ns=base_ns + t,
                       total_w=float(ser["total_w"][i]))
        n += 1
    tracer.counter("ap.power.bank", track="power bank",
                   ts_ns=base_ns + ser["t_ns"][-1] + ser["bin_ns"],
                   total_w=0.0)
    return n + 1
