"""Structured tracing for the AP stack: nested spans, instants, Perfetto.

Zero required dependencies (stdlib only) and strictly pay-for-what-you-use:
every instrumentation site goes through the module-level front doors
(:func:`span` / :func:`instant` / :func:`attribute`), which cost one
global read when no tracer is installed and return a shared no-op object,
so an untraced run's trajectory is untouched (``tests/test_torch_runtime.
py`` pins bit-identical digits and APStats either way).

Two clocks, one timeline:

- **Host time** — ``time.perf_counter_ns()`` spans measure what the host
  orchestrator actually does (compile, encode, dispatch, drain).  Because
  CUDA launches are asynchronous, a host span is dispatch+drain time, not
  device busy time.  A tracer takes the offset between that clock and
  ``time.time_ns()`` once, when it starts: :meth:`Tracer.epoch_ns` gives
  any record's interval on the epoch clock that ``torch.profiler``'s
  device events (``start_ns()``) use, so host spans line up with kernels.
- **Model time** — the occupancy model's cycle schedule rendered at Table
  XI timings (:func:`Tracer.model_span`): one track per ``devD/arrA`` of
  the bank, emitted by :class:`~repro_torch.apc.runtime.Runtime` from
  :func:`~repro_torch.apc.graph.graph_makespan` so a serving request shows
  *where the modeled cycles go*, aligned under the host span that
  scheduled them.

Attribution events (:meth:`Tracer.attribute`, emitted by
:func:`repro_torch.apc.stats.accumulate` for every program execution) carry the
exact integer counters merged into the caller's
:class:`~repro_torch.core.ap.APStats` — sets/resets, compare/write cycles, and
the mismatch histogram — tagged with the *phase* (category of the
innermost open span of the emitting thread: compile / pool / runtime /
serve / ...).  Summing them (:meth:`Tracer.total_ap_stats`) therefore
reproduces the aggregated APStats **bit-exactly**, which is what makes
per-phase cycle/energy breakdowns trustworthy: they are a partition of the
real totals, not a second estimate.

Threads: :func:`tracing` installs one tracer for the whole process, so
every thread records into it (a serving process's dispatcher and the
workers of a merged AP wave included).  Each thread keeps its own span
stack, so spans nest per thread and a span's ``parent`` is its own
thread's; every record carries its thread's name.  Records are appended to
shared lists (an append is atomic under the GIL): no lock per span.
:func:`disabled` masks the tracer in the calling context only (the parity
tests use it).

Export is Chrome ``trace_event`` JSON (:meth:`Tracer.to_chrome` /
:meth:`Tracer.write`): open the file in Perfetto (https://ui.perfetto.dev)
or ``chrome://tracing``.  Host spans live under pid 0, one track per
(track, thread), model-time tracks under pid 1; nesting in the viewer is
by time containment per track.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Iterator

__all__ = [
    "Tracer", "SpanRecord", "InstantRecord", "AttributionRecord",
    "CounterRecord", "tracing", "disabled", "current_tracer",
    "span", "instant", "attribute", "traced_compile",
    "validate_chrome_trace",
]

HOST_PID = 0              # host-orchestration timeline
MODEL_PID = 1             # model-time (Table XI cycle schedule) timeline


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

@dataclass
class SpanRecord:
    """One closed span: host (``pid=HOST_PID``) or model-time duration."""
    name: str
    cat: str
    ts_ns: int                       # relative to the tracer's origin
    dur_ns: int
    track: str = "host"
    pid: int = HOST_PID
    args: dict = field(default_factory=dict)
    parent: str | None = None        # enclosing span's name (host spans)
    thread: str = ""                 # name of the recording thread


@dataclass
class InstantRecord:
    """A point event (cache hit, schedule upload, block launch, ...)."""
    name: str
    cat: str
    ts_ns: int
    track: str = "host"
    pid: int = HOST_PID
    args: dict = field(default_factory=dict)
    thread: str = ""


@dataclass
class CounterRecord:
    """One sample of a counter track ("C" phase event).

    A counter track renders as a stacked area chart in Perfetto — the
    power/thermal timelines use one track per ``devD/arrA`` of the bank
    plus a bank-total track, sampled on the model-time (pid 1) axis.
    ``values`` maps series name -> numeric sample; every sample of one
    track should carry the same series keys.
    """
    name: str
    cat: str
    ts_ns: int
    track: str
    pid: int
    values: dict
    thread: str = ""


@dataclass
class AttributionRecord:
    """Exact per-program counters, as merged into the caller's APStats.

    ``phase`` is the category of the innermost host span open at emission
    time — the partition key of the cycle/energy-by-phase breakdown.
    """
    phase: str
    label: str
    sets: int
    resets: int
    compare_cycles: int
    write_cycles: int
    n_rows: int
    mismatch_hist: tuple[int, ...]
    ts_ns: int
    thread: str = ""


class _OpenSpan:
    """A span in flight; mutable ``args`` so callers can annotate before
    close (e.g. cache hit/miss resolved only after the cached call)."""

    __slots__ = ("tracer", "name", "cat", "track", "ts_ns", "args", "keep")

    def __init__(self, tracer: "Tracer", name: str, cat: str, track: str,
                 ts_ns: int, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.ts_ns = ts_ns
        self.args = args
        self.keep = True

    def set(self, **kw) -> "_OpenSpan":
        self.args.update(kw)
        return self

    def drop(self) -> None:
        """Close without a record (it still nests while open)."""
        self.keep = False

    def __enter__(self) -> "_OpenSpan":
        self.tracer._thread_state()[0].append(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.tracer._close(self)
        return False


class _NullSpan:
    """Shared no-op span: what the front doors return with tracing off."""

    __slots__ = ()

    def set(self, **kw) -> "_NullSpan":
        return self

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

class Tracer:
    """Collects spans, instants, and attribution events for one scope.

    Any number of threads may record at once: each keeps its own span
    stack (``parent`` and the attribution phase come from the calling
    thread's spans), and records go to shared lists by GIL-atomic appends.

    Public API:

    - :meth:`span` — context manager; nested spans stack per thread
      (``parent`` is the enclosing span, phase for attribution is the
      innermost ``cat``).
    - :meth:`instant` — point event.
    - :meth:`model_span` — explicit-timestamp span on the model-time
      timeline (``pid=1``), one track per device/array.
    - :meth:`attribute` — exact APStats-delta counters; see
      :meth:`total_ap_stats` / :meth:`phase_totals`.
    - :meth:`epoch_ns` — a record's interval on ``time.time_ns()``'s
      clock (``torch.profiler``'s).
    - :meth:`to_chrome` / :meth:`write` — Chrome/Perfetto ``trace_event``
      JSON export.
    """

    def __init__(self, meta: dict | None = None, clock=time.perf_counter_ns):
        self.meta = dict(meta or {})
        self.events: list[SpanRecord | InstantRecord | CounterRecord] = []
        self.attributions: list[AttributionRecord] = []
        self._local = threading.local()
        self._clock = clock
        t0 = clock()
        wall = time.time_ns()
        t1 = clock()
        self._t0 = t0
        # time.time_ns() at the origin (the wall reading taken halfway
        # between the two clock readings): record time + this = epoch ns
        self.origin_epoch_ns = wall - (t1 - t0) // 2

    # -- recording ----------------------------------------------------------

    def _thread_state(self) -> tuple[list[_OpenSpan], str]:
        """The calling thread's (span stack, thread name)."""
        try:
            return self._local.state
        except AttributeError:
            state = self._local.state = ([], threading.current_thread().name)
            return state

    def now_ns(self) -> int:
        return self._clock() - self._t0

    def epoch_ns(self, rec) -> tuple[int, int]:
        """``(start, end)`` of a record in ``time.time_ns()`` nanoseconds,
        the clock of ``torch.profiler``'s device events; an instant's end
        is its start.  (A model-time span is placed under its host span,
        so its interval is the model's, shifted onto this clock.)"""
        start = self.origin_epoch_ns + rec.ts_ns
        return start, start + getattr(rec, "dur_ns", 0)

    def span(self, name: str, cat: str = "host", track: str = "host",
             **args) -> _OpenSpan:
        return _OpenSpan(self, name, cat, track, self.now_ns(), args)

    def _close(self, sp: _OpenSpan) -> None:
        stack, thread = self._thread_state()
        top = stack[-1] if stack else None
        if top is not sp:
            raise RuntimeError(
                f"span {sp.name!r} closed while "
                f"{top.name if top else None!r} is innermost "
                f"— spans must strictly nest")
        stack.pop()
        if not sp.keep:
            return
        self.events.append(SpanRecord(
            name=sp.name, cat=sp.cat, ts_ns=sp.ts_ns,
            dur_ns=self.now_ns() - sp.ts_ns, track=sp.track,
            args=sp.args, parent=stack[-1].name if stack else None,
            thread=thread))

    def instant(self, name: str, cat: str | None = None,
                track: str = "host", **args) -> None:
        self.events.append(InstantRecord(
            name=name, cat=cat if cat is not None else self.current_phase(),
            ts_ns=self.now_ns(), track=track, args=args,
            thread=self._thread_state()[1]))

    def model_span(self, name: str, *, track: str, start_ns: float,
                   dur_ns: float, cat: str = "model", **args) -> None:
        """A span on the model-time timeline (``pid=1``): timestamps are
        the occupancy model's Table-XI-ns schedule, offset by the caller
        so the model timeline sits under the host span that produced it."""
        self.events.append(SpanRecord(
            name=name, cat=cat, ts_ns=int(start_ns),
            dur_ns=max(1, int(dur_ns)), track=track, pid=MODEL_PID,
            args=args, thread=self._thread_state()[1]))

    def counter(self, name: str, *, track: str, ts_ns: float,
                pid: int = MODEL_PID, cat: str = "power",
                **values: float) -> None:
        """Sample a counter track ("C" phase event) at ``ts_ns``.

        Defaults to the model-time timeline (``pid=1``) because the
        power/thermal series are computed from the occupancy model's
        schedule, not wall clock.  All values must be numeric; Perfetto
        renders each track as a stacked area chart.
        """
        if not values:
            raise ValueError(f"counter {name!r} needs at least one value")
        clean = {}
        for k, v in values.items():
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                raise TypeError(
                    f"counter {name!r} value {k}={v!r} is not numeric")
            clean[k] = float(v)
        self.events.append(CounterRecord(
            name=name, cat=cat, ts_ns=max(0, int(ts_ns)), track=track,
            pid=pid, values=clean, thread=self._thread_state()[1]))

    def current_phase(self) -> str:
        """Category of the calling thread's innermost open span
        (``"untracked"`` outside)."""
        stack = self._thread_state()[0]
        return stack[-1].cat if stack else "untracked"

    def attribute(self, *, sets: int, resets: int, compare_cycles: int,
                  write_cycles: int, n_rows: int,
                  mismatch_hist: tuple[int, ...], label: str = "") -> None:
        """Record one program's exact APStats delta under the current
        phase, and fold it into the innermost open span's ``ap`` args so
        the timeline shows cycles where they were charged."""
        stack, thread = self._thread_state()
        rec = AttributionRecord(
            phase=stack[-1].cat if stack else "untracked", label=label,
            sets=int(sets), resets=int(resets),
            compare_cycles=int(compare_cycles),
            write_cycles=int(write_cycles), n_rows=int(n_rows),
            mismatch_hist=tuple(int(h) for h in mismatch_hist),
            ts_ns=self.now_ns(), thread=thread)
        self.attributions.append(rec)
        if stack:
            agg = stack[-1].args.setdefault(
                "ap", {"programs": 0, "sets": 0, "resets": 0,
                       "compare_cycles": 0, "write_cycles": 0})
            agg["programs"] += 1
            agg["sets"] += rec.sets
            agg["resets"] += rec.resets
            agg["compare_cycles"] += rec.compare_cycles
            agg["write_cycles"] += rec.write_cycles

    # -- aggregation --------------------------------------------------------

    def attribution_mark(self) -> int:
        """Bookmark for per-request slicing of the attribution stream."""
        return len(self.attributions)

    def phase_totals(self, start: int = 0) -> dict[str, dict]:
        """Per-phase integer totals of the attribution events from
        ``start`` — a partition of the aggregated APStats counters."""
        out: dict[str, dict] = {}
        for rec in self.attributions[start:]:
            t = out.setdefault(rec.phase, {
                "programs": 0, "sets": 0, "resets": 0, "compare_cycles": 0,
                "write_cycles": 0, "mismatch_hist": None})
            t["programs"] += 1
            t["sets"] += rec.sets
            t["resets"] += rec.resets
            t["compare_cycles"] += rec.compare_cycles
            t["write_cycles"] += rec.write_cycles
            h = list(rec.mismatch_hist)
            if t["mismatch_hist"] is None:
                t["mismatch_hist"] = h
            else:
                prev = t["mismatch_hist"]
                n = max(len(prev), len(h))
                t["mismatch_hist"] = [
                    (prev[i] if i < len(prev) else 0)
                    + (h[i] if i < len(h) else 0) for i in range(n)]
        return out

    def total_ap_stats(self, radix: int, start: int = 0):
        """Sum every attribution event into a fresh
        :class:`~repro_torch.core.ap.APStats` — bit-identical to the stats the
        traced run aggregated, because each event carries the exact
        integers :func:`repro_torch.apc.stats.accumulate` merged."""
        import numpy as np
        from ..core.ap import APStats
        stats = APStats(radix=radix)
        for rec in self.attributions[start:]:
            stats.sets += rec.sets
            stats.resets += rec.resets
            stats.n_compare_cycles += rec.compare_cycles
            stats.n_write_cycles += rec.write_cycles
            stats.n_rows = max(stats.n_rows, rec.n_rows)
            h = np.asarray(rec.mismatch_hist, np.int64)
            nb = len(stats.mismatch_hist)
            if len(h) > nb:
                h = np.concatenate([h[:nb - 1], [h[nb - 1:].sum()]])
            stats.mismatch_hist[:len(h)] += h
        return stats

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON object (Perfetto-loadable).

        Host spans under pid 0, one tid per (track, recording thread);
        model-time tracks under pid 1, one tid per track name; tids in
        first-seen order, with ``thread_name`` metadata so the viewer
        labels every track.  ``otherData`` holds ``origin_epoch_ns``, the
        ``time.time_ns()`` reading of ``ts`` 0.
        """
        tids: dict[tuple[int, str], int] = {}

        def tid(pid: int, track: str, thread: str = "") -> int:
            key = (pid, f"{track} ({thread})" if pid == HOST_PID and thread
                   else track)
            if key not in tids:
                tids[key] = len(tids)
            return tids[key]

        trace_events: list[dict] = []
        for ev in self.events:
            base = {"name": ev.name, "cat": ev.cat, "pid": ev.pid,
                    "tid": tid(ev.pid, ev.track, ev.thread),
                    "ts": ev.ts_ns / 1000.0,
                    "args": ev.values if isinstance(ev, CounterRecord)
                            else ev.args}
            if isinstance(ev, SpanRecord):
                base["ph"] = "X"
                base["dur"] = ev.dur_ns / 1000.0
                if ev.parent is not None:
                    base["args"] = dict(ev.args, parent=ev.parent)
            elif isinstance(ev, CounterRecord):
                base["ph"] = "C"
                base["args"] = ev.values
            else:
                base["ph"] = "i"
                base["s"] = "t"
            trace_events.append(base)
        for rec in self.attributions:
            trace_events.append({
                "name": f"ap.program:{rec.label}" if rec.label
                        else "ap.program",
                "cat": rec.phase, "ph": "i", "s": "t", "pid": HOST_PID,
                "tid": tid(HOST_PID, "host", rec.thread),
                "ts": rec.ts_ns / 1000.0,
                "args": {"sets": rec.sets, "resets": rec.resets,
                         "compare_cycles": rec.compare_cycles,
                         "write_cycles": rec.write_cycles,
                         "n_rows": rec.n_rows}})
        meta_events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": HOST_PID,
             "args": {"name": "host orchestration"}},
            {"name": "process_name", "ph": "M", "pid": MODEL_PID,
             "args": {"name": "AP model time (Table XI)"}},
        ]
        for (pid, track), t in sorted(tids.items(), key=lambda kv: kv[1]):
            meta_events.append({"name": "thread_name", "ph": "M",
                                "pid": pid, "tid": t,
                                "args": {"name": track}})
        return {"traceEvents": meta_events + trace_events,
                "displayTimeUnit": "ms",
                "otherData": dict(self.meta, clock="perf_counter_ns",
                                  origin_ns=self._t0,
                                  origin_epoch_ns=self.origin_epoch_ns)}

    def write(self, path: str) -> str:
        """Serialize :meth:`to_chrome` to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def validate_chrome_trace(doc: dict) -> list[dict]:
    """Schema check for an exported trace (shared by tests and the CI
    smoke run of ``benchmarks/trace_report.py``).  Returns the non-meta
    events; raises ``ValueError`` on the first violation."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace must be an object with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    out = []
    for ev in events:
        for k in ("name", "ph", "pid"):
            if k not in ev:
                raise ValueError(f"event missing {k!r}: {ev!r}")
        ph = ev["ph"]
        if ph == "M":
            continue
        if ph not in ("X", "i", "C"):
            raise ValueError(f"unexpected phase {ph!r}: {ev!r}")
        if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event needs ts >= 0: {ev!r}")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            raise ValueError(f"complete event needs dur >= 0: {ev!r}")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                raise ValueError(
                    f"counter event needs a non-empty args dict: {ev!r}")
            for k, v in args.items():
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    raise ValueError(
                        f"counter series {k!r} must be numeric: {ev!r}")
        out.append(ev)
    if not out:
        raise ValueError("trace contains only metadata events")
    return out


# ---------------------------------------------------------------------------
# Scoping: one installed tracer for the process, masked per context
# ---------------------------------------------------------------------------

_INSTALLED: Tracer | None = None
_MASKED: ContextVar[bool] = ContextVar("repro_ap_trace_masked",
                                       default=False)


def current_tracer() -> Tracer | None:
    """The installed tracer, or None when there is none or this context
    is inside :func:`disabled` (no-op instrumentation)."""
    tr = _INSTALLED
    if tr is None or _MASKED.get():
        return None
    return tr


@contextmanager
def tracing(tracer: Tracer | None = None) -> Iterator[Tracer]:
    """Install ``tracer`` (or a fresh one) for every thread of the process
    until the block ends (the one installed before comes back then), and
    lift a :func:`disabled` mask in this context.  Install from one thread
    at a time."""
    global _INSTALLED
    tracer = tracer if tracer is not None else Tracer()
    prev, _INSTALLED = _INSTALLED, tracer
    token = _MASKED.set(False)
    try:
        yield tracer
    finally:
        _MASKED.reset(token)
        _INSTALLED = prev


@contextmanager
def disabled() -> Iterator[None]:
    """Mask the installed tracer in this context (its thread, or the
    contexts copied from it); other threads keep recording."""
    token = _MASKED.set(True)
    try:
        yield
    finally:
        _MASKED.reset(token)


# ---------------------------------------------------------------------------
# Module-level front doors (the zero-overhead-when-off entry points)
# ---------------------------------------------------------------------------

def span(name: str, cat: str = "host", track: str = "host", **args):
    """Open a span on the installed tracer, or a shared no-op when off."""
    tr = _INSTALLED
    if tr is None or _MASKED.get():
        return _NULL_SPAN
    return tr.span(name, cat=cat, track=track, **args)


def instant(name: str, cat: str | None = None, **args) -> None:
    tr = current_tracer()
    if tr is not None:
        tr.instant(name, cat=cat, **args)


def fault(name: str, **args) -> None:
    """Fault-path instant (cat="fault"): injection detections, retries,
    and array retirements on the host timeline — one marker per event so
    a Perfetto trace of a degraded run shows exactly where and when the
    bank lost arrays."""
    tr = current_tracer()
    if tr is not None:
        tr.instant(name, cat="fault", **args)


def attribute(**counters) -> None:
    """Attribution front door (see :meth:`Tracer.attribute`)."""
    tr = current_tracer()
    if tr is not None:
        tr.attribute(**counters)


def traced_compile(cache_name: str, cached_fn, *args, _label: str = "",
                   **kw):
    """Call an ``lru_cache``-d compile entry with hit/miss accounting.

    Always bumps the :mod:`repro_torch.apc.metrics` counters
    ``compile.<cache>.hits`` / ``.misses`` (derived from the cache's own
    ``cache_info`` delta, so they agree with
    :func:`repro_torch.apc.caches.cache_stats` exactly); with a tracer active,
    a miss additionally gets a ``compile``-phase span (hits cost an
    instant — the compile work they skipped is the point).
    """
    from .metrics import get_registry
    misses0 = cached_fn.cache_info().misses
    tr = current_tracer()
    name = f"compile:{_label or cache_name}"
    if tr is None:
        out = cached_fn(*args, **kw)
        missed = cached_fn.cache_info().misses > misses0
    else:
        with tr.span(name, cat="compile") as sp:
            out = cached_fn(*args, **kw)
            missed = cached_fn.cache_info().misses > misses0
            sp.set(cache="miss" if missed else "hit")
            if not missed:
                # a hit skipped the compile work — an instant in place of
                # the ns-scale span, so cache replays don't clutter the
                # timeline
                sp.drop()
        if not missed:
            tr.instant(f"compile_hit:{_label or cache_name}", cat="compile",
                       cache=cache_name)
    get_registry().counter(
        f"compile.{cache_name}.{'misses' if missed else 'hits'}").inc()
    return out
