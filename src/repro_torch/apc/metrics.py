"""Process-global metrics for the AP stack: counters, gauges, histograms.

Stdlib-only companion to :mod:`repro_torch.apc.trace`.  Where the tracer answers
"what happened inside *this* request, in order", the registry answers
"what has this process done so far": compile-cache hit rates, schedule
uploads, pool launches, request/decode-step latency quantiles — the
aggregates the ROADMAP's continuous-batching (p50/p99) and autotuner
(per-launch timing) items consume.

Instruments are cheap enough to record unconditionally (a lock + a few
scalar updates), so unlike spans they are **not** gated by the tracer —
instrumentation sites bump them at coarse granularity (per compile, per
upload, per pool run, per ``APLinear`` build, per request).

:class:`Histogram` keeps a bounded sample window (reservoir of the most
recent ``max_samples`` observations) plus exact count/sum/min/max;
:meth:`Histogram.quantile` matches ``numpy.percentile``'s default linear
interpolation over the retained window, which the tests pin.

Use :func:`get_registry` for the process-global registry; construct a
private :class:`MetricsRegistry` for isolation (tests, side-by-side
comparisons).
"""
from __future__ import annotations

import math
import re
import threading
from typing import Iterable

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "get_registry", "REGISTRY"]

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Sanitize a dotted metric name into a legal Prometheus name
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``)."""
    out = _PROM_BAD.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _prom_num(v: float) -> str:
    """Prometheus sample value rendering (NaN/Inf spellings included)."""
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


class Counter:
    """Monotonic integer counter (``inc``-only)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self):
        return self._value


class Gauge:
    """Last-write-wins scalar (pool occupancy, cache currsize, ...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value


class Histogram:
    """Bounded-memory distribution with numpy-compatible quantiles.

    Keeps exact ``count``/``sum``/``min``/``max`` over *all* observations
    and a sliding window of the most recent ``max_samples`` values for
    quantile estimates.  :meth:`quantile` implements the same linear
    interpolation as ``numpy.percentile(..., method="linear")`` over the
    window, so p50/p90/p99 agree with numpy exactly while the window
    covers everything observed.
    """

    __slots__ = ("name", "max_samples", "count", "total", "min", "max",
                 "_window", "_next", "_lock")

    def __init__(self, name: str, max_samples: int = 4096):
        if max_samples < 1:
            raise ValueError("max_samples must be >= 1")
        self.name = name
        self.max_samples = max_samples
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._window: list[float] = []       # ring buffer of recent samples
        self._next = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._window) < self.max_samples:
                self._window.append(v)
            else:
                self._window[self._next] = v
                self._next = (self._next + 1) % self.max_samples

    def observe_many(self, vs: Iterable[float]) -> None:
        for v in vs:
            self.observe(v)

    @staticmethod
    def _interp(data: list[float], q: float) -> float:
        """Linear interpolation between closest ranks over sorted ``data``
        (== ``numpy.percentile(data, 100*q)``); NaN on empty."""
        n = len(data)
        if n == 0:
            return float("nan")
        if n == 1:
            return data[0]
        pos = q * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        return data[lo] * (1.0 - frac) + data[hi] * frac

    def quantile(self, q: float) -> float:
        """q in [0, 1]; linear interpolation over the retained window; NaN
        when nothing was observed."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            data = sorted(self._window)
        return self._interp(data, q)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def snapshot(self) -> dict:
        # copy every field under ONE lock acquisition so the snapshot is
        # internally consistent under concurrent observe() (count/sum/
        # min/max/quantiles all describe the same instant); quantiles are
        # then computed lock-free on the copied window
        with self._lock:
            n = self.count
            total = self.total
            mn, mx = self.min, self.max
            data = sorted(self._window)
        if n == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None,
                    "mean": None, "p50": None, "p90": None, "p99": None}
        return {"count": n, "sum": total, "min": mn, "max": mx,
                "mean": total / n,
                "p50": self._interp(data, 0.50),
                "p90": self._interp(data, 0.90),
                "p99": self._interp(data, 0.99)}


class MetricsRegistry:
    """Named instrument registry (get-or-create, type-checked).

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` return the
    existing instrument or create it; re-requesting a name with a
    different instrument type raises.  :meth:`snapshot` renders everything
    as plain JSON-able dicts (histograms with p50/p90/p99); ``reset()``
    drops all instruments (tests, per-run isolation).
    """

    def __init__(self):
        self._instruments: dict[str, Counter | Gauge | Histogram] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, max_samples: int = 4096) -> Histogram:
        return self._get(name, Histogram, max_samples)

    def counter_values(self, names) -> dict[str, int]:
        """Current values of the named counters, creating any that do not
        exist yet — so delta-baseline sampling (e.g. the serve monitor's
        fault counters) is race-free against later increments."""
        return {n: self.counter(n).value for n in names}

    def snapshot(self) -> dict:
        with self._lock:
            items = sorted(self._instruments.items())
        return {name: inst.snapshot() for name, inst in items}

    def to_prometheus(self) -> str:
        """Render every instrument in the Prometheus text exposition
        format (version 0.0.4): counters as ``<name>_total``, gauges
        plain, histograms as summaries (p50/p90/p99 ``quantile`` labels
        plus ``_sum``/``_count``).  A scrape endpoint or a file tail of
        :meth:`write_prometheus` shows the serving system's health
        without a debugger."""
        with self._lock:
            items = sorted(self._instruments.items())
        lines: list[str] = []
        for name, inst in items:
            pname = _prom_name(name)
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {pname}_total counter")
                lines.append(f"{pname}_total {inst.snapshot()}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_num(inst.snapshot())}")
            else:
                snap = inst.snapshot()
                lines.append(f"# TYPE {pname} summary")
                if snap["count"]:
                    for q, key in ((0.5, "p50"), (0.9, "p90"),
                                   (0.99, "p99")):
                        lines.append(
                            f'{pname}{{quantile="{q}"}} '
                            f'{_prom_num(snap[key])}')
                lines.append(f"{pname}_sum {_prom_num(snap['sum'])}")
                lines.append(f"{pname}_count {snap['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str) -> str:
        """Dump :meth:`to_prometheus` to ``path``; returns the path."""
        text = self.to_prometheus()
        with open(path, "w") as f:
            f.write(text)
        return path

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-global registry the instrumentation sites use."""
    return REGISTRY
