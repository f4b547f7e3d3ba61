"""Live serve monitor: SLO tracking + Prometheus exposition.

A copy of :mod:`repro.serve.monitor` on the port's
:mod:`repro_torch.apc.metrics`.

The batching server and engine already emit raw gauges/counters/histograms
into the process :class:`~repro_torch.apc.metrics.MetricsRegistry`; this module
adds the *judgment* layer — declared SLOs (:class:`SLOCfg`) checked on
every wave and every retired request, with breach counters and a one-call
health summary (:meth:`ServeMonitor.status`) — plus the Prometheus text
rendering (:meth:`ServeMonitor.to_prometheus`, delegating to the
registry) so a scrape endpoint or a file tail shows the serving system's
health without a debugger.

Power SLOs close the loop with :mod:`repro_torch.apc.power`: the batcher feeds
each wave's bank peak power (Table XI energy over the merged schedule)
and each request's per-array peak into the same breach machinery as
latency — the measurement substrate the ROADMAP's energy-aware scheduler
will optimize against.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

from ..apc.metrics import MetricsRegistry, get_registry

__all__ = ["SLOCfg", "ServeMonitor"]


@dataclass
class SLOCfg:
    """Service-level objectives; ``None`` disables a given check.

    - ``request_ms`` — per-request latency bound (checked at retire).
    - ``p99_ms`` — rolling p99 bound over the ``serve.request_ms``
      histogram window (checked at retire; breaches count transitions
      into violation, not every request while violated).
    - ``wave_ms`` — per-wave host wall-clock bound.
    - ``peak_power_w`` — bank peak power bound, checked per wave (merged
      schedule) and per request (per-array peak) — setting it also makes
      the batcher compute merged-wave power timelines.
    """
    request_ms: float | None = None
    p99_ms: float | None = None
    wave_ms: float | None = None
    peak_power_w: float | None = None

    def active(self) -> bool:
        return any(v is not None for v in (
            self.request_ms, self.p99_ms, self.wave_ms, self.peak_power_w))


class ServeMonitor:
    """Per-server SLO bookkeeping over the shared metrics registry.

    One monitor per :class:`~repro_torch.serve.batcher.BatchServer` (or
    :class:`~repro_torch.serve.engine.Engine`); observations are cheap (a few
    comparisons + registry bumps) and run on the dispatcher thread.

    Fault-tolerance observability: :meth:`status` reports the fault /
    retry / retirement counters as deltas since this monitor was
    constructed (the registry is process-global, so a baseline makes each
    server's view its own) and derives a three-level ``state`` —
    ``healthy`` / ``degraded`` (faults were absorbed, or arrays retired,
    while every SLO held) / ``unhealthy`` (SLO breaches).
    """

    # registry counters that describe fault handling, short-named for the
    # status() faults sub-dict
    FAULT_COUNTERS = {
        "faults.detected": "detected",
        "faults.retries": "retries",
        "faults.node_retries": "node_retries",
        "faults.retired": "retired",
        "serve.wave_aborts": "wave_aborts",
        "serve.solo_reruns": "solo_reruns",
        "serve.poisoned": "poisoned",
        "serve.stranded": "stranded",
    }

    def __init__(self, slo: SLOCfg | None = None,
                 registry: MetricsRegistry | None = None):
        self.slo = slo or SLOCfg()
        self.registry = registry if registry is not None else get_registry()
        self._fault_base = self.registry.counter_values(self.FAULT_COUNTERS)
        self.started_at = time.time()
        self.n_waves = 0
        self.n_requests = 0
        self.latency_breaches = 0
        self.p99_breaches = 0
        self.wave_breaches = 0
        self.power_breaches = 0
        self._p99_violated = False     # edge-triggered p99 breach counting

    # -- observations --------------------------------------------------------

    def observe_wave(self, wave_ms: float, *, inflight: int, queued: int,
                     bank_peak_w: float | None = None) -> None:
        """One lockstep wave completed: check wave-latency and wave-power
        SLOs and refresh the live gauges."""
        reg = self.registry
        self.n_waves += 1
        reg.gauge("serve.monitor.inflight").set(inflight)
        reg.gauge("serve.monitor.queued").set(queued)
        if bank_peak_w is not None:
            reg.gauge("serve.bank_peak_power_w").set(bank_peak_w)
            if self.slo.peak_power_w is not None \
                    and bank_peak_w > self.slo.peak_power_w:
                self.power_breaches += 1
                reg.counter("serve.slo.power_breaches").inc()
        if self.slo.wave_ms is not None and wave_ms > self.slo.wave_ms:
            self.wave_breaches += 1
            reg.counter("serve.slo.wave_breaches").inc()

    def observe_request(self, latency_ms: float,
                        power_peak_w: float | None = None) -> None:
        """One request retired: check request-latency, rolling-p99, and
        request-power SLOs."""
        reg = self.registry
        self.n_requests += 1
        if self.slo.request_ms is not None \
                and latency_ms > self.slo.request_ms:
            self.latency_breaches += 1
            reg.counter("serve.slo.latency_breaches").inc()
        if power_peak_w is not None and self.slo.peak_power_w is not None \
                and power_peak_w > self.slo.peak_power_w:
            self.power_breaches += 1
            reg.counter("serve.slo.power_breaches").inc()
        if self.slo.p99_ms is not None:
            p99 = reg.histogram("serve.request_ms").quantile(0.99)
            violated = p99 == p99 and p99 > self.slo.p99_ms  # NaN-safe
            if violated and not self._p99_violated:
                self.p99_breaches += 1
                reg.counter("serve.slo.p99_breaches").inc()
            self._p99_violated = violated

    # -- rendering -----------------------------------------------------------

    def status(self) -> dict:
        """One-call health summary: SLO config, breach totals, and the
        current latency/power snapshot."""
        req = self.registry.histogram("serve.request_ms").snapshot()
        wave = self.registry.histogram("serve.wave_ms").snapshot()
        faults = self.fault_status()
        healthy = not (self.latency_breaches or self.p99_breaches
                       or self.wave_breaches or self.power_breaches)
        degraded = bool(faults["retired_arrays"] or faults["detected"]
                        or faults["poisoned"] or faults["stranded"])
        state = "unhealthy" if not healthy else (
            "degraded" if degraded else "healthy")
        return {
            "uptime_s": time.time() - self.started_at,
            "n_waves": self.n_waves,
            "n_requests": self.n_requests,
            "slo": {
                "request_ms": self.slo.request_ms,
                "p99_ms": self.slo.p99_ms,
                "wave_ms": self.slo.wave_ms,
                "peak_power_w": self.slo.peak_power_w,
            },
            "breaches": {
                "latency": self.latency_breaches,
                "p99": self.p99_breaches,
                "wave": self.wave_breaches,
                "power": self.power_breaches,
            },
            "healthy": not (self.latency_breaches or self.p99_breaches
                            or self.wave_breaches or self.power_breaches),
            "faults": faults,
            "degraded": degraded,
            "state": state,
            "request_ms": req,
            "wave_ms": wave,
            "bank_peak_power_w":
                self.registry.gauge("serve.bank_peak_power_w").value,
        }

    def fault_status(self) -> dict:
        """Fault/retry/retirement counter deltas since this monitor's
        construction, plus the current retired-array count (gauge,
        absolute)."""
        cur = self.registry.counter_values(self.FAULT_COUNTERS)
        out = {short: cur[name] - self._fault_base[name]
               for name, short in self.FAULT_COUNTERS.items()}
        out["retired_arrays"] = int(
            self.registry.gauge("faults.retired_arrays").value)
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition of the whole registry (the monitor's
        own counters/gauges live there too)."""
        return self.registry.to_prometheus()

    def dump(self, path: str) -> str:
        """On-demand snapshot dump (a scrape without a scraper)."""
        return self.registry.write_prometheus(path)
