"""Serving: the step-granular engine, continuous batching of AP waves, the
SLO monitor and the submission queue (the port of :mod:`repro.serve`)."""
from .batcher import (AdmissionCfg, AdmissionRejected,  # noqa: F401
                      BatchServer, RequestHandle, WaveAborted,
                      WaveDiverged, WaveMerger, wave_cost_cycles)
from .engine import Engine, Request, ServeCfg  # noqa: F401
from .monitor import ServeMonitor, SLOCfg  # noqa: F401
from .queue import ClosedQueue, IterableQueue  # noqa: F401
