"""The port's copies of the tracer and the metrics registry against the
reference: the same traced run attributes the same counters, and the
registry's quantiles and exposition agree on the same samples."""
import jax.numpy as jnp
import numpy as np

from repro import apc as ref_apc
from repro.apc import metrics as ref_metrics
from repro.core import ap as ref_ap

from repro_torch import apc
from repro_torch.apc import metrics, trace
from repro_torch.core import ap


def _fields(s):
    return (s.radix, s.n_rows, s.n_compare_cycles, s.n_write_cycles,
            s.sets, s.resets, tuple(int(h) for h in s.mismatch_hist))


def test_traced_run_attributes_like_reference():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 3 ** 4, 120)
    b = rng.integers(0, 3 ** 4, 120)
    arr = ap.encode_operands(a, b, 3, 4)
    stats, ref_stats = ap.APStats(radix=3), ref_ap.APStats(radix=3)
    with apc.tracing() as tr:
        apc.run(arr, apc.compile_named("add", 3, 4), stats=stats,
                device="cpu")
    with ref_apc.tracing() as ref_tr:
        ref_apc.run(jnp.asarray(arr), ref_apc.compile_named("add", 3, 4),
                    stats=ref_stats)
    assert _fields(stats) == _fields(ref_stats)
    assert _fields(tr.total_ap_stats(3)) == _fields(stats)
    assert _fields(ref_tr.total_ap_stats(3)) == _fields(ref_stats)
    assert tr.phase_totals() == ref_tr.phase_totals()
    spans = [(e.name, e.cat, e.args) for e in tr.events
             if isinstance(e, trace.SpanRecord) and e.cat == "execute"]
    ref_spans = [(e.name, e.cat, e.args) for e in ref_tr.events
                 if e.__class__.__name__ == "SpanRecord"
                 and e.cat == "execute"]
    assert spans == ref_spans
    assert trace.validate_chrome_trace(tr.to_chrome())


def test_metrics_registry_matches_reference():
    samples = np.random.default_rng(0).normal(10.0, 3.0, 500).tolist()
    ours, theirs = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    for reg in (ours, theirs):
        reg.counter("runs").inc(3)
        reg.gauge("inflight").set(2.5)
        reg.histogram("ms", max_samples=256).observe_many(samples)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.histogram("ms").quantile(q) == \
            theirs.histogram("ms").quantile(q)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.to_prometheus() == theirs.to_prometheus()
