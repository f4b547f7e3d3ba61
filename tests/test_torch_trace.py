"""The port's copies of the tracer and the metrics registry against the
reference: the same traced run attributes the same counters, and the
registry's quantiles and exposition agree on the same samples.  Then the
port's own tracing of served AP waves: spans nest per thread, and one
installed tracer records the server's dispatcher and wave workers without
changing a token or a counter of the requests."""
import contextlib
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

from repro import apc as ref_apc
from repro.apc import metrics as ref_metrics
from repro.core import ap as ref_ap

from repro_torch import apc
from repro_torch.apc import metrics, trace
from repro_torch.core import ap
from repro_torch.serve import AdmissionCfg, BatchServer
from tests.test_torch_serve import _cfgs, port_engine, tiny_params


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


def test_spans_nest_per_thread():
    """Two threads interleave their nested spans: each closes its own
    innermost span, and each span's parent is its own thread's."""
    step = threading.Barrier(2)

    def work(tag):
        with trace.span(f"{tag}.outer"):
            step.wait(timeout=30)
            with trace.span(f"{tag}.inner"):
                step.wait(timeout=30)
            step.wait(timeout=30)
            trace.instant(f"{tag}.mark")

    with trace.tracing() as tr:
        threads = [threading.Thread(target=work, args=(t,), name=f"t-{t}")
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    spans = {e.name: e for e in tr.events
             if isinstance(e, trace.SpanRecord)}
    assert set(spans) == {"a.outer", "a.inner", "b.outer", "b.inner"}
    for tag in ("a", "b"):
        assert spans[f"{tag}.inner"].parent == f"{tag}.outer"
        assert spans[f"{tag}.outer"].parent is None
        assert spans[f"{tag}.inner"].thread == f"t-{tag}"
        mark = next(e for e in tr.events if e.name == f"{tag}.mark")
        assert mark.thread == f"t-{tag}"
    doc = tr.to_chrome()
    trace.validate_chrome_trace(doc)
    tids = {ev["tid"] for ev in doc["traceEvents"] if ev["ph"] == "X"}
    assert len(tids) == 2          # one host track per thread


def test_spans_from_many_threads_all_recorded():
    """More threads than cores, switching often, each opening nested
    spans: no record is lost and every parent is its own thread's."""
    n_threads, n_spans = 16, 200

    def work(i):
        for j in range(n_spans):
            with trace.span(f"outer{i}"):
                with trace.span(f"inner{i}", j=j):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.tracing() as tr:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    spans = [e for e in tr.events if isinstance(e, trace.SpanRecord)]
    assert len(spans) == 2 * n_threads * n_spans
    for e in spans:
        outer = e.name.startswith("outer")
        assert e.parent == (None if outer else f"outer{e.name[5:]}")


def test_spans_map_onto_the_epoch_clock():
    """Off, a span is the shared no-op; on, a span's interval mapped to
    ``time.time_ns()`` lies between wall readings taken around it."""
    assert trace.current_tracer() is None
    assert trace.span("off") is trace._NULL_SPAN
    with trace.tracing() as tr:
        wall0 = time.time_ns()
        with trace.span("timed"):
            time.sleep(0.01)
        wall1 = time.time_ns()
    rec = next(e for e in tr.events if e.name == "timed")
    start, end = tr.epoch_ns(rec)
    slack = 1_000_000              # the two clocks' readings, 1 ms
    assert wall0 - slack <= start <= end <= wall1 + slack
    assert end - start >= 10_000_000
    assert tr.to_chrome()["otherData"]["origin_epoch_ns"] == \
        tr.origin_epoch_ns


# ---------------------------------------------------------------------------
# A merged AP wave of two requests, traced and not
# ---------------------------------------------------------------------------

WAVE_CFG = _cfgs(n_layers=2)[1]
WAVE_PROMPTS = [np.array([[1, 2, 3]], np.int32),
                np.array([[4, 5, 6]], np.int32)]
WAVE_NEW = 3


def _serve_two(traced: bool):
    """Serve WAVE_PROMPTS through one BatchServer: (tokens and AP report
    of each request, the tracer or None, ``ap.linear.builds`` delta)."""
    eng = port_engine(WAVE_CFG, tiny_params(WAVE_CFG))
    builds = metrics.get_registry().counter("ap.linear.builds")
    b0 = builds.value
    tr = trace.Tracer() if traced else None
    with trace.tracing(tr) if traced else contextlib.nullcontext():
        with BatchServer(eng, admission=AdmissionCfg(max_inflight=2)) as srv:
            handles = [srv.submit(p, WAVE_NEW) for p in WAVE_PROMPTS]
            out = [(h.result(timeout=300), h.ap_report()) for h in handles]
    return out, tr, builds.value - b0


@pytest.fixture(scope="module")
def served_two():
    return _serve_two(traced=True), _serve_two(traced=False)


def _spans(tr, name):
    return [e for e in tr.events
            if isinstance(e, trace.SpanRecord) and e.name == name]


def test_merged_wave_traced_from_worker_threads(served_two):
    (_, tr, _), _ = served_two
    for name in ("ap.linear_build", "serve.wave_wait", "serve.wave_merge",
                 "serve.step"):
        spans = _spans(tr, name)
        assert spans, name
        assert all(s.thread.startswith("ap-serve-w") for s in spans), name
    assert any(s.args["n_slots"] == 2 for s in _spans(tr, "serve.wave_merge"))
    for name in ("serve.wave", "serve.admit", "serve.checkpoint",
                 "serve.retire", "ap.sink_flush"):
        spans = _spans(tr, name)
        assert spans, name
        assert {s.thread for s in spans} == {"ap-serve-dispatch"}, name
    assert {s.parent for s in _spans(tr, "ap.sink_flush")} == \
        {"serve.retire"}
    assert trace.validate_chrome_trace(tr.to_chrome())


def test_merged_wave_tracing_changes_no_token_or_counter(served_two):
    (traced, _, _), (plain, _, _) = served_two
    for (toks, rep), (want_toks, want_rep) in zip(traced, plain):
        np.testing.assert_array_equal(toks, want_toks)
        assert rep == want_rep


def test_merged_wave_step_spans_per_request(served_two):
    (_, tr, _), _ = served_two
    s_prompt = WAVE_PROMPTS[0].shape[1]
    steps = _spans(tr, "serve.step")
    for seq in range(len(WAVE_PROMPTS)):
        mine = sorted((s for s in steps if s.args["request"] == seq),
                      key=lambda s: s.args["pos"])
        assert [s.args["pos"] for s in mine] == \
            list(range(s_prompt + WAVE_NEW - 1))
        assert [s.args["phase"] for s in mine] == \
            ["prefill"] * s_prompt + ["decode"] * (WAVE_NEW - 1)
        assert all(s.args["batch"] == 1 for s in mine)


def test_linear_builds_counted_as_spans(served_two):
    (_, tr, builds), (_, _, plain_builds) = served_two
    assert builds == len(_spans(tr, "ap.linear_build")) > 0
    assert plain_builds == builds
    # the cache is keyed on id() of the per-call weight views: today every
    # projection call of every step builds (3 a layer)
    n_steps = len(_spans(tr, "serve.step"))
    assert builds == 3 * WAVE_CFG.n_layers * n_steps
