"""Continuous batching in the port (``repro_torch.serve.batcher``), port
against port, on the CPU.

The reference's BatchServer tests (``tests/test_serve.py``) and the serve
tests of its fault suite (``tests/test_faults.py``: poison isolation,
fault parity, close races, resident churn), on the port's tiny AP engine
(``tests/test_torch_serve.py``): a request served through the batcher
gives the tokens AND the per-request AP accounting of sequential
``Engine.generate``, with no tolerance.  One case the reference lacks: a
hybrid model with SSM state whose merged wave is aborted replays to the
sequential tokens and accounting, which holds only because a request's
checkpoint copies its cache (the SSM state is written in place and its
step is not idempotent).
"""
import threading
import time
import types

import numpy as np
import pytest

from repro_torch import apc
from repro_torch.apc.faults import FaultConfig, FaultModel
from repro_torch.apc.metrics import get_registry
from repro_torch.serve import (AdmissionCfg, AdmissionRejected, BatchServer,
                               ClosedQueue, IterableQueue, RequestHandle,
                               ServeMonitor, SLOCfg, WaveAborted,
                               WaveMerger, wave_cost_cycles)
from tests.test_torch_serve import _cfgs, port_engine, tiny_params

# the fields of a request's AP report that batched serving must reproduce
# (the reference's tests/test_serve.py list, plus the power rollup)
PARITY = ("sets", "resets", "compare_cycles", "write_cycles",
          "energy_total_j", "n_graphs", "n_programs", "makespan_cycles",
          "sequential_cycles", "makespan_ns", "sequential_ns")
N_NEW = 3
PROMPTS = [np.array([[1 + i, 2 + i, 3 + i]], dtype=np.int32)
           for i in range(4)]

_CFG = _cfgs(n_layers=1)[1]
_PARAMS = tiny_params(_CFG)


def tiny_engine(**pool):
    return port_engine(_CFG, _PARAMS, **pool)


@pytest.fixture(autouse=True)
def no_retired_arrays_from_other_files():
    """The monitor reads ``faults.retired_arrays`` as an absolute gauge of
    the process-global registry, which a faulty pool of another file
    (``tests/test_torch_faults.py``, ``tests/test_torch_pool.py``) leaves
    set when pytest-xdist runs that file first in the same worker; each
    test here starts with no array retired, and its own pools set the
    gauge as they retire."""
    get_registry().gauge("faults.retired_arrays").set(0)


@pytest.fixture(scope="module")
def sequential():
    """Sequential single-request serving of PROMPTS: (tokens, report)."""
    eng = tiny_engine()
    out = []
    for p in PROMPTS:
        toks = eng.generate(p, N_NEW)
        out.append((toks, eng.ap_report()))
    return out


def _parity(batched, seq, keys=PARITY):
    for (bt, br), (st, sr) in zip(batched, seq):
        np.testing.assert_array_equal(bt, st)
        for key in keys:
            assert br[key] == sr[key], key
        assert br["power"]["energy_j"] == sr["power"]["energy_j"]


# ---------------------------------------------------------------------------
# IterableQueue (a copy of the reference's)
# ---------------------------------------------------------------------------

def test_iterable_queue_fifo_and_close():
    q = IterableQueue()
    q.put(1)
    q.put(2)
    q.close()
    assert q.closed and q.qsize() == 2
    assert list(q) == [1, 2]
    with pytest.raises(ClosedQueue):
        q.put(3)
    with pytest.raises(ClosedQueue):
        q.close()


def test_iterable_queue_multiple_consumers_terminate():
    q = IterableQueue()
    got, lock = [], threading.Lock()

    def consume():
        for item in q:
            with lock:
                got.append(item)

    threads = [threading.Thread(target=consume) for _ in range(3)]
    for t in threads:
        t.start()
    for i in range(20):
        q.put(i)
    q.close()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(got) == list(range(20))


def test_iterable_queue_concurrent_submitters_drain():
    q = IterableQueue(maxsize=4)
    n_producers, per = 5, 8
    barrier = threading.Barrier(n_producers)

    def produce(base):
        barrier.wait()
        for i in range(per):
            q.put(base + i)

    threads = [threading.Thread(target=produce, args=(100 * p,))
               for p in range(n_producers)]
    for t in threads:
        t.start()
    got = []
    while len(got) < n_producers * per:
        got.append(q.get())
    for t in threads:
        t.join(timeout=30)
    q.close()
    assert list(q) == []
    assert sorted(got) == sorted(100 * p + i for p in range(n_producers)
                                 for i in range(per))


# ---------------------------------------------------------------------------
# BatchServer: bit-exact continuous batching + admission + drain
# ---------------------------------------------------------------------------

def test_batched_serving_bit_identical_to_sequential(sequential):
    """4 concurrent requests: one wave per model step, every graph merged,
    tokens and per-request accounting equal to sequential serving."""
    eng = tiny_engine()
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=8)) as srv:
        handles = [srv.submit(p, N_NEW) for p in PROMPTS]
        results = [(h.result(timeout=300), h.ap_report()) for h in handles]
        status = srv.monitor.status()
    assert srv.n_waves == PROMPTS[0].shape[1] + N_NEW - 1
    assert status["state"] == "healthy" and status["n_requests"] == 4
    _parity(results, sequential)
    assert results[0][1]["n_arrays_total"] == 4


def test_batched_serving_unequal_lengths_and_late_join():
    specs = [(np.array([[1, 2, 3]], dtype=np.int32), 4),
             (np.array([[4, 5]], dtype=np.int32), 2),
             (np.array([[6]], dtype=np.int32), 5),
             (np.array([[7, 8, 9]], dtype=np.int32), 1),
             (np.array([[2, 4]], dtype=np.int32), 0)]
    eng_seq = tiny_engine()
    seq = [eng_seq.generate(p, n) for p, n in specs]
    eng = tiny_engine()
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=3)) as srv:
        handles = [srv.submit(p, n) for p, n in specs]
        out = [h.result(timeout=300) for h in handles]
    for got, want in zip(out, seq):
        np.testing.assert_array_equal(got, want)
    assert out[-1].shape == (1, 0)


def test_admission_cfg_validates():
    with pytest.raises(ValueError):
        AdmissionCfg(policy="drop")
    with pytest.raises(ValueError):
        AdmissionCfg(max_inflight=0)


def test_wave_cost_cycles_scales_with_requests():
    tiled = apc.compile_mac_tiled(3, 6, 7, 6, max_cols=96)
    compiled = tiled.programs[0]
    prof = [[(compiled, 8, ())]]
    one = wave_cost_cycles([prof], n_arrays=1, rows_per_array=8)
    four = wave_cost_cycles([prof] * 4, n_arrays=1, rows_per_array=8)
    assert one > 0
    assert four > one
    assert wave_cost_cycles([], n_arrays=1, rows_per_array=8) == 0


def test_admission_rejects_under_saturated_bank():
    eng = tiny_engine(n_arrays=1, rows=16)
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=4)) as probe:
        probe.submit(np.array([[1, 2, 3]], dtype=np.int32), 2) \
            .result(timeout=300)
        one_req = probe._last_profile
    assert one_req is not None
    pool = eng.ap_ctx.runtime.pool
    one_cost = wave_cost_cycles([one_req], n_arrays=pool.n_arrays,
                                rows_per_array=pool.rows)

    eng2 = tiny_engine(n_arrays=1, rows=16)
    adm = AdmissionCfg(max_inflight=4, max_wave_cycles=int(one_cost * 1.5),
                       policy="reject")
    with BatchServer(eng2, admission=adm) as srv:
        srv.submit(np.array([[1, 2, 3]], dtype=np.int32), 2) \
            .result(timeout=300)               # primes the profile oracle
        a = srv.submit(np.array([[1, 2, 3]], dtype=np.int32), 4)
        b = srv.submit(np.array([[4, 5, 6]], dtype=np.int32), 4)
        outcomes = []
        for h in (a, b):
            try:
                h.result(timeout=300)
                outcomes.append("served")
            except AdmissionRejected:
                outcomes.append("rejected")
    assert "rejected" in outcomes and "served" in outcomes
    assert srv.n_rejected >= 1


def test_batch_server_queue_drain_under_concurrent_submitters():
    eng = tiny_engine()
    handles, lock = [], threading.Lock()
    srv = BatchServer(eng, admission=AdmissionCfg(max_inflight=4))

    def client(seed):
        h = srv.submit(np.array([[1 + seed, 2 + seed]], dtype=np.int32), 2)
        with lock:
            handles.append(h)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    srv.close(wait=True)
    assert len(handles) == 6
    for h in handles:
        assert h.result(timeout=10).shape == (1, 2)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.array([[1, 2]], dtype=np.int32), 1)


def test_batch_server_fails_bad_request_only():
    eng = tiny_engine()
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=4)) as srv:
        good = srv.submit(np.array([[1, 2]], dtype=np.int32), 2)
        bad = srv.submit(np.zeros((1, 0), dtype=np.int32), 2)
        assert good.result(timeout=300).shape == (1, 2)
        with pytest.raises(ValueError, match="empty prompt"):
            bad.result(timeout=300)


def test_float_route_batches_scheduling_only():
    """No ap_ctx: lockstep waves of float steps, nothing merged, no
    report; tokens as sequential."""
    eng = port_engine(_CFG, _PARAMS, ap=False)
    seq = [eng.generate(p, 2) for p in PROMPTS[:2]]
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=2)) as srv:
        handles = [srv.submit(p, 2) for p in PROMPTS[:2]]
        out = [(h.result(timeout=300), h.ap_report()) for h in handles]
    for (toks, rep), want in zip(out, seq):
        np.testing.assert_array_equal(toks, want)
        assert rep is None


# ---------------------------------------------------------------------------
# Faults: poison isolation, a degraded bank, close races, resident churn
# ---------------------------------------------------------------------------

def test_request_handle_timeout_on_abandoned_handle():
    h = RequestHandle(np.array([[1]], dtype=np.int32), 1)
    with pytest.raises(TimeoutError):
        h.result(timeout=0.05)
    with pytest.raises(TimeoutError):
        h.ap_report(timeout=0.05)


POISON = 31


def _poisoned(eng):
    """Requests whose prompt starts with POISON fail every step."""
    orig = eng.new_request

    def new_request(prompt, *a, **kw):
        req = orig(prompt, *a, **kw)
        if int(np.asarray(prompt)[0, 0]) == POISON:
            def bad_step(*sa, **skw):
                raise RuntimeError("injected poison step")
            req.step = bad_step
        return req

    eng.new_request = new_request
    return eng


def test_serve_poison_request_isolated_siblings_bit_exact(sequential):
    """One poisoned request in a 4-wide wave fails alone; its siblings
    roll back, re-run solo and match sequential serving exactly."""
    reg = get_registry()
    names = ["serve.wave_aborts", "serve.solo_reruns", "serve.poisoned"]
    base = reg.counter_values(names)
    eng = _poisoned(tiny_engine())
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=8)) as srv:
        handles = [srv.submit(p, N_NEW) for p in PROMPTS[:3]]
        ph = srv.submit(np.array([[POISON, 2, 3]], dtype=np.int32), N_NEW)
        results = [(h.result(timeout=600), h.ap_report()) for h in handles]
        with pytest.raises(RuntimeError, match="injected poison step"):
            ph.result(timeout=600)
        status = srv.monitor.status()
    _parity(results, sequential[:3], PARITY[:9])
    delta = {k: v - base[k] for k, v in reg.counter_values(names).items()}
    assert delta["serve.wave_aborts"] >= 1
    assert delta["serve.solo_reruns"] >= 1
    assert delta["serve.poisoned"] >= 1
    assert status["state"] == "degraded"
    assert status["faults"]["poisoned"] >= 1


def test_serve_fault_injection_parity_on_degraded_bank():
    """Seeded stuck-at faults on both engines: recovery keeps batched
    tokens equal to sequential tokens while arrays retire underneath."""
    cfg = FaultConfig(stuck_rate=1e-4, seed=2)

    def faulty_engine():
        eng = tiny_engine()
        pool = eng.ap_ctx.runtime.pool
        pool.fault_model = FaultModel(cfg, pool.n_arrays, pool.rows,
                                      pool.cols)
        return eng

    seq_eng = faulty_engine()
    seq = [seq_eng.generate(p, N_NEW) for p in PROMPTS]
    eng = faulty_engine()
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=8)) as srv:
        handles = [srv.submit(p, N_NEW) for p in PROMPTS]
        results = [h.result(timeout=600) for h in handles]
    for bt, st in zip(results, seq):
        np.testing.assert_array_equal(bt, st)
    fm = eng.ap_ctx.runtime.pool.fault_model
    assert sum(fm.detections) > 0
    assert len(fm.retired) > 0


def test_batch_server_close_races_and_stranded_handles():
    eng = tiny_engine()
    reg = get_registry()
    base = reg.counter("serve.stranded").value
    srv = BatchServer(eng, admission=AdmissionCfg(max_inflight=4))

    def boom(*a, **kw):
        raise OSError("injected dispatcher crash")

    srv._run_wave = boom
    h = srv.submit(np.array([[1, 2]], dtype=np.int32), 2)
    with pytest.raises(RuntimeError, match="dispatcher exited"):
        h.result(timeout=60)
    assert reg.counter("serve.stranded").value > base
    t0 = time.perf_counter()
    srv.close(wait=True)
    assert time.perf_counter() - t0 < 30
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.array([[1, 2]], dtype=np.int32), 2)


def test_serve_resident_churn_repins_bit_exact(monkeypatch, sequential):
    """The resident store cleared by a concurrent thread every 2 ms:
    requests still complete bit-identically (evicted planes re-pin)."""
    monkeypatch.setenv("REPRO_AP_RESIDENT", "1")
    eng = tiny_engine()
    store = eng.ap_ctx.runtime.pool.resident
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            store.clear()
            time.sleep(0.002)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        with BatchServer(eng, admission=AdmissionCfg(max_inflight=4)) \
                as srv:
            handles = [srv.submit(p, N_NEW) for p in PROMPTS[:2]]
            results = [h.result(timeout=600) for h in handles]
    finally:
        stop.set()
        t.join(timeout=10)
    for bt, (st, _) in zip(results, sequential[:2]):
        np.testing.assert_array_equal(bt, st)


# ---------------------------------------------------------------------------
# A wave abort on a model with SSM state
# ---------------------------------------------------------------------------

def _hybrid():
    """jamba's smoke config at the tiny widths, two layers: a mamba layer
    with a packed MLP, then a mamba layer with a 4-expert MoE."""
    _, cfg = _cfgs("jamba-v0.1-52b", n_layers=2)
    cfg = cfg.with_(moe=cfg.moe.__class__(n_experts=4, top_k=2, d_ff=24))
    return cfg, tiny_params(cfg, seed=3)


def test_hybrid_wave_abort_replays_ssm_state_exactly():
    """Every wave of two siblings and a poisoned request aborts after the
    siblings' mamba layer has stepped its state in place; each sibling
    rolls back to its checkpoint (the cache copied) and replays solo: the
    tokens and accounting of sequential serving, which a checkpoint that
    kept the cache by reference would not give (the state would step
    twice)."""
    cfg, params = _hybrid()
    prompts = [np.array([[5 + i, 9 + i]], dtype=np.int32) for i in range(2)]
    seq_eng = port_engine(cfg, params)
    seq = []
    for p in prompts:
        toks = seq_eng.generate(p, 2)
        seq.append((toks, seq_eng.ap_report()))
    assert seq_eng.ap_report()["n_graphs"] == 2 * 2 * 3
    reg = get_registry()
    base = reg.counter("serve.solo_reruns").value
    eng = _poisoned(port_engine(cfg, params))
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=4)) as srv:
        handles = [srv.submit(p, 2) for p in prompts]
        ph = srv.submit(np.array([[POISON, 1]], dtype=np.int32), 2)
        results = [(h.result(timeout=600), h.ap_report()) for h in handles]
        with pytest.raises(RuntimeError, match="injected poison step"):
            ph.result(timeout=600)
    assert reg.counter("serve.solo_reruns").value - base >= 2
    _parity(results, seq, PARITY[:9])


def test_request_checkpoint_copies_the_cache():
    cfg, params = _hybrid()
    eng = port_engine(cfg, params)
    req = eng.new_request(np.array([[1, 2]], dtype=np.int32), 1)
    with apc.ap_serving(eng.ap_ctx):
        req.step()
        ck = req.checkpoint()
        state = next(iter(req.cache["rest_0"]["mamba"].values()))
        saved = state.clone()
        req.step()
        assert not next(iter(req.cache["rest_0"]["mamba"].values())) \
            .equal(saved)
        req.restore(ck)
    assert next(iter(req.cache["rest_0"]["mamba"].values())).equal(saved)
    assert next(iter(ck["cache"]["rest_0"]["mamba"].values())).equal(saved)
    assert req.pos == 1 and len(req.out) == 0


# ---------------------------------------------------------------------------
# The monitor (a copy of the reference's)
# ---------------------------------------------------------------------------

def test_serve_monitor_slo_breaches():
    mon = ServeMonitor(SLOCfg(request_ms=10.0, wave_ms=5.0,
                              peak_power_w=1.0))
    mon.observe_wave(1.0, inflight=1, queued=0, bank_peak_w=0.5)
    mon.observe_request(2.0, power_peak_w=0.5)
    assert mon.status()["healthy"]
    mon.observe_wave(6.0, inflight=2, queued=1, bank_peak_w=2.0)
    mon.observe_request(20.0)
    st = mon.status()
    assert st["breaches"] == {"latency": 1, "p99": 0, "wave": 1,
                              "power": 1}
    assert st["state"] == "unhealthy"
    assert "serve_" in mon.to_prometheus()


@pytest.mark.parametrize("first", ["step ends", "graph call"])
def test_wave_merger_out_of_cadence_breaks_without_a_clock(first):
    """A wave reads no clock: slot 0's step ends while slot 1 waits at a
    graph call, or slot 1 makes a graph call after slot 0's step ended;
    either way slot 1 sees ``WaveAborted`` at once instead of waiting for
    a partner that will not come."""
    merger = WaveMerger(None, 2)
    errors = []

    def slot_1():
        merger.bind(1)
        try:
            merger.run_graph(None, types.SimpleNamespace(nodes=[]), None)
        except WaveAborted as e:
            errors.append(e)

    t = threading.Thread(target=slot_1, daemon=True)
    if first == "step ends":
        merger.finish(0)
        t.start()
    else:
        t.start()
        deadline = time.monotonic() + 30
        while merger._barrier.n_waiting < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        merger.finish(0)
    t.join(timeout=30)
    assert not t.is_alive()
    assert len(errors) == 1


def test_wave_aborted_is_a_runtime_error():
    assert issubclass(WaveAborted, RuntimeError)
    assert issubclass(AdmissionRejected, RuntimeError)
