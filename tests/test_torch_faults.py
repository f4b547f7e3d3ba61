"""The port's fault model (``apc/faults.py``) and the array pool's fault
path (``ArrayPool._run_faulty``, checksum verify, retry, retirement, node
re-execution, resident re-pinning) against the reference's, on the same
seeded inputs: the same stuck maps, stuck values and flips, the same
recovered digits, ``APStats`` (checksum and retry charges drained), fault
snapshots, ``faults.*`` counters and ``FaultDetected`` coordinates.  The
port runs on ``device="cpu"``, the reference's Pallas kernel in interpret
mode.  Mirrors the non-serve part of ``tests/test_faults.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import apc as ref_apc
from repro.apc import faults as ref_faults
from repro.apc.metrics import get_registry as ref_registry
from repro.core import ap as ref_ap

from repro_torch import apc
from repro_torch.apc.faults import (FaultConfig, FaultDetected, FaultModel,
                                    expected_checksum, fault_config_from_env,
                                    faults_enabled, validate_digits)
from repro_torch.apc.metrics import get_registry
from repro_torch.core import ap

CPU = "cpu"
RADIX, W = 3, 4
COLS = 2 * W + 2          # one spare column for the checksum fold
FAULT_COUNTERS = ("faults.detected", "faults.retries", "faults.retired",
                  "faults.checksum_runs", "faults.checksum_host_fallback",
                  "faults.node_retries", "pool.launches")


def stats_fields(s):
    return (s.radix, s.n_rows, s.n_compare_cycles, s.n_write_cycles,
            s.sets, s.resets, tuple(int(h) for h in s.mismatch_hist))


def _add_case(rows=48, seed=0):
    rng = np.random.default_rng(seed)
    arr = ap.encode_operands(rng.integers(0, RADIX ** W, rows),
                             rng.integers(0, RADIX ** W, rows), RADIX, W)
    return (arr, apc.compile_named("add", RADIX, W),
            ref_apc.compile_named("add", RADIX, W))


def _pools(n_arrays, rows, cols, **cfg):
    return (apc.ArrayPool(n_arrays=n_arrays, rows=rows, cols=cols,
                          device=CPU, faults=FaultConfig(**cfg)),
            ref_apc.ArrayPool(n_arrays=n_arrays, rows=rows, cols=cols,
                              faults=ref_faults.FaultConfig(**cfg)))


def _counters(reg):
    return {k: reg.counter(k).value for k in FAULT_COUNTERS}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _pooled_both(arr, ours, theirs, pool, ref_pool):
    """run_pooled on both sides; returns the port's digits and asserts
    digits, APStats (charges drained) and fault counters equal."""
    b, rb = _counters(get_registry()), _counters(ref_registry())
    st, ref_st = ap.APStats(radix=RADIX), ref_ap.APStats(radix=RADIX)
    out = apc.run_pooled(arr, ours, pool, stats=st)
    want = ref_apc.run_pooled(jnp.asarray(arr), theirs, ref_pool,
                              stats=ref_st)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert stats_fields(st) == stats_fields(ref_st)
    assert pool.fault_model.snapshot() == ref_pool.fault_model.snapshot()
    got = _delta(_counters(get_registry()), b)
    assert got == _delta(_counters(ref_registry()), rb)
    return out, got


# ---------------------------------------------------------------------------
# Config + env knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    ({"stuck_rate": 1.5}, "stuck_rate"), ({"flip_rate": -0.1}, "flip_rate"),
    ({"radix": 1}, "radix"), ({"max_retries": -1}, "retry counts"),
    ({"retire_after": 0}, "retire_after"), ({"wear_ref": 0}, "wear_ref")])
def test_fault_config_validation(kw, match):
    for cfg in (FaultConfig, ref_faults.FaultConfig):
        with pytest.raises(ValueError, match=match):
            cfg(**kw)


def test_fault_model_rejects_bad_dead_arrays():
    for fm, cfg in ((FaultModel, FaultConfig),
                    (ref_faults.FaultModel, ref_faults.FaultConfig)):
        with pytest.raises(ValueError, match="outside bank"):
            fm(cfg(dead_arrays=(4,)), 4, 16, COLS)
        with pytest.raises(ValueError, match="every array"):
            fm(cfg(dead_arrays=(0, 1)), 2, 16, COLS)


def test_fault_env_knobs(monkeypatch):
    monkeypatch.delenv("REPRO_AP_FAULTS", raising=False)
    assert not faults_enabled()
    for v in ("1", "true", "YES", "on"):
        monkeypatch.setenv("REPRO_AP_FAULTS", v)
        assert faults_enabled() and ref_faults.faults_enabled()
    monkeypatch.setenv("REPRO_AP_FAULTS", "0")
    assert not faults_enabled()
    monkeypatch.setenv("REPRO_AP_FAULT_STUCK", "1e-4")
    monkeypatch.setenv("REPRO_AP_FAULT_FLIP", "2e-3")
    monkeypatch.setenv("REPRO_AP_FAULT_DEAD", "1,3")
    monkeypatch.setenv("REPRO_AP_FAULT_SEED", "7")
    monkeypatch.setenv("REPRO_AP_FAULT_RETRIES", "5")
    monkeypatch.setenv("REPRO_AP_FAULT_RETIRE_AFTER", "2")
    cfg = fault_config_from_env()
    assert (cfg.stuck_rate, cfg.flip_rate, cfg.dead_arrays, cfg.seed,
            cfg.max_retries, cfg.retire_after) == (1e-4, 2e-3, (1, 3), 7,
                                                   5, 2)
    assert vars(cfg) == vars(ref_faults.fault_config_from_env())


def test_pool_installs_fault_model_from_env(monkeypatch):
    monkeypatch.delenv("REPRO_AP_FAULTS", raising=False)
    assert apc.ArrayPool(n_arrays=2, rows=16, cols=COLS,
                         device=CPU).fault_model is None
    monkeypatch.setenv("REPRO_AP_FAULTS", "1")
    monkeypatch.setenv("REPRO_AP_FAULT_STUCK", "1e-4")
    monkeypatch.setenv("REPRO_AP_FAULT_SEED", "2")
    pool = apc.ArrayPool(n_arrays=2, rows=16, cols=COLS, device=CPU)
    assert pool.fault_model is not None
    assert (pool.fault_model.cfg.stuck_rate,
            pool.fault_model.cfg.seed) == (1e-4, 2)
    explicit = apc.ArrayPool(n_arrays=2, rows=16, cols=COLS, device=CPU,
                             faults=FaultConfig(stuck_rate=0.5))
    assert explicit.fault_model.cfg.stuck_rate == 0.5


# ---------------------------------------------------------------------------
# The seeded draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rate,radix", [(3, 0.05, 3), (0, 0.3, 5),
                                             (11, 1.0, 4)])
def test_stuck_maps_and_flips_equal_reference(seed, rate, radix):
    """Stuck maps and values (the between-levels value ``radix``
    included) per array, and the flips of successive corruptions, are the
    reference's draw for draw."""
    cfg = dict(stuck_rate=rate, flip_rate=rate / 2, seed=seed, radix=radix,
               wear_ref=50)
    fm = FaultModel(FaultConfig(**cfg), 3, 32, COLS)
    rfm = ref_faults.FaultModel(ref_faults.FaultConfig(**cfg), 3, 32, COLS)
    for a in (0, 2, 1):
        (m, v), (rm, rv) = fm.stuck_cells(a), rfm.stuck_cells(a)
        assert np.array_equal(m, rm) and np.array_equal(v, rv)
        assert v.dtype == np.int8 and v.min() >= 0 and v.max() <= radix
    true = np.random.default_rng(seed).integers(
        0, radix, (32, COLS)).astype(np.int8)
    for a in (1, 1, 0, 2):
        fm.record_write(a, 40)
        rfm.record_write(a, 40)
        assert fm.flip_rate(a) == rfm.flip_rate(a)
        assert np.array_equal(fm.corrupt(true[:20], a, radix),
                              rfm.corrupt(true[:20], a, radix))
    if rate == 1.0:
        assert (fm.stuck_cells(0)[1] == radix).any()


def test_stuck_map_deterministic_per_array():
    fm1 = FaultModel(FaultConfig(stuck_rate=0.05, seed=3), 2, 32, COLS)
    fm2 = FaultModel(FaultConfig(stuck_rate=0.05, seed=3), 2, 32, COLS)
    m1, v1 = fm1.stuck_cells(0)
    m2, v2 = fm2.stuck_cells(0)
    assert np.array_equal(m1, m2) and np.array_equal(v1, v2)
    assert not np.array_equal(m1, fm1.stuck_cells(1)[0])
    assert v1.min() >= 0 and v1.max() <= RADIX


def test_retirement_wear_and_snapshot_match_reference():
    for fm in (FaultModel(FaultConfig(retire_after=2, flip_rate=1e-3,
                                      wear_ref=1000), 3, 16, COLS),
               ref_faults.FaultModel(ref_faults.FaultConfig(
                   retire_after=2, flip_rate=1e-3, wear_ref=1000), 3, 16,
                   COLS)):
        assert fm.record_detection(1) is False
        assert fm.record_detection(1) is True
        assert fm.record_detection(1) is False
        assert fm.retired == {1} and fm.healthy() == [0, 2]
        fm.record_write(0, 3000)
        assert fm.flip_rate(0) == pytest.approx(4e-3)
        assert fm.flip_rate(2) == pytest.approx(1e-3)
        with pytest.raises(ValueError, match="outside bank"):
            fm.retire(3)
    assert fm.snapshot() == {"n_arrays": 3, "retired": [1], "surviving": 2,
                             "detections": [0, 3, 0],
                             "wear": [3000, 0, 0]}


# ---------------------------------------------------------------------------
# Zero-overhead guarantee + honest pricing
# ---------------------------------------------------------------------------

def test_faults_off_bit_identical(monkeypatch):
    monkeypatch.delenv("REPRO_AP_FAULTS", raising=False)
    arr, ours, _ = _add_case(rows=101)
    out_e, tr_e = apc.execute(arr, ours, collect_stats=True, device=CPU)
    pool = apc.ArrayPool(n_arrays=3, rows=16, cols=COLS, device=CPU)
    out_p, tr_p = pool.run(arr, ours, collect_stats=True)
    assert torch.equal(out_e, out_p)
    assert stats_fields(apc.to_ap_stats(tr_e, ours, 101, RADIX)) == \
        stats_fields(apc.to_ap_stats(tr_p, ours, 101, RADIX))
    assert pool.consume_fault_charges() == []


def test_zero_rate_model_checksums_priced_like_reference():
    """A zero-rate model never corrupts, but each block's checksum verify
    runs the compiled checksum program and is charged: the same charges,
    counter rows and APStats as the reference's."""
    arr, ours, theirs = _add_case(rows=48)
    pool, ref_pool = _pools(2, 16, COLS)
    out_p, tr_p = pool.run(arr, ours, collect_stats=True, radix=RADIX)
    want, want_tr = ref_pool.run(jnp.asarray(arr), theirs,
                                 collect_stats=True, radix=RADIX)
    assert np.array_equal(out_p.numpy(), np.asarray(want))
    assert np.array_equal(tr_p.block_counts.numpy(),
                          np.asarray(want_tr.block_counts))
    charges = pool.consume_fault_charges()
    ref_charges = ref_pool.consume_fault_charges()
    assert len(charges) == len(ref_charges) == pool.n_blocks(48)
    for (tr, prog, n, label), (rtr, rprog, rn, rlabel) in zip(
            charges, ref_charges):
        assert (n, label) == (rn, rlabel) == (16, "fault_checksum")
        assert np.array_equal(tr.block_counts.numpy(),
                              np.asarray(rtr.block_counts))
        assert (prog.n_write_cycles, prog.n_compare_cycles) == \
            (rprog.n_write_cycles, rprog.n_compare_cycles)
    assert pool.consume_fault_charges() == []
    _, counts = _pooled_both(arr, ours, theirs, pool, ref_pool)
    assert counts["faults.checksum_runs"] == pool.n_blocks(48)


# ---------------------------------------------------------------------------
# Recovery: stuck cells, transient flips, dead arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stuck_at_recovery_matches_reference(seed):
    arr, ours, theirs = _add_case(rows=64, seed=seed)
    pool, ref_pool = _pools(4, 16, COLS, stuck_rate=2e-3, seed=seed)
    out, _ = _pooled_both(arr, ours, theirs, pool, ref_pool)
    assert torch.equal(out, apc.execute(arr, ours, device=CPU)[0])


def test_flip_recovery_detects_retries_and_matches_reference():
    """Flips at a rate where blocks are caught and retried: recovered
    digits, APStats with the retry charges, snapshots and counters equal
    the reference's; two runs of one seed give one fault state."""
    arr, ours, theirs = _add_case(rows=64, seed=9)
    snaps = []
    for _ in range(2):
        pool, ref_pool = _pools(4, 16, COLS, flip_rate=5e-3, seed=7,
                                max_retries=8, retire_after=100)
        out, counts = _pooled_both(arr, ours, theirs, pool, ref_pool)
        assert counts["faults.detected"] > 0 and counts["faults.retries"] > 0
        assert torch.equal(out, apc.execute(arr, ours, device=CPU)[0])
        snaps.append(pool.fault_model.snapshot())
    assert snaps[0] == snaps[1]


def test_dead_arrays_recovery_and_repricing():
    arr, ours, theirs = _add_case(rows=70, seed=4)
    pool, ref_pool = _pools(4, 16, COLS, dead_arrays=(1,))
    assert pool.dead_arrays == ref_pool.dead_arrays == (1,)
    assert pool.healthy_arrays() == [0, 2, 3]
    _pooled_both(arr, ours, theirs, pool, ref_pool)
    cc, wc = ours.n_compare_cycles, ours.n_write_cycles
    assert [pool.wall_cycles(n * 16, cc, wc)["waves"]
            for n in (5, 6, 7)] == [2, 2, 3]
    assert pool.block_intervals(6, ours) == \
        ref_pool.block_intervals(6, theirs)
    assert {a for _, a, _, _, _ in pool.block_intervals(6, ours)} == \
        {0, 2, 3}


def test_every_array_retired_raises():
    pool = apc.ArrayPool(n_arrays=2, rows=16, cols=COLS, device=CPU,
                         faults=FaultConfig())
    pool.fault_model.retire(0)
    pool.fault_model.retire(1)
    with pytest.raises(FaultDetected, match="every array"):
        pool.healthy_arrays()


def test_exhausted_retries_raise_with_reference_coordinates():
    arr, ours, theirs = _add_case(rows=32, seed=5)
    pool, ref_pool = _pools(2, 16, COLS, stuck_rate=0.3, seed=0,
                            max_retries=1)
    with pytest.raises(FaultDetected) as ei:
        pool.run(arr, ours, radix=RADIX)
    with pytest.raises(ref_faults.FaultDetected) as ref_ei:
        ref_pool.run(jnp.asarray(arr), theirs, radix=RADIX)
    assert (ei.value.block, ei.value.array, ei.value.node) == \
        (ref_ei.value.block, ref_ei.value.array, ref_ei.value.node)
    assert ei.value.block is not None and ei.value.array is not None
    assert str(ei.value) == str(ref_ei.value)
    assert pool.fault_model.snapshot() == ref_pool.fault_model.snapshot()


def test_block_valid_launch_under_faults_matches_reference():
    """A row-concatenated launch on a faulty bank: the verify covers each
    block's valid rows only, as the reference's does."""
    rows = np.random.default_rng(3).integers(
        0, RADIX, (48, 2 * W + 1)).astype(np.int8)
    ours = apc.compile_named("add", RADIX, W)
    theirs = ref_apc.compile_named("add", RADIX, W)
    pool, ref_pool = _pools(3, 16, COLS, flip_rate=3e-3, seed=4,
                            max_retries=8, retire_after=100)
    bv = (5, 16, 9)
    out, tr = pool.run(rows, ours, collect_stats=True, block_valid=bv,
                       radix=RADIX)
    want, want_tr = ref_pool.run(jnp.asarray(rows), theirs,
                                 collect_stats=True, block_valid=bv,
                                 radix=RADIX)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert np.array_equal(tr.block_counts.numpy(),
                          np.asarray(want_tr.block_counts))
    assert pool.fault_model.snapshot() == ref_pool.fault_model.snapshot()


# ---------------------------------------------------------------------------
# Detection: checksum + digit-range validation
# ---------------------------------------------------------------------------

def test_expected_checksum_catches_any_single_cell_delta():
    rng = np.random.default_rng(0)
    true = rng.integers(0, RADIX, (8, 9)).astype(np.int8)
    cs = expected_checksum(true, RADIX)
    assert np.array_equal(cs, ref_faults.expected_checksum(true, RADIX))
    for r in range(true.shape[0]):
        for delta in range(1, RADIX):
            bad = true.copy()
            bad[r, 3] = (bad[r, 3] + delta) % RADIX
            got = expected_checksum(bad, RADIX)
            assert got[r] != cs[r]
            assert np.array_equal(np.delete(got, r), np.delete(cs, r))


def test_compiled_checksum_program_matches_host_and_reference():
    from repro.apc.lower import compile_checksum as ref_compile_checksum
    from repro_torch.apc.lower import compile_checksum
    rng = np.random.default_rng(1)
    digits = rng.integers(0, RADIX, (16, 9)).astype(np.int8)
    prog = compile_checksum(9, RADIX)
    assert prog.n_compare_cycles > 0 and prog.n_write_cycles > 0
    arr = np.concatenate([digits, np.zeros((16, 1), np.int8)], axis=1)
    out, tr = apc.execute(arr, prog, collect_stats=True, device=CPU)
    want, want_tr = ref_apc.execute(jnp.asarray(arr),
                                    ref_compile_checksum(9, RADIX),
                                    collect_stats=True)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert np.array_equal(tr.block_counts.numpy(),
                          np.asarray(want_tr.block_counts))
    assert np.array_equal(out.numpy()[:, 9],
                          expected_checksum(digits, RADIX))


def test_validate_digits():
    validate_digits(np.array([[0, 1, 2]]), RADIX)
    with pytest.raises(FaultDetected, match="outside"):
        validate_digits(np.array([[0, 1, RADIX]]), RADIX)
    with pytest.raises(FaultDetected, match="stuck probe"):
        validate_digits(np.array([[-1, 0, 1]]), RADIX, what="stuck probe")


def test_mac_tiled_recovers_under_stuck_faults_like_reference():
    radix, K, max_abs = 3, 7, 3
    width = apc.mac_acc_width(radix, K, max_abs)
    tiled = apc.compile_mac_tiled(radix, K, width, 3)
    ref_tiled = ref_apc.compile_mac_tiled(radix, K, width, 3)
    cols = max(tiled.min_cols, 2 * width + 1) + 1   # spare checksum col
    rng = np.random.default_rng(6)
    x = rng.integers(-max_abs, max_abs + 1, (24, K))
    w = rng.integers(-1, 2, (24, K))
    pool, ref_pool = _pools(4, 8, cols, stuck_rate=2e-3, seed=1)
    st, ref_st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    acc = apc.run_mac_tiled(x, w, tiled, pool=pool, stats=st)
    want = ref_apc.run_mac_tiled(jnp.asarray(x, jnp.int32),
                                 jnp.asarray(w, jnp.int8), ref_tiled,
                                 pool=ref_pool, stats=ref_st)
    assert np.array_equal(acc.numpy(), np.asarray(want))
    assert np.array_equal(acc.numpy(), (x * w).sum(axis=1))
    assert stats_fields(st) == stats_fields(ref_st)
    assert pool.fault_model.snapshot() == ref_pool.fault_model.snapshot()
    assert pool.consume_fault_charges() == []


# ---------------------------------------------------------------------------
# Runtime: node-level re-execution + degraded makespan
# ---------------------------------------------------------------------------

def test_runtime_node_retry_recovers(monkeypatch):
    arr, ours, _ = _add_case(rows=32, seed=2)
    pool = apc.ArrayPool(n_arrays=2, rows=16, cols=COLS, device=CPU,
                         faults=FaultConfig(node_retries=1))
    rt = apc.Runtime(pool)
    g = apc.ProgramGraph()
    g.add(ours, rows=32, build=lambda: torch.from_numpy(arr), label="add")
    calls = {"n": 0}
    real_run = pool.run

    def flaky_run(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise FaultDetected("injected", block=0, array=0)
        return real_run(*a, **kw)

    monkeypatch.setattr(pool, "run", flaky_run)
    base = get_registry().counter("faults.node_retries").value
    res = rt.run_graph(g)
    assert torch.equal(res[0], apc.execute(arr, ours, device=CPU)[0])
    assert calls["n"] == 2
    assert get_registry().counter("faults.node_retries").value == base + 1


def test_runtime_node_retry_exhaustion_names_node(monkeypatch):
    arr, ours, _ = _add_case(rows=16, seed=2)
    pool = apc.ArrayPool(n_arrays=2, rows=16, cols=COLS, device=CPU,
                         faults=FaultConfig(node_retries=1))
    rt = apc.Runtime(pool)
    g = apc.ProgramGraph()
    g.add(ours, rows=16, build=lambda: torch.from_numpy(arr), label="add")

    def always_fail(*a, **kw):
        raise FaultDetected("injected", block=0, array=1)

    monkeypatch.setattr(pool, "run", always_fail)
    with pytest.raises(FaultDetected) as ei:
        rt.run_graph(g)
    assert ei.value.node == 0


def test_runtime_graph_under_faults_matches_reference():
    """Two MAC graphs on a faulty bank through the runtime: results,
    APStats (with the drained fault charges) and snapshots equal the
    reference runtime's."""
    radix, K, max_abs = 3, 6, 2
    width = apc.mac_acc_width(radix, K, max_abs)
    tiled = apc.compile_mac_tiled(radix, K, width, 3)
    ref_tiled = ref_apc.compile_mac_tiled(radix, K, width, 3)
    cols = max(tiled.min_cols, 2 * width + 1) + 1
    rng = np.random.default_rng(12)
    macs = [(rng.integers(-max_abs, max_abs + 1, (r, K)),
             rng.integers(-1, 2, (r, K))) for r in (20, 9)]
    pool, ref_pool = _pools(3, 8, cols, flip_rate=5e-3, seed=3,
                            max_retries=8, retire_after=100)
    st, ref_st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    got = apc.Runtime(pool).run_mac_graph(
        [(torch.from_numpy(x), torch.from_numpy(w), tiled)
         for x, w in macs], stats=st)
    want = ref_apc.Runtime(ref_pool).run_mac_graph(
        [(jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int8), ref_tiled)
         for x, w in macs], stats=ref_st)
    for g, wnt in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(wnt))
    assert stats_fields(st) == stats_fields(ref_st)
    assert pool.fault_model.snapshot() == ref_pool.fault_model.snapshot()


def test_graph_makespan_reprices_dead_arrays_like_reference():
    from repro.apc.graph import graph_makespan as ref_makespan
    arr, ours, theirs = _add_case(rows=64, seed=3)
    g, rg = apc.ProgramGraph(), ref_apc.ProgramGraph()
    g.add(ours, rows=64, build=lambda: arr, label="add")
    rg.add(theirs, rows=64, build=lambda: arr, label="add")
    for kw in ({}, {"dead_arrays": (1, 2)}):
        rec, ref_rec = [], []
        got = apc.graph_makespan(g, n_arrays=4, rows_per_array=16,
                                 record=rec, **kw)
        assert got == ref_makespan(rg, n_arrays=4, rows_per_array=16,
                                   record=ref_rec, **kw)
        assert rec == ref_rec
    full = apc.graph_makespan(g, n_arrays=4, rows_per_array=16)
    degraded = apc.graph_makespan(g, n_arrays=4, rows_per_array=16,
                                  dead_arrays=(1, 2))
    assert degraded["n_arrays_alive"] == 2
    assert degraded["makespan_cycles"] > full["makespan_cycles"]
    with pytest.raises(ValueError, match="retired"):
        apc.graph_makespan(g, n_arrays=2, rows_per_array=16,
                           dead_arrays=(0, 1))


def test_device_pool_rejects_faults_on_mesh():
    with pytest.raises(NotImplementedError, match="host pool"):
        apc.DevicePool([CPU], n_arrays=2, rows=16, cols=COLS,
                       faults=FaultConfig())


# ---------------------------------------------------------------------------
# Resident-store recovery under churn
# ---------------------------------------------------------------------------

def _resident_case(seed):
    radix, K, max_abs = 3, 6, 3
    width = apc.mac_acc_width(radix, K, max_abs)
    tiled = apc.compile_mac_tiled(radix, K, width, 3)
    cols = max(tiled.min_cols, 2 * width + 1)
    rng = np.random.default_rng(seed)
    x = rng.integers(-max_abs, max_abs + 1, (16, K))
    w = rng.integers(-1, 2, (16, K))
    return tiled, cols, x, w, rng


def test_resident_evicted_handle_repins_and_recovers():
    tiled, cols, x, w, _ = _resident_case(8)
    w_t = torch.from_numpy(w)
    pool = apc.ArrayPool(n_arrays=2, rows=16, cols=cols, device=CPU)
    handle = pool.resident.pin("wts", apc.weight_digest(w_t),
                               lambda: apc.encode_weight_digits_jnp(w_t))
    pool.resident.clear()                  # churn: plane evicted mid-serve
    base = get_registry().counter("resident.repins").value
    acc = apc.run_mac_tiled(x, w_t, tiled, pool=pool, resident=handle)
    assert np.array_equal(acc.numpy(), (x * w).sum(axis=1))
    assert get_registry().counter("resident.repins").value == base + 1
    assert pool.resident.get("wts") is not None


def test_resident_stale_handle_repins_and_recovers():
    from repro_torch.apc.caches import ResidentStale
    tiled, cols, x, w, rng = _resident_case(9)
    w_t = torch.from_numpy(w)
    other = torch.from_numpy(rng.integers(-1, 2, (16, 6)))
    pool = apc.ArrayPool(n_arrays=2, rows=16, cols=cols, device=CPU)
    handle = pool.resident.pin("wts", apc.weight_digest(w_t),
                               lambda: apc.encode_weight_digits_jnp(w_t))
    pool.resident.pin("wts", apc.weight_digest(other),
                      lambda: apc.encode_weight_digits_jnp(other))
    with pytest.raises(ResidentStale):
        handle.resolve()
    acc = apc.run_mac_tiled(x, w_t, tiled, pool=pool, resident=handle)
    assert np.array_equal(acc.numpy(), (x * w).sum(axis=1))
    with pytest.raises(ResidentStale):
        apc.run_mac_tiled(x, w_t, tiled, pool=None, resident=handle,
                          block_rows=16, device=CPU)
