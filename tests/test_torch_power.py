"""The port's power timelines (``apc/power.py``) against the reference's,
on the same seeded inputs: exact integer partitions, per-interval counters
and total energy bit-identical, the pool and graph timelines' energy equal
to the Table XI energy of the run's ``APStats``, counter-track export, and
the coalescing regressions.  The port runs on ``device="cpu"``, the
reference's Pallas kernel in interpret mode.  Mirrors the non-serve part of
``tests/test_power.py``."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import apc as ref_apc
from repro.apc import power as ref_power
from repro.apc.graph import coalesce_graphs as ref_coalesce

from repro_torch import apc
from repro_torch.apc import trace
from repro_torch.apc.graph import ProgramGraph, coalesce_graphs
from repro_torch.apc.layers import N_MASKED_MAC
from repro_torch.apc.power import (Counters, PowerAccum, PowerInterval,
                                   PowerTimeline, emit_counter_tracks,
                                   graph_power, partition_blocks, pool_power)
from repro_torch.apc.stats import HIST_BINS
from repro_torch.core import ap
from repro_torch.core.energy import energy_from_stats

CPU = "cpu"


def _mac_inputs(R=24, K=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, size=(R, K)).astype(np.int32),
            rng.integers(-1, 2, size=(R, K)).astype(np.int32))


def _rand_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 50, size=(n, 2 + HIST_BINS)).astype(np.int64)


def _intervals(tl):
    return [(iv.node, iv.label, iv.array, iv.start_ns, iv.end_ns,
             tuple(iv.counters), iv.radix, iv.n_masked)
            for iv in tl.intervals]


def test_n_masked_mac_is_the_reference_constant():
    from repro.apc.layers import N_MASKED_MAC as REF_N_MASKED_MAC
    assert N_MASKED_MAC == REF_N_MASKED_MAC == 4


# ---------------------------------------------------------------------------
# exact integer partitioning
# ---------------------------------------------------------------------------

def test_partition_blocks_consecutive_dealing():
    rows = _rand_rows(7, seed=1)
    parts = partition_blocks(torch.from_numpy(rows), [3, 1, 3])
    assert parts == [Counters.from_rows(rows[:3]),
                     Counters.from_rows(rows[3:4]),
                     Counters.from_rows(rows[4:])]
    assert [tuple(p) for p in parts] == \
        [tuple(p) for p in ref_power.partition_blocks(rows, [3, 1, 3])]
    acc = Counters.zero()
    for p in parts:
        acc = acc + p
    assert acc == Counters.from_rows(rows)


@pytest.mark.parametrize("wanted", [[1], [2, 3], [5, 1, 1], [7, 0, 2]])
def test_partition_blocks_largest_remainder_exact(wanted):
    rows = _rand_rows(4, seed=2)
    parts = partition_blocks(rows, wanted)
    assert [tuple(p) for p in parts] == \
        [tuple(p) for p in ref_power.partition_blocks(rows, wanted)]
    acc = Counters.zero()
    for p in parts:
        acc = acc + p
    assert acc == Counters.from_rows(rows)
    for w, p in zip(wanted, parts):
        if w == 0:
            assert p == Counters.zero()


def test_partition_blocks_zero_wanted_returns_zeros():
    assert partition_blocks(_rand_rows(3), [0, 0]) == \
        [Counters.zero(), Counters.zero()]


def test_counters_energy_matches_energy_from_stats():
    c = Counters.from_rows(_rand_rows(5, seed=3))
    st = ap.APStats(radix=3)
    st.sets, st.resets = c.sets, c.resets
    st.mismatch_hist[:len(c.hist)] += np.asarray(c.hist, np.int64)
    got = c.energy(3, N_MASKED_MAC).total_j
    assert got == energy_from_stats(st, N_MASKED_MAC).total_j
    assert got == ref_power.Counters(*c).energy(3, N_MASKED_MAC).total_j


# ---------------------------------------------------------------------------
# pool path: block grid join, bit-exact energy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", [(), (1,)])
def test_pool_power_bit_exact_vs_table_xi(dead):
    """One interval per block on the launch grid, the energy of the run's
    APStats bit for bit, and the reference's intervals."""
    radix, w, rows = 3, 4, 101
    rng = np.random.default_rng(7)
    arr = ap.encode_operands(rng.integers(0, radix ** w, rows),
                             rng.integers(0, radix ** w, rows), radix, w)
    compiled = apc.compile_named("add", radix, w)
    theirs = ref_apc.compile_named("add", radix, w)
    kw = {}
    if dead:
        kw = {"faults": apc.FaultConfig(dead_arrays=dead)}
    cols = 2 * w + 1 + bool(dead)
    pool = apc.ArrayPool(n_arrays=3, rows=16, cols=cols, device=CPU, **kw)
    if dead:
        kw = {"faults": ref_apc.FaultConfig(dead_arrays=dead)}
    ref_pool = ref_apc.ArrayPool(n_arrays=3, rows=16, cols=cols, **kw)
    _, traced = pool.run(arr, compiled, collect_stats=True, radix=radix)
    _, ref_traced = ref_pool.run(jnp.asarray(arr), theirs,
                                 collect_stats=True, radix=radix)
    pool.consume_fault_charges()
    st = ap.APStats(radix=radix)
    apc.accumulate(st, traced, compiled, n_rows=rows)
    tl = pool_power(pool, compiled, traced, radix=radix, n_masked=1,
                    label="add")
    ref_tl = ref_power.pool_power(ref_pool, theirs, ref_traced,
                                  radix=radix, n_masked=1, label="add")
    assert tl.total_energy_j() == energy_from_stats(st, 1).total_j
    assert tl.total_energy_j() == ref_tl.total_energy_j()
    assert _intervals(tl) == _intervals(ref_tl)
    assert len(tl.intervals) == pool.n_blocks(rows)
    p_ns = pool.program_ns(compiled)
    healthy = pool.healthy_arrays()
    for iv in tl.intervals:
        w_, a_ = divmod(iv.node, len(healthy))
        assert iv.array == healthy[a_]
        assert iv.start_ns == w_ * p_ns and iv.end_ns == (w_ + 1) * p_ns
    per = tl.per_array()
    assert set(per) == set(healthy)
    assert per[0]["track"] == "dev0/arr0"


def test_power_series_and_summary_match_reference():
    radix, w, rows = 3, 4, 64
    rng = np.random.default_rng(11)
    arr = ap.encode_operands(rng.integers(0, radix ** w, rows),
                             rng.integers(0, radix ** w, rows), radix, w)
    compiled = apc.compile_named("add", radix, w)
    pool = apc.ArrayPool(n_arrays=2, rows=16, cols=2 * w + 1, device=CPU)
    _, traced = pool.run(arr, compiled, collect_stats=True)
    tl = pool_power(pool, compiled, traced, radix=radix, n_masked=1)
    ref_tl = ref_power.PowerTimeline(
        [ref_power.PowerInterval(iv.node, iv.label, iv.array, iv.start_ns,
                                 iv.end_ns, ref_power.Counters(
                                     *iv.counters), iv.radix, iv.n_masked)
         for iv in tl.intervals], radix=radix, n_masked=1,
        n_arrays_local=pool.n_arrays)
    ser = tl.series(n_bins=32)
    binned_j = float(ser["total_w"].sum()) * ser["bin_ns"] * 1e-9
    assert binned_j == pytest.approx(tl.total_energy_j(), rel=1e-9)
    ref_ser = ref_tl.series(n_bins=32)
    assert np.array_equal(ser["total_w"], ref_ser["total_w"])
    ew = tl.ewma(window_ns=100.0, n_bins=32)
    assert 0.0 < ew["alpha"] <= 1.0
    for a, tw in ew["thermal_w"].items():
        assert tw.max() <= ser["power_w"][a].max() + 1e-12
    summ = tl.summary(threshold_w=0.0)
    assert summ == ref_tl.summary(threshold_w=0.0)
    assert summ["energy_j"] == tl.total_energy_j()
    assert summ["peak_w"] > 0 and summ["avg_w"] > 0
    assert summ["hottest_track"] in summ["per_array"]
    assert summ["time_over_threshold_ns"] > 0
    assert tl.summary(threshold_w=float("inf"))[
        "time_over_threshold_ns"] == 0.0


# ---------------------------------------------------------------------------
# runtime graph path: schedule join, bit-exact energy, counter export
# ---------------------------------------------------------------------------

def test_graph_power_bit_exact_vs_tracer_totals_and_reference():
    x, w = _mac_inputs(seed=5)
    radix, width, K = 3, 8, x.shape[1]
    pool = apc.ArrayPool(n_arrays=2, rows=16, cols=96, device=CPU)
    ref_pool = ref_apc.ArrayPool(n_arrays=2, rows=16, cols=96)
    tiled = apc.compile_mac_tiled(radix, K, width, 4, max_cols=96)
    ref_tiled = ref_apc.compile_mac_tiled(radix, K, width, 4, max_cols=96)
    g, rg = ProgramGraph(), ref_apc.ProgramGraph()
    g.add_mac_tiled(x, w, tiled, label="m0:")
    g.add_mac_tiled(x * -1, w, tiled, label="m1:")
    rg.add_mac_tiled(jnp.asarray(x), jnp.asarray(w), ref_tiled, label="m0:")
    rg.add_mac_tiled(jnp.asarray(x * -1), jnp.asarray(w), ref_tiled,
                     label="m1:")
    assert g.radix == radix
    st = ap.APStats(radix=radix)
    t = trace.Tracer()
    with trace.tracing(t):
        res = apc.Runtime(pool).run_graph(g, stats=st)
    ref_res = ref_apc.Runtime(ref_pool).run_graph(rg, collect_stats=True)
    labels = {i: n.label for i, n in enumerate(g.nodes)}
    tl = graph_power(res.schedule, res.traced, radix=radix,
                     n_masked=N_MASKED_MAC, n_arrays_local=pool.n_arrays,
                     labels=labels)
    ref_tl = ref_power.graph_power(ref_res.schedule, ref_res.traced,
                                   radix=radix, n_masked=N_MASKED_MAC,
                                   n_arrays_local=pool.n_arrays,
                                   labels=labels)
    assert tl.total_energy_j() == \
        energy_from_stats(st, N_MASKED_MAC).total_j
    assert _intervals(tl) == _intervals(ref_tl)
    tot = t.total_ap_stats(radix)
    assert energy_from_stats(tot, N_MASKED_MAC).total_j == \
        energy_from_stats(st, N_MASKED_MAC).total_j
    assert {iv.array for iv in tl.intervals} <= set(range(pool.n_arrays))
    assert any(iv.label.startswith("m1:") for iv in tl.intervals)
    counters = [e for e in t.events if isinstance(e, trace.CounterRecord)]
    assert {"ap.power", "ap.power.bank"} <= {c.name for c in counters}


def test_emit_counter_tracks_roundtrip_chrome():
    iv = [PowerInterval(node=0, label="a", array=0, start_ns=0.0,
                        end_ns=100.0, counters=Counters(10, 5, (3,) + (0,)
                        * (HIST_BINS - 1)), radix=3, n_masked=1),
          PowerInterval(node=1, label="b", array=1, start_ns=50.0,
                        end_ns=200.0, counters=Counters(7, 2, (1,) + (0,)
                        * (HIST_BINS - 1)), radix=3, n_masked=1)]
    tl = PowerTimeline(intervals=iv, radix=3, n_masked=1, n_arrays_local=2)
    t = trace.Tracer()
    n = emit_counter_tracks(t, tl, base_ns=10.0, n_bins=8)
    recs = [e for e in t.events if isinstance(e, trace.CounterRecord)]
    assert len(recs) == n
    assert {r.track for r in recs} == \
        {"power dev0/arr0", "power dev0/arr1", "power bank"}
    events = trace.validate_chrome_trace(json.loads(json.dumps(
        t.to_chrome())))
    cs = [e for e in events if e["ph"] == "C"]
    assert len(cs) == n
    for e in cs:
        assert e["pid"] == trace.MODEL_PID
        assert e["args"] and all(isinstance(v, (int, float))
                                 for v in e["args"].values())
    assert emit_counter_tracks(t, PowerTimeline([], 3, 1)) == 0


def test_power_accum_folds_timelines_exactly():
    iv0 = PowerInterval(node=0, label="", array=0, start_ns=0.0,
                        end_ns=10.0, counters=Counters(4, 4, (2,) + (0,)
                        * (HIST_BINS - 1)), radix=3, n_masked=1)
    iv1 = PowerInterval(node=0, label="", array=1, start_ns=0.0,
                        end_ns=20.0, counters=Counters(8, 1, (0,)
                        * HIST_BINS), radix=3, n_masked=1)
    tl0 = PowerTimeline([iv0], radix=3, n_masked=1, n_arrays_local=2)
    tl1 = PowerTimeline([iv0, iv1], radix=3, n_masked=1, n_arrays_local=2)
    acc = PowerAccum(radix=3, n_masked=1)
    acc.add(tl0)
    acc.add(tl1)
    want = tl0.total_counters() + tl1.total_counters()
    assert acc.total_counters() == want
    rep = acc.report()
    assert rep["energy_j"] == want.energy(3, 1).total_j
    assert rep["n_timelines"] == 2
    assert set(rep["per_array"]) == {"dev0/arr0", "dev0/arr1"}
    assert rep["peak_w"] == max(iv0.power_w, iv1.power_w)
    assert rep["per_array"]["dev0/arr0"]["busy_ns"] == 20.0


# ---------------------------------------------------------------------------
# coalescing regressions
# ---------------------------------------------------------------------------

def test_coalesce_solo_dependent_of_merged_dep_slices_rows():
    """A solo node whose dependency merged with another graph's node gets
    the slicing build wrapper: its slice starts at row 0 of the merged dep
    but is not the whole dep."""
    P = apc.compile_named("add", 3, 4)
    gA = ProgramGraph()
    a0 = gA.add(P, rows=16, build=lambda: None, label="a0")
    a1 = gA.add(P, rows=16, build=lambda d: d, deps=(a0,), label="a1")
    gB = ProgramGraph()
    gB.add(P, rows=32, build=lambda: None, label="b0")
    merged, maps = coalesce_graphs([gA, gB], block_rows=16)
    assert maps[0][a0].node == maps[1][0].node
    sl = maps[0][a1]
    assert maps[0][a0].res_lo == 0
    mnode = merged.nodes[sl.node]
    assert mnode.rows == 16
    dep = torch.arange(48 * 3, dtype=torch.int8).reshape(48, 3)
    out = mnode.build(dep)
    assert out.shape[0] == 16
    assert torch.equal(out, dep[:16])


def test_coalesce_solo_chain_keeps_original_build():
    P = apc.compile_named("add", 3, 4)
    g = ProgramGraph()

    def root():
        return torch.zeros((8, 3), dtype=torch.int8)

    def child(d):
        return d

    n0 = g.add(P, rows=8, build=root)
    n1 = g.add(P, rows=8, build=child, deps=(n0,))
    merged, maps = coalesce_graphs([g], block_rows=16)
    assert merged.nodes[maps[0][n0].node].build is root
    assert merged.nodes[maps[0][n1].node].build is child


def test_coalesce_propagates_radix_hint_and_pads_with_zeros():
    x, w = _mac_inputs(R=12, K=8, seed=1)
    tiled = apc.compile_mac_tiled(3, 8, 6, 4, max_cols=64)
    ref_tiled = ref_apc.compile_mac_tiled(3, 8, 6, 4, max_cols=64)
    g0, g1 = ProgramGraph(), ProgramGraph()
    g0.add_mac_tiled(x, w, tiled)
    g1.add_mac_tiled(x, w, tiled)
    merged, _ = coalesce_graphs([g0, g1], block_rows=16)
    assert merged.radix == 3
    r0, r1 = ref_apc.ProgramGraph(), ref_apc.ProgramGraph()
    r0.add_mac_tiled(jnp.asarray(x), jnp.asarray(w), ref_tiled)
    r1.add_mac_tiled(jnp.asarray(x), jnp.asarray(w), ref_tiled)
    ref_merged, _ = ref_coalesce([r0, r1], block_rows=16)
    built = merged.nodes[0].build()
    # both tiles of both graphs share one program: four 12-row segments,
    # each zero-padded to a 16-row block
    assert built.shape == (64, tiled.programs[0].min_cols)
    assert merged.nodes[0].block_valid == (12,) * 4
    assert np.array_equal(built.numpy(),
                          np.asarray(ref_merged.nodes[0].build()))
    assert not built.view(4, 16, -1)[:, 12:].any()
