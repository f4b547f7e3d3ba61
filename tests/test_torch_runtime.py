"""The port's graph runtime (``apc/graph.py``: ``ProgramGraph``,
``graph_makespan``, ``coalesce_graphs``; ``apc/runtime.py``:
``DevicePool``, ``Runtime``) against the reference's, on the same seeded
inputs: node results, per-node counter rows, ``APStats``, makespan reports
and schedules bit-identical, and the runtime's trace the reference's.  The
port runs on ``device="cpu"``, the reference's Pallas kernel in interpret
mode; a mesh is a list of devices (a repeated ``cpu`` stands in for the
reference's forced host devices).  Mirrors ``tests/test_runtime.py`` up to
the AP layers and the runtime part of ``tests/test_trace.py``."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import apc as ref_apc
from repro.apc import graph as ref_graph
from repro.apc import trace as ref_trace
from repro.core import ap as ref_ap
from repro.kernels.ternary_matmul import ops as ref_ops

from repro_torch import apc
from repro_torch.apc import trace
from repro_torch.convert import packed_mlp_from_arrays
from repro_torch.core import ap
from repro_torch.kernels.ternary_matmul.ops import ternary_matmul

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stats_fields(s):
    return (s.radix, s.n_rows, s.n_compare_cycles, s.n_write_cycles,
            s.sets, s.resets, tuple(int(h) for h in s.mismatch_hist))


def _mac_inputs(K, max_abs, rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-max_abs, max_abs + 1, (rows, K)),
            rng.integers(-1, 2, (rows, K)))


def _pools(n_arrays, rows, cols):
    return (apc.ArrayPool(n_arrays=n_arrays, rows=rows, cols=cols,
                          device=CPU),
            ref_apc.ArrayPool(n_arrays=n_arrays, rows=rows, cols=cols))


def _tiled_pair(radix, K, width, k_tile, **kw):
    return (apc.compile_mac_tiled(radix, K, width, k_tile, **kw),
            ref_apc.compile_mac_tiled(radix, K, width, k_tile, **kw))


def _same_results(res, ref_res, n_nodes):
    for nid in range(n_nodes):
        assert np.array_equal(res[nid].numpy(), np.asarray(ref_res[nid]))
        if nid in ref_res.traced:
            assert np.array_equal(res.traced[nid].block_counts.numpy(),
                                  np.asarray(ref_res.traced[nid]
                                             .block_counts))
    assert res.report == ref_res.report
    assert res.schedule == ref_res.schedule


# ---------------------------------------------------------------------------
# Independent tiled MACs through the runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radix", [3, 5])
def test_runtime_two_macs_match_reference_and_sequential(radix):
    """Two independent tiled MACs as ONE graph: digits and APStats equal
    the reference runtime's and sequential run_mac_tiled over a pool, the
    report equals the reference's, and makespan < sequential cycles."""
    K, max_abs = 7, 3
    width = apc.mac_acc_width(radix, K, max_abs)
    tiled, ref_tiled = _tiled_pair(radix, K, width, 3)
    cols = max(tiled.min_cols, 2 * width + 1)
    macs = [_mac_inputs(K, max_abs, 23, radix),
            _mac_inputs(K, max_abs, 31, radix + 100)]
    st_seq = ap.APStats(radix=radix)
    pool_seq = apc.ArrayPool(n_arrays=2, rows=8, cols=cols, device=CPU)
    seq = [apc.run_mac_tiled(x, w, tiled, pool=pool_seq, stats=st_seq)
           for x, w in macs]
    pool, ref_pool = _pools(2, 8, cols)
    rt, ref_rt = apc.Runtime(pool), ref_apc.Runtime(ref_pool)
    st, ref_st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    digs = rt.run_mac_graph([(torch.from_numpy(x), torch.from_numpy(w),
                              tiled) for x, w in macs], stats=st)
    want = ref_rt.run_mac_graph([(jnp.asarray(x, jnp.int32),
                                  jnp.asarray(w, jnp.int8), ref_tiled)
                                 for x, w in macs], stats=ref_st)
    for d, wnt, s, (x, w) in zip(digs, want, seq, macs):
        assert np.array_equal(d.numpy(), np.asarray(wnt))
        got = apc.decode_signed_digits_jnp(d, radix)
        assert torch.equal(got, s)
        assert np.array_equal(got.numpy(), (x * w).sum(axis=1))
    assert stats_fields(st) == stats_fields(ref_st) == stats_fields(st_seq)
    assert rt.last_report == ref_rt.last_report
    assert rt.last_report["makespan_cycles"] < \
        rt.last_report["sequential_cycles"]
    assert st.n_write_cycles == 2 * tiled.n_write_cycles


def test_runtime_matmul_route_bit_exact():
    """ternary_matmul(impl='ap', runtime=) equals impl='ref' and the
    reference's runtime route bit for bit, with its report."""
    rng = np.random.default_rng(3)
    m, k, n, max_abs = 3, 24, 4, 3
    w = rng.normal(0, 0.05, (k, n)).astype(np.float32)
    packed, scale = ref_ops.quantize_and_pack(jnp.asarray(w))
    ours = packed_mlp_from_arrays({"w_packed": np.asarray(packed),
                                   "w_scale": np.asarray(scale)},
                                  device=CPU)
    op, os_ = ours["w_packed"], ours["w_scale"]
    xn = rng.integers(-max_abs, max_abs + 1, (m, k)).astype(np.float32)
    width = apc.mac_acc_width(3, packed.shape[0] * 16, max_abs)
    pool, ref_pool = _pools(2, 8, apc.mac_layout(12, width)["n_cols"])
    rt, ref_rt = apc.Runtime(pool), ref_apc.Runtime(ref_pool)
    st, ref_st = ap.APStats(radix=3), ref_ap.APStats(radix=3)
    x = torch.from_numpy(xn)
    y = ternary_matmul(x, op, os_, impl="ap", runtime=rt, stats=st)
    want = ref_ops.ternary_matmul(jnp.asarray(xn), packed, scale,
                                  impl="ap", runtime=ref_rt, stats=ref_st)
    assert np.array_equal(y.numpy(), np.asarray(want))
    assert torch.equal(y, ternary_matmul(x, op, os_, impl="ref"))
    assert stats_fields(st) == stats_fields(ref_st)
    assert rt.last_report == ref_rt.last_report
    for kw, match in (({"pool": pool}, "runtime"),
                      ({"mesh": [CPU]}, "runtime"),
                      ({"block_rows": 8}, "block_rows"),
                      ({"kernel_variant": "onehot"}, "conflicts")):
        with pytest.raises(ValueError, match=match):
            ternary_matmul(x, op, os_, impl="ap", runtime=rt, **kw)


def test_core_mac_tiled_runtime_and_pool_routes():
    x, w = _mac_inputs(6, 2, 19, 7)
    width = apc.mac_acc_width(3, 6, 2)
    cols = apc.mac_layout(2, width)["n_cols"]
    pool, ref_pool = _pools(2, 8, cols)
    rt, ref_rt = apc.Runtime(pool), ref_apc.Runtime(ref_pool)
    xj, wj = jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int8)
    st, ref_st = ap.APStats(radix=3), ref_ap.APStats(radix=3)
    got = ap.mac_tiled(x, w, 3, width, k_tile=2, runtime=rt, stats=st)
    want = ref_ap.mac_tiled(xj, wj, 3, width, k_tile=2, runtime=ref_rt,
                            stats=ref_st)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), (x * w).sum(axis=1))
    assert stats_fields(st) == stats_fields(ref_st)
    assert rt.last_report == ref_rt.last_report
    st, ref_st = ap.APStats(radix=3), ref_ap.APStats(radix=3)
    got = ap.mac_tiled(x, w, 3, width, k_tile=2, pool=pool, stats=st)
    want = ref_ap.mac_tiled(xj, wj, 3, width, k_tile=2, pool=ref_pool,
                            stats=ref_st)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert stats_fields(st) == stats_fields(ref_st)
    with pytest.raises(ValueError, match="runtime"):
        ap.mac_tiled(x, w, 3, width, k_tile=2, runtime=rt,
                     pool=apc.ArrayPool(n_arrays=1, rows=8, cols=64,
                                        device=CPU))


def test_runtime_check_knobs():
    rt = apc.Runtime(apc.ArrayPool(n_arrays=1, rows=8, cols=9, device=CPU))
    rt.check_knobs()
    rt.check_knobs(kernel_variant=apc.default_kernel_variant())
    with pytest.raises(ValueError, match="Runtime constructor"):
        rt.check_knobs(kernel_variant="onehot_packed")
    apc.Runtime(rt.pool, kernel_variant="onehot").check_knobs(
        kernel_variant="onehot")


# ---------------------------------------------------------------------------
# DevicePool: the bank spans a list of devices
# ---------------------------------------------------------------------------

def _device_mesh():
    devs = np.array(jax.devices())
    return jax.sharding.Mesh(devs.reshape(len(devs), 1), ("data", "model"))


@pytest.mark.parametrize("mesh", [[CPU], [CPU] * 3])
def test_device_pool_parity_vs_reference(mesh):
    """Digits and counter rows equal the reference's DevicePool on its
    one-device mesh (one shard) and single-array execute (any shard
    count); the wall model splits blocks over devices, then arrays."""
    r, w, rows = 3, 5, 173
    rng = np.random.default_rng(11)
    arr = ap.encode_operands(rng.integers(0, r ** w, rows),
                             rng.integers(0, r ** w, rows), r, w)
    ours = apc.compile_named("add", r, w)
    theirs = ref_apc.compile_named("add", r, w)
    pool = apc.DevicePool(mesh, n_arrays=2, rows=16, cols=2 * w + 1)
    assert pool.total_arrays == 2 * len(mesh)
    out, tr = pool.run(arr, ours, collect_stats=True)
    out_e, tr_e = apc.execute(arr, ours, collect_stats=True, device=CPU)
    assert torch.equal(out, out_e)
    assert stats_fields(apc.to_ap_stats(tr, ours, rows, r)) == \
        stats_fields(apc.to_ap_stats(tr_e, ours, rows, r))
    if len(mesh) == 1:
        ref_pool = ref_apc.DevicePool(_device_mesh(), n_arrays=2, rows=16,
                                      cols=2 * w + 1)
        want, want_tr = ref_pool.run(jnp.asarray(arr), theirs,
                                     collect_stats=True)
        assert np.array_equal(out.numpy(), np.asarray(want))
        assert np.array_equal(tr.block_counts.numpy(),
                              np.asarray(want_tr.block_counts))
        assert pool.wall_cycles(rows, 5, 7) == \
            ref_pool.wall_cycles(rows, 5, 7)
    blocks = (rows + 15) // 16
    per_dev = -(-blocks // len(mesh))
    assert pool.wall_cycles(rows, ours.n_compare_cycles,
                            ours.n_write_cycles)["waves"] == -(-per_dev // 2)
    with pytest.raises(NotImplementedError, match="block_valid"):
        pool.run(np.zeros((16 * len(mesh), 11), np.int8), ours,
                 block_valid=(16,) * len(mesh))


def test_device_pool_no_mesh_degrades_to_array_pool():
    r, w, rows = 3, 4, 37
    rng = np.random.default_rng(2)
    arr = ap.encode_operands(rng.integers(0, r ** w, rows),
                             rng.integers(0, r ** w, rows), r, w)
    compiled = apc.compile_named("add", r, w)
    pool = apc.DevicePool(None, n_arrays=3, rows=8, cols=2 * w + 1,
                          device=CPU)
    assert pool.n_devices == 1 and pool.total_arrays == 3
    out_p, tr_p = pool.run(arr, compiled, collect_stats=True,
                           block_valid=None)
    assert torch.equal(out_p, apc.execute(arr, compiled, device=CPU)[0])
    assert tr_p.block_counts.shape == (5, 10)


def test_device_pool_zero_rows_and_validation():
    compiled = apc.compile_named("add", 3, 4)
    pool = apc.DevicePool([CPU, CPU], n_arrays=1, rows=8, cols=9)
    out, tr = pool.run(np.zeros((0, 9), np.int8), compiled,
                       collect_stats=True)
    assert out.shape == (0, 9) and int(tr.sets) == 0
    with pytest.raises(ValueError, match="columns wide"):
        pool.run(np.zeros((4, 4), np.int8), compiled)
    with pytest.raises(ValueError, match="columns wide"):
        pool.validate(apc.compile_named("add", 3, 8))


def test_runtime_multidevice_subprocess():
    """The reference on four forced host devices (a (pod, data) mesh)
    against the port on ``[cpu] * 4``: ``execute_sharded`` and
    ``DevicePool.run`` give the same digits and the same summed counter
    rows, and a runtime over the four-device bank the same MAC digits,
    APStats and report."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", textwrap.dedent("""
        import numpy as np, jax, jax.numpy as jnp, torch
        from jax.sharding import Mesh
        from repro import apc as R
        from repro.core import ap as RA
        from repro_torch import apc
        from repro_torch.core import ap

        devs = np.array(jax.devices())
        assert len(devs) == 4
        mesh = Mesh(devs.reshape(2, 2, 1), ("pod", "data", "model"))
        cpus = ["cpu"] * 4
        r, w, rows = 3, 5, 133            # uneven tail across 4 shards
        rng = np.random.default_rng(5)
        arr = ap.encode_operands(rng.integers(0, r ** w, rows),
                                 rng.integers(0, r ** w, rows), r, w)
        ours, theirs = apc.compile_named("add", r, w), \\
            R.compile_named("add", r, w)

        def same(got, want):
            assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
            assert np.array_equal(got[1].block_counts.numpy(),
                                  np.asarray(want[1].block_counts))

        same(apc.execute_sharded(arr, ours, cpus, collect_stats=True,
                                 block_rows=8),
             R.execute_sharded(jnp.asarray(arr), theirs, mesh,
                               collect_stats=True, block_rows=8))
        pool = apc.DevicePool(cpus, n_arrays=2, rows=16, cols=2 * w + 1)
        rpool = R.DevicePool(mesh, n_arrays=2, rows=16, cols=2 * w + 1)
        assert pool.n_devices == rpool.n_devices == 4
        got = pool.run(arr, ours, collect_stats=True)
        same(got, rpool.run(jnp.asarray(arr), theirs, collect_stats=True))
        assert got[1].block_counts.shape == (3, 10)

        radix, K, max_abs = 3, 6, 2
        width = apc.mac_acc_width(radix, K, max_abs)
        cols = apc.mac_layout(2, width)["n_cols"]
        tiled = apc.compile_mac_tiled(radix, K, width, 2, max_cols=cols)
        rtiled = R.compile_mac_tiled(radix, K, width, 2, max_cols=cols)
        rng = np.random.default_rng(6)
        macs = [(rng.integers(-max_abs, max_abs + 1, (40 + i, K)),
                 rng.integers(-1, 2, (40 + i, K))) for i in range(2)]
        st, rst = ap.APStats(radix=radix), RA.APStats(radix=radix)
        rt = apc.Runtime(apc.DevicePool(cpus, n_arrays=2, rows=16,
                                        cols=cols))
        rrt = R.Runtime(R.DevicePool(mesh, n_arrays=2, rows=16, cols=cols))
        digs = rt.run_mac_graph([(torch.from_numpy(x), torch.from_numpy(wt),
                                  tiled) for x, wt in macs], stats=st)
        rdigs = rrt.run_mac_graph([(jnp.asarray(x, jnp.int32),
                                    jnp.asarray(wt, jnp.int8), rtiled)
                                   for x, wt in macs], stats=rst)
        for d, rd, (x, wt) in zip(digs, rdigs, macs):
            assert np.array_equal(d.numpy(), np.asarray(rd))
            assert np.array_equal(
                apc.decode_signed_digits_jnp(d, radix).numpy(),
                (x * wt).sum(axis=1))
        assert (st.sets, st.resets, st.n_write_cycles,
                st.n_compare_cycles) == (rst.sets, rst.resets,
                                         rst.n_write_cycles,
                                         rst.n_compare_cycles)
        assert np.array_equal(st.mismatch_hist, rst.mismatch_hist)
        assert rt.last_report == rrt.last_report
        assert rt.last_report["n_arrays_total"] == 8
        print("OK")
    """)], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout


# ---------------------------------------------------------------------------
# Scheduler properties: order independence on random DAGs
# ---------------------------------------------------------------------------

def _random_dag(seed, rows=21, width=4, radix=3):
    """The same random DAG of ``add`` programs for the port and the
    reference: roots hold random operand rows, a child adds its two
    dependencies' result digit blocks."""
    rng = np.random.default_rng(seed)
    compiled = apc.compile_named("add", radix, width)
    ref_compiled = ref_apc.compile_named("add", radix, width)
    graph, ref_g = apc.ProgramGraph(), ref_apc.ProgramGraph()
    n_nodes = int(rng.integers(4, 11))
    for i in range(n_nodes):
        n_deps = 0 if i < 2 else int(rng.integers(0, min(i, 2) + 1))
        if n_deps == 0:
            a = rng.integers(0, radix, (rows, 2 * width + 1)).astype(np.int8)
            a[:, -1] = 0
            graph.add(compiled, rows=rows, build=lambda _a=a:
                      torch.from_numpy(_a), result_cols=(width, 2 * width),
                      label=f"root{i}")
            ref_g.add(ref_compiled, rows=rows, build=lambda _a=a:
                      jnp.asarray(_a), result_cols=(width, 2 * width),
                      label=f"root{i}")
        else:
            deps = tuple(int(d) for d in
                         rng.choice(i, size=n_deps, replace=False))
            if n_deps == 1:
                deps = deps * 2

            def build(*parts):
                return torch.cat([parts[0], parts[1], torch.zeros(
                    (parts[0].shape[0], 1), dtype=torch.int8)], dim=1)

            def ref_build(*parts):
                return jnp.concatenate(
                    [parts[0], parts[1],
                     jnp.zeros((parts[0].shape[0], 1), jnp.int8)], axis=1)

            graph.add(compiled, rows=rows, build=build, deps=deps[:2],
                      result_cols=(width, 2 * width), label=f"n{i}")
            ref_g.add(ref_compiled, rows=rows, build=ref_build,
                      deps=deps[:2], result_cols=(width, 2 * width),
                      label=f"n{i}")
    return graph, ref_g, rng


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_runtime_random_dag_matches_reference_in_any_order(seed):
    graph, ref_g, rng = _random_dag(seed)
    n_arrays, rows = int(rng.integers(1, 4)), int(rng.integers(6, 30))
    pool, ref_pool = _pools(n_arrays, rows, 9)
    rt, ref_rt = apc.Runtime(pool), ref_apc.Runtime(ref_pool)
    st_a, st_b = ap.APStats(radix=3), ap.APStats(radix=3)
    ref_st = ref_ap.APStats(radix=3)
    res_a = rt.run_graph(graph, stats=st_a)
    _same_results(res_a, ref_rt.run_graph(ref_g, stats=ref_st), len(graph))
    order = [nid for wave in graph.wavefronts() for nid in reversed(wave)]
    res_b = rt.run_graph(graph, stats=st_b, order=order)
    for nid in range(len(graph)):
        assert torch.equal(res_a[nid], res_b[nid])
    assert stats_fields(st_a) == stats_fields(st_b) == stats_fields(ref_st)
    assert graph.wavefronts() == ref_g.wavefronts()
    assert graph.sinks() == ref_g.sinks()
    assert graph.total_cycles() == ref_g.total_cycles()
    rep = res_a.report
    assert rep["makespan_cycles"] <= rep["sequential_cycles"]
    if any(n.deps for n in graph.nodes):
        first_dep = next(i for i, n in enumerate(graph.nodes) if n.deps)
        bad = [first_dep] + [i for i in range(len(graph)) if i != first_dep]
        with pytest.raises(ValueError, match="dependencies"):
            rt.run_graph(graph, order=bad)
    with pytest.raises(ValueError, match="permutation"):
        rt.run_graph(graph, order=[0] * len(graph))


def test_graph_validation_and_wavefronts():
    compiled = apc.compile_named("add", 3, 3)
    g = apc.ProgramGraph()
    a = g.add(compiled, rows=4,
              build=lambda: torch.zeros((4, 7), dtype=torch.int8))
    with pytest.raises(ValueError, match="topological"):
        g.add(compiled, rows=4, build=lambda r: r, deps=(5,))
    with pytest.raises(ValueError, match="rows"):
        g.add(compiled, rows=-1, build=lambda: None)
    with pytest.raises(ValueError, match="upload_cycles"):
        g.add(compiled, rows=4, build=lambda: None, upload_cycles=-1)
    b = g.add(compiled, rows=4,
              build=lambda r: torch.cat(
                  [r, r, torch.zeros((4, 1), dtype=torch.int8)], dim=1),
              deps=(a,), result_cols=(3, 6))
    assert g.wavefronts() == [[a], [b]]
    assert g.sinks() == [b]
    assert g.total_cycles()["write_cycles"] == 2 * compiled.n_write_cycles
    g2 = apc.ProgramGraph()
    g2.add(compiled, rows=9,
           build=lambda: torch.zeros((4, 7), dtype=torch.int8))
    with pytest.raises(ValueError, match="declared rows"):
        apc.Runtime(apc.ArrayPool(n_arrays=1, rows=8, cols=7,
                                  device=CPU)).run_graph(g2)


def test_graph_makespan_model_matches_reference():
    """Hand-checked occupancy: two independent 1-block nodes on 2 arrays
    run in one wave, a dependent node after both; upload cycles priced;
    the reports and records are the reference's."""
    compiled = apc.compile_named("add", 3, 3)
    ref_compiled = ref_apc.compile_named("add", 3, 3)
    cyc = compiled.n_compare_cycles + compiled.n_write_cycles
    g, rg = apc.ProgramGraph(), ref_apc.ProgramGraph()
    for graph, prog in ((g, compiled), (rg, ref_compiled)):
        a = graph.add(prog, rows=4, build=lambda: None)
        b = graph.add(prog, rows=20, build=lambda: None, upload_cycles=3)
        graph.add(prog, rows=4, build=lambda r, s: None, deps=(a, b))
    for kw in ({"n_arrays": 2, "rows_per_array": 8},
               {"n_arrays": 1, "rows_per_array": 8},
               {"n_arrays": 2, "rows_per_array": 8, "n_devices": 3}):
        rec, ref_rec = [], []
        assert apc.graph_makespan(g, record=rec, **kw) == \
            ref_graph.graph_makespan(rg, record=ref_rec, **kw)
        assert rec == ref_rec
    g1 = apc.ProgramGraph()
    mk = lambda: None                                      # noqa: E731
    a = g1.add(compiled, rows=4, build=mk)
    b = g1.add(compiled, rows=4, build=mk)
    g1.add(compiled, rows=4, build=mk, deps=(a, b))
    rep = apc.graph_makespan(g1, n_arrays=2, rows_per_array=8)
    assert rep["makespan_cycles"] == 2 * cyc
    assert rep["sequential_cycles"] == 3 * cyc
    with pytest.raises(ValueError, match="geometry"):
        apc.graph_makespan(g1, n_arrays=0, rows_per_array=8)


@pytest.mark.parametrize("charge_upload", [False, True])
def test_add_mac_tiled_graph_matches_reference(charge_upload):
    """add_mac_tiled builds the reference's nodes (labels, deps, result
    columns, upload charges, meta) and a resident handle's plane gives the
    same digits as streaming."""
    radix, K, max_abs = 3, 9, 1
    width = apc.mac_acc_width(radix, K, max_abs)
    tiled, ref_tiled = _tiled_pair(radix, K, width, 1,
                                   max_cols=3 * width + 1)
    x, w = _mac_inputs(K, max_abs, 12, 5)
    g, rg = apc.ProgramGraph(), ref_apc.ProgramGraph()
    last = g.add_mac_tiled(x, w, tiled, label="m:",
                           charge_upload=charge_upload)
    ref_last = rg.add_mac_tiled(jnp.asarray(x, jnp.int32),
                                jnp.asarray(w, jnp.int8), ref_tiled,
                                label="m:", charge_upload=charge_upload)
    assert last == ref_last and g.radix == rg.radix == radix
    assert g.meta == rg.meta
    assert [(n.rows, n.deps, n.result_cols, n.label, n.upload_cycles)
            for n in g.nodes] == [(n.rows, n.deps, n.result_cols, n.label,
                                   n.upload_cycles) for n in rg.nodes]
    pool, ref_pool = _pools(2, 8, max(tiled.min_cols, 3 * width + 1))
    res = apc.Runtime(pool).run_graph(g, collect_stats=True)
    ref_res = ref_apc.Runtime(ref_pool).run_graph(rg, collect_stats=True)
    _same_results(res, ref_res, len(g))
    w4 = torch.from_numpy(w[:4])
    h = pool.resident.pin("w", apc.weight_digest(w4),
                          lambda: apc.encode_weight_digits_jnp(w4))
    g2 = apc.ProgramGraph()
    last2 = g2.add_mac_tiled(x, np.tile(w[:4], (3, 1)), tiled, resident=h)
    assert g2.nodes[0].resident_key == ("w", h.generation)
    res2 = apc.Runtime(pool).run_graph(g2)
    assert np.array_equal(
        apc.decode_signed_digits_jnp(res2[last2], radix).numpy(),
        (x * np.tile(w[:4], (3, 1))).sum(axis=1))
    with pytest.raises(ValueError, match="R_w dividing R"):
        apc.ProgramGraph().add_mac_tiled(x[:10], w[:10], tiled, resident=h)


def test_mac_fold_plan_matches_reduce_groups():
    tiled, ref_tiled = _tiled_pair(3, 9, 3, 1, max_cols=3 * 3 + 1)
    plan = apc.mac_fold_plan(tiled)
    assert [(st.parts, st.out_lo, st.out_hi) for st in plan] == \
        [(st.parts, st.out_lo, st.out_hi)
         for st in ref_apc.mac_fold_plan(ref_tiled)]
    consumed = [p for st in plan for p in st.parts if p != apc.CARRIED]
    assert sorted(consumed) == list(range(len(tiled.tiles)))
    assert apc.mac_fold_plan(apc.compile_mac_tiled(3, 4, 3, 4)) == ()


# ---------------------------------------------------------------------------
# Coalescing: row-concatenated launches with per-block valid rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [(13, 21), (8, 8, 3), (5,)])
def test_coalesced_graphs_match_standalone_and_reference(rows):
    """Many MAC graphs whose row counts are not multiples of the block
    coalesce into one graph of block_valid launches: every slice's digits
    and counter rows equal its graph run alone, and the merged run equals
    the reference's merged run."""
    radix, K, max_abs = 3, 7, 3
    width = apc.mac_acc_width(radix, K, max_abs)
    tiled, ref_tiled = _tiled_pair(radix, K, width, 3)
    cols = max(tiled.min_cols, 2 * width + 1)
    macs = [_mac_inputs(K, max_abs, r, 40 + r) for r in rows]
    graphs = [apc.ProgramGraph() for _ in macs]
    ref_graphs = [ref_apc.ProgramGraph() for _ in macs]
    finals = [g.add_mac_tiled(x, w, tiled, label=f"g{i}:")
              for i, (g, (x, w)) in enumerate(zip(graphs, macs))]
    for i, (g, (x, w)) in enumerate(zip(ref_graphs, macs)):
        g.add_mac_tiled(jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int8),
                        ref_tiled, label=f"g{i}:")
    merged, maps = apc.coalesce_graphs(graphs, block_rows=8)
    ref_merged, ref_maps = ref_graph.coalesce_graphs(ref_graphs,
                                                     block_rows=8)
    assert [{k: dataclasses.astuple(v) for k, v in m.items()}
            for m in maps] == [{k: dataclasses.astuple(v)
                                for k, v in m.items()} for m in ref_maps]
    assert [n.block_valid for n in merged.nodes] == \
        [n.block_valid for n in ref_merged.nodes]
    if len(rows) > 1:
        assert any(n.block_valid for n in merged.nodes)
    pool, ref_pool = _pools(3, 8, cols)
    rt = apc.Runtime(pool)
    st, ref_st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    res = rt.run_graph(merged, stats=st)
    ref_res = ref_apc.Runtime(ref_pool).run_graph(ref_merged, stats=ref_st)
    _same_results(res, ref_res, len(merged))
    assert stats_fields(st) == stats_fields(ref_st)
    for g, mp, fin, (x, w) in zip(graphs, maps, finals, macs):
        alone = rt.run_graph(g, collect_stats=True)
        view = apc.MergedGraphView(res, mp, alone.report)
        assert len(view) == len(g) and fin in view
        for nid in range(len(g)):
            sl = mp[nid]
            assert torch.equal(view[nid], alone[nid])
            assert torch.equal(
                res.traced[sl.node].block_counts[sl.block_lo:sl.block_hi],
                alone.traced[nid].block_counts)
        assert np.array_equal(
            apc.decode_signed_digits_jnp(view[fin], radix).numpy(),
            (x * w).sum(axis=1))
    if any(n.block_valid for n in merged.nodes):
        with pytest.raises(ValueError, match="merge once"):
            apc.coalesce_graphs([merged], block_rows=8)


# ---------------------------------------------------------------------------
# Tracing of the pool and runtime paths
# ---------------------------------------------------------------------------

def _trace_mac_inputs(seed=0, R=24, K=12):
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, size=(R, K)).astype(np.int32),
            rng.integers(-1, 2, size=(R, K)).astype(np.int32))


def test_tracing_off_is_bit_identical_across_variants():
    """Digits and APStats unchanged by the instrumentation, for every
    kernel variant, traced or not."""
    x, w = _trace_mac_inputs()
    radix, width, K = 3, 8, x.shape[1]
    outs, stats = [], []
    for traced in (False, True):
        for kv in apc.KERNEL_VARIANTS:
            st = ap.APStats(radix=radix)
            pool = apc.ArrayPool(n_arrays=2, rows=16, cols=96, device=CPU)
            tiled = apc.compile_mac_tiled(radix, K, width, 4,
                                          max_cols=pool.cols)
            guard = (trace.tracing(trace.Tracer()) if traced
                     else trace.disabled())
            with guard:
                outs.append(apc.run_mac_tiled(x, w, tiled, pool=pool,
                                              stats=st, kernel_variant=kv))
            stats.append(stats_fields(st))
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert all(s == stats[0] for s in stats[1:])


def test_attribution_sums_bit_exactly_to_ap_stats():
    x, w = _trace_mac_inputs(seed=5)
    radix, width, K = 3, 8, x.shape[1]
    st = ap.APStats(radix=radix)
    pool = apc.ArrayPool(n_arrays=2, rows=16, cols=96, device=CPU)
    tiled = apc.compile_mac_tiled(radix, K, width, 4, max_cols=pool.cols)
    t = trace.Tracer()
    with trace.tracing(t):
        apc.run_mac_tiled(x, w, tiled, pool=pool, stats=st)
    tot = t.total_ap_stats(radix)
    assert stats_fields(tot)[2:] == stats_fields(st)[2:]
    phases = t.phase_totals()
    assert set(phases) == {"pool"}
    assert phases["pool"]["programs"] == len(t.attributions)
    assert phases["pool"]["write_cycles"] == st.n_write_cycles


def test_runtime_graph_attribution_and_model_timeline():
    """The runtime's spans, model-time slices and power counter tracks
    are the reference's: same names, tracks and arguments."""
    x, w = _trace_mac_inputs(seed=9)
    radix, width, K = 3, 8, x.shape[1]
    pool, ref_pool = _pools(2, 16, 96)
    tiled, ref_tiled = _tiled_pair(radix, K, width, 4, max_cols=96)
    st, ref_st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    t, ref_t = trace.Tracer(), ref_trace.Tracer()
    with trace.tracing(t):
        apc.Runtime(pool).run_mac_graph([(x, w, tiled)], stats=st)
    with ref_trace.tracing(ref_t):
        ref_apc.Runtime(ref_pool).run_mac_graph(
            [(jnp.asarray(x), jnp.asarray(w), ref_tiled)], stats=ref_st)
    tot = t.total_ap_stats(radix)
    assert stats_fields(tot)[2:] == stats_fields(st)[2:]
    assert stats_fields(st) == stats_fields(ref_st)

    def norm(v):
        if isinstance(v, (list, tuple)):
            return tuple(norm(u) for u in v)
        if isinstance(v, (int, np.integer)):
            return int(v)
        if isinstance(v, (float, np.floating)):
            return float(v)
        return v

    def shape(tracer, mod):
        out = []
        for e in tracer.events:
            if e.name == "schedule_upload":
                continue
            args = {k: norm(v) for k, v in getattr(e, "args", {}).items()}
            if isinstance(e, mod.SpanRecord) and e.pid == mod.MODEL_PID:
                out.append(("model", e.name, e.track, e.dur_ns,
                            tuple(sorted(args.items()))))
            elif isinstance(e, mod.SpanRecord):
                out.append(("span", e.name, e.parent,
                            tuple(sorted(args.items()))))
            else:
                out.append((type(e).__name__, e.name, e.track))
        return sorted(out, key=repr)

    assert shape(t, trace) == shape(ref_t, ref_trace)
    spans = [e for e in t.events if isinstance(e, trace.SpanRecord)]
    names = {s.name for s in spans}
    assert "run_graph" in names
    assert any(n.startswith("wavefront") for n in names)
    model = [s for s in spans if s.pid == trace.MODEL_PID]
    assert any(s.track.startswith("dev") for s in model)
    assert any(s.track.startswith("arr") for s in model)
    gspan = next(s for s in spans if s.name == "run_graph")
    assert gspan.args["makespan_cycles"] <= gspan.args["sequential_cycles"]
    counters = [e for e in t.events if isinstance(e, trace.CounterRecord)]
    assert {"ap.power", "ap.power.bank"} <= {c.name for c in counters}
