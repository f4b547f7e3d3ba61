"""The port's array pool (``apc/pool.py``: ``ArrayPool``, ``run_pooled``,
``run_mac_tiled`` with ``pool=`` and ``resident=``), its ``block_valid``
launches, ``execute_sharded`` and the AP matmul's pool route against the
reference's, on the same seeded inputs: digits, per-block counter rows,
every ``APStats`` field and the wall-cycle model bit-identical, and the
pool's trace events the reference's.  The port runs on ``device="cpu"``
(the program kernel's plain version), the reference's Pallas kernel in
interpret mode.  Mirrors ``tests/test_pool.py``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import apc as ref_apc
from repro.apc import trace as ref_trace
from repro.core import ap as ref_ap
from repro.kernels.ternary_matmul import ap as ref_tap
from repro.kernels.ternary_matmul import ops as ref_ops
from repro.launch.mesh import make_smoke_mesh

from repro_torch import apc
from repro_torch.apc import trace
from repro_torch.convert import packed_mlp_from_arrays
from repro_torch.core import ap
from repro_torch.kernels.tap_pass import ref
from repro_torch.kernels.ternary_matmul.ap import (ap_matmul_cycle_counts,
                                                   default_k_tile,
                                                   ternary_matmul_ap)
from repro_torch.kernels.ternary_matmul.ops import ternary_matmul

CPU = "cpu"


def stats_fields(s):
    return (s.radix, s.n_rows, s.n_compare_cycles, s.n_write_cycles,
            s.sets, s.resets, tuple(int(h) for h in s.mismatch_hist))


def _pools(n_arrays, rows, cols, **kw):
    return (apc.ArrayPool(n_arrays=n_arrays, rows=rows, cols=cols,
                          device=CPU, **kw),
            ref_apc.ArrayPool(n_arrays=n_arrays, rows=rows, cols=cols, **kw))


def _add_operands(radix, width, rows, seed):
    rng = np.random.default_rng(seed)
    return ap.encode_operands(rng.integers(0, radix ** width, rows),
                              rng.integers(0, radix ** width, rows), radix,
                              width)


def _mac_operands(radix, K, max_abs, rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-max_abs, max_abs + 1, (rows, K)),
            rng.integers(-1, 2, (rows, K)))


def _same_run(ours, theirs):
    """(digits, traced) of the port and of the reference are equal."""
    (out, tr), (want, want_tr) = ours, theirs
    assert out.dtype == torch.int8 and out.device.type == "cpu"
    assert np.array_equal(out.numpy(), np.asarray(want))
    if want_tr is None:
        assert tr is None
    else:
        assert np.array_equal(tr.block_counts.numpy(),
                              np.asarray(want_tr.block_counts))


def _weights(k, n, seed):
    w = np.random.default_rng(seed).normal(0, 0.05, (k, n)).astype(
        np.float32)
    packed, scale = ref_ops.quantize_and_pack(jnp.asarray(w))
    ours = packed_mlp_from_arrays({"w_packed": np.asarray(packed),
                                   "w_scale": np.asarray(scale)},
                                  device=CPU)
    return (packed, scale), (ours["w_packed"], ours["w_scale"])


# ---------------------------------------------------------------------------
# ArrayPool vs the reference's: bit parity across the grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radix", [3, 4, 5])
@pytest.mark.parametrize("n_arrays,pool_rows", [(1, 64), (2, 32), (3, 16)])
def test_pool_parity_vs_reference(radix, n_arrays, pool_rows):
    """Named add program over 101 rows (blocks of 64/32/16 + a tail): the
    same digits, the same counter row per block, the same APStats and the
    same pipelined wall cycles as the reference's pool, and equal to
    single-array execute."""
    w, rows = 4, 101
    arr = _add_operands(radix, w, rows, radix * 13 + n_arrays)
    ours = apc.compile_named("add", radix, w)
    theirs = ref_apc.compile_named("add", radix, w)
    pool, ref_pool = _pools(n_arrays, pool_rows, 2 * w + 1)
    got = pool.run(arr, ours, collect_stats=True)
    _same_run(got, ref_pool.run(jnp.asarray(arr), theirs,
                                collect_stats=True))
    assert got[1].block_counts.shape == (pool.n_blocks(rows), 10)
    out_e, tr_e = apc.execute(arr, ours, collect_stats=True, device=CPU)
    assert torch.equal(got[0], out_e)
    assert stats_fields(apc.to_ap_stats(got[1], ours, rows, radix)) == \
        stats_fields(apc.to_ap_stats(tr_e, ours, rows, radix))
    for n in (1, rows, 7 * pool_rows + 1):
        assert pool.wall_cycles(n, ours.n_compare_cycles,
                                ours.n_write_cycles) == \
            ref_pool.wall_cycles(n, theirs.n_compare_cycles,
                                 theirs.n_write_cycles)
    assert pool.program_ns(ours) == ref_pool.program_ns(theirs)
    assert pool.block_intervals(7, ours) == \
        ref_pool.block_intervals(7, theirs)


@pytest.mark.parametrize("kv", ["gather", "onehot_packed"])
def test_pool_variants_empty_batch_and_schedule_reuse(kv):
    """Every schedule form gives the reference's rows; the schedule is
    uploaded once per (program, variant) and the same tensors reach every
    launch; an empty batch launches nothing."""
    arr = _add_operands(3, 3, 40, 2)
    ours = apc.compile_named("add", 3, 3, blocked=True)
    theirs = ref_apc.compile_named("add", 3, 3, blocked=True)
    pool, ref_pool = _pools(2, 16, 7, kernel_variant=kv)
    for _ in range(2):
        _same_run(pool.run(arr, ours, collect_stats=True),
                  ref_pool.run(jnp.asarray(arr), theirs,
                               collect_stats=True))
    assert len(pool._schedules) == 1
    (_, sched, _, _), = pool._schedules.values()
    assert pool._device_schedule(ours)[0] is sched
    out, tr = pool.run(np.zeros((0, 7), np.int8), ours, collect_stats=True)
    assert out.shape == (0, 7) and tr.block_counts.shape == (1, 10)
    assert int(tr.block_counts.abs().sum()) == 0


@pytest.mark.parametrize("block_valid", [(5, 16, 3), (16,), (1, 1, 16, 9)])
def test_pool_block_valid_matches_reference(block_valid):
    """A row-concatenated launch: padding in the middle of the array is
    masked per block and the output compacted to the valid rows, as the
    reference's pool does."""
    radix, w, block = 3, 4, 16
    rows = block * len(block_valid)
    arr = np.random.default_rng(len(block_valid)).integers(
        0, radix, (rows, 2 * w + 1)).astype(np.int8)
    ours = apc.compile_named("add", radix, w)
    theirs = ref_apc.compile_named("add", radix, w)
    pool, ref_pool = _pools(3, block, 2 * w + 1)
    got = pool.run(arr, ours, collect_stats=True, block_valid=block_valid)
    _same_run(got, ref_pool.run(jnp.asarray(arr), theirs,
                                collect_stats=True,
                                block_valid=block_valid))
    assert got[0].shape[0] == sum(block_valid)
    # each segment alone gives its own rows and counter row
    for b, valid in enumerate(block_valid):
        seg = arr[b * block:b * block + valid]
        out, tr = pool.run(seg, ours, collect_stats=True)
        lo = sum(block_valid[:b])
        assert torch.equal(out, got[0][lo:lo + valid])
        assert torch.equal(tr.block_counts[0], got[1].block_counts[b])
    assert len(pool._masks) == 1


def test_pool_block_valid_rejects_like_reference():
    ours = apc.compile_named("add", 3, 4)
    theirs = ref_apc.compile_named("add", 3, 4)
    pool, ref_pool = _pools(2, 16, 9)
    for rows, bv, match in ((24, (16, 8), "whole"), (32, (16,), "entries"),
                            (32, (0, 16), "in \\[1, 16\\]"),
                            (32, (16, 17), "in \\[1, 16\\]")):
        arr = np.zeros((rows, 9), np.int8)
        with pytest.raises(ValueError, match=match):
            pool.run(arr, ours, block_valid=bv)
        with pytest.raises(ValueError, match=match):
            ref_pool.run(jnp.asarray(arr), theirs, block_valid=bv)


@pytest.mark.parametrize("pack_kv", ["gather", "onehot_packed"])
@pytest.mark.parametrize("block_valid", [(8, 3, 1), (8, 8), (2,)])
@pytest.mark.parametrize("stats", [True, False])
def test_run_program_plain_block_valid_vs_reference_pool(pack_kv,
                                                         block_valid, stats):
    """The plain version of the program kernel with ``block_valid`` gives
    the reference pool's digits (padding rows as they were read) and
    counter rows, on raw digits (don't-care and out-of-range cells
    included)."""
    block, radix = 8, 3
    ours = apc.compile_named("sub", radix, 3, blocked=True)
    theirs = ref_apc.compile_named("sub", radix, 3, blocked=True)
    rows = block * len(block_valid)
    arr = np.random.default_rng(rows).integers(
        -1, radix + 1, (rows, ours.min_cols)).astype(np.int8)
    sched, _, pack, _ = apc.resolve_schedule(ours, pack_kv)
    out, counts = ref.run_program_plain(
        torch.from_numpy(arr), *sched, 0, block_rows=block,
        collect_stats=stats, pack=pack, block_valid=block_valid)
    ref_pool = ref_apc.ArrayPool(n_arrays=2, rows=block,
                                 cols=ours.min_cols)
    want, want_tr = ref_pool.run(jnp.asarray(arr), theirs,
                                 collect_stats=stats,
                                 kernel_variant=pack_kv,
                                 block_valid=block_valid)
    keep = np.concatenate([np.arange(b * block, b * block + v)
                           for b, v in enumerate(block_valid)])
    assert np.array_equal(out.numpy()[keep], np.asarray(want))
    pad = np.setdiff1d(np.arange(rows), keep)
    assert np.array_equal(out.numpy()[pad], arr[pad])
    if stats:
        assert np.array_equal(counts.numpy(),
                              np.asarray(want_tr.block_counts))
    else:
        assert counts is None
    with pytest.raises(ValueError, match="counts for"):
        ref.run_program_plain(torch.from_numpy(arr), *sched, 0,
                              block_rows=block, pack=pack,
                              block_valid=block_valid + (1,))


def test_pool_trace_events_match_reference():
    """``pool.run`` under a tracer emits the reference's events: the run
    span, one span per wave, one launch instant per block and the block
    model spans on ``arr{a}`` tracks, with the same arguments; the
    registry counts blocks as launches."""
    arr = _add_operands(3, 3, 70, 4)
    ours = apc.compile_named("add", 3, 3)
    theirs = ref_apc.compile_named("add", 3, 3)
    pool, ref_pool = _pools(3, 16, 7)

    def events(tracer, pool_, arr_, prog):
        with tracer.tracing(tracer.Tracer()) as t:
            pool_.run(arr_, prog, collect_stats=True)
        return sorted((type(e).__name__, e.name, e.track,
                       tuple(sorted(e.args.items())))
                      for e in t.events if e.name != "schedule_upload")

    base = apc.get_registry().counter("pool.launches").value
    got = events(trace, pool, arr, ours)
    assert apc.get_registry().counter("pool.launches").value == base + 5
    want = events(ref_trace, ref_pool, jnp.asarray(arr), theirs)
    assert got == want
    names = [e[1] for e in got]
    assert names.count("launch") == 5 and "wave1" in names
    assert "block4" in names and "pool.run" in names


# ---------------------------------------------------------------------------
# run_mac_tiled over a pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radix", [3, 4, 5])
@pytest.mark.parametrize("k_tile", [1, 2, 3])
def test_pool_tiled_mac_parity_vs_reference(radix, k_tile):
    """Tiled partial sums + reduction through a 2-array pool: the signed
    dot products and every APStats field the reference's, with cycle
    counts the exact sum of the tile and reduction programs."""
    K, max_abs, rows = 5, 3, 43
    width = apc.mac_acc_width(radix, K, max_abs)
    x, w = _mac_operands(radix, K, max_abs, rows, radix * 19 + k_tile)
    cols = max(apc.mac_layout(min(k_tile, K), width)["n_cols"],
               2 * width + 1)
    pool, ref_pool = _pools(2, 16, cols)
    tiled = apc.compile_mac_tiled(radix, K, width, k_tile,
                                  max_cols=pool.cols)
    ref_tiled = ref_apc.compile_mac_tiled(radix, K, width, k_tile,
                                          max_cols=ref_pool.cols)
    st, ref_st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    acc = apc.run_mac_tiled(x, w, tiled, pool=pool, stats=st)
    want = ref_apc.run_mac_tiled(jnp.asarray(x, jnp.int32),
                                 jnp.asarray(w, jnp.int8), ref_tiled,
                                 pool=ref_pool, stats=ref_st)
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(), np.asarray(want))
    assert np.array_equal(acc.numpy(), (x * w).sum(axis=1))
    assert stats_fields(st) == stats_fields(ref_st)
    progs = tiled.programs + tiled.reduce_programs
    assert st.n_write_cycles == sum(p.n_write_cycles for p in progs)
    if k_tile < K:
        assert len(tiled.tiles) >= 2 and tiled.reduce_programs


def test_pool_tiled_mac_stats_match_untiled_rowwork():
    """Without a pool the tiled programs run on the executor; their row
    work matches the reference's and bounds the untiled MAC's."""
    radix, K, k_tile, max_abs, rows = 3, 4, 2, 2, 29
    width = apc.mac_acc_width(radix, K, max_abs)
    x, w = _mac_operands(radix, K, max_abs, rows, 7)
    su, stt = ap.APStats(radix=radix), ap.APStats(radix=radix)
    ref_stt = ref_ap.APStats(radix=radix)
    arr = apc.encode_mac_rows(x, w, radix, width)
    out_u = apc.run(arr, apc.compile_mac(radix, K, width), stats=su,
                    device=CPU)
    acc = apc.run_mac_tiled(x, w, apc.compile_mac_tiled(radix, K, width,
                                                        k_tile),
                            stats=stt, device=CPU)
    want = ref_apc.run_mac_tiled(
        jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int8),
        ref_apc.compile_mac_tiled(radix, K, width, k_tile), stats=ref_stt)
    assert np.array_equal(acc.numpy(), np.asarray(want))
    assert np.array_equal(
        apc.decode_mac_acc_jnp(out_u, radix, K, width).numpy(),
        (x * w).sum(axis=1))
    assert stats_fields(stt) == stats_fields(ref_stt)
    assert stt.sets >= su.sets
    assert stt.mismatch_hist.sum() >= su.mismatch_hist.sum()


def test_pool_column_budget_enforced_like_reference():
    compiled = apc.compile_mac(3, 8, 3)          # needs 8*4+4 = 36 cols
    pool, ref_pool = _pools(2, 8, 16)
    for p, prog, zeros in (
            (pool, compiled, np.zeros),
            (ref_pool, ref_apc.compile_mac(3, 8, 3), jnp.zeros)):
        with pytest.raises(ValueError, match="tiled"):
            p.run(zeros((4, 36), np.int8), prog)
    small, ref_small = apc.compile_named("add", 3, 2), \
        ref_apc.compile_named("add", 3, 2)
    with pytest.raises(ValueError, match="digit columns"):
        pool.run(np.zeros((4, 30), np.int8), small)
    with pytest.raises(ValueError, match="digit columns"):
        ref_pool.run(jnp.zeros((4, 30), jnp.int8), ref_small)
    with pytest.raises(ValueError, match="n_arrays"):
        apc.ArrayPool(n_arrays=0, device=CPU)
    with pytest.raises(ValueError, match="positive"):
        apc.ArrayPool(rows=0, device=CPU)


def test_pool_validate_up_front_names_width():
    """run/run_pooled/run_mac_tiled reject an over-wide program before any
    schedule upload or launch, naming the program width."""
    compiled = apc.compile_mac(3, 8, 3)          # 36-column MAC row
    pool = apc.ArrayPool(n_arrays=1, rows=8, cols=16, device=CPU)
    with pytest.raises(ValueError, match="36 columns wide"):
        apc.run_pooled(np.zeros((4, 36), np.int8), compiled, pool)
    with pytest.raises(ValueError, match="36 columns wide"):
        pool.run(np.zeros((4, 36), np.int8), compiled)
    assert len(pool._schedules) == 0             # nothing was uploaded
    tiled = apc.compile_mac_tiled(3, 8, 3, 4)    # 20-column tile rows
    with pytest.raises(ValueError, match="columns wide"):
        apc.run_mac_tiled(np.zeros((4, 8), np.int32),
                          np.zeros((4, 8), np.int8), tiled, pool=pool)
    apc.ArrayPool(n_arrays=1, rows=8, cols=36,
                  device=CPU).validate(compiled, n_cols=36)


def test_pool_reduce_plan_chains_under_budget():
    radix, K, k_tile, max_abs, rows = 3, 9, 1, 1, 17
    width = apc.mac_acc_width(radix, K, max_abs)
    max_cols = 3 * width + 1                        # only 3 partials per row
    tiled = apc.compile_mac_tiled(radix, K, width, k_tile,
                                  max_cols=max_cols)
    assert len(tiled.reduce_groups) > 1
    x, w = _mac_operands(radix, K, max_abs, rows, 23)
    pool = apc.ArrayPool(n_arrays=2, rows=8, cols=max(max_cols,
                                                      tiled.min_cols),
                         device=CPU)
    acc = apc.run_mac_tiled(x, w, tiled, pool=pool)
    want = ref_apc.run_mac_tiled(
        jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int8),
        ref_apc.compile_mac_tiled(radix, K, width, k_tile,
                                  max_cols=max_cols))
    assert np.array_equal(acc.numpy(), np.asarray(want))
    assert np.array_equal(acc.numpy(), (x * w).sum(axis=1))


def test_pool_run_mac_tiled_rejects_like_reference():
    """The reference's ValueErrors: a K mismatch, and block_rows= with
    pool=."""
    tiled = apc.compile_mac_tiled(3, 4, 3, 2)
    ref_tiled = ref_apc.compile_mac_tiled(3, 4, 3, 2)
    pool, ref_pool = _pools(1, 8, 64)
    port_run = functools.partial(apc.run_mac_tiled, device=CPU)
    for fn, t, p, z in ((port_run, tiled, pool, np.zeros),
                        (ref_apc.run_mac_tiled, ref_tiled, ref_pool,
                         jnp.zeros)):
        with pytest.raises(ValueError, match="K="):
            fn(z((2, 5), np.int32), z((2, 5), np.int8), t)
        with pytest.raises(ValueError, match="block_rows"):
            fn(z((2, 4), np.int32), z((2, 4), np.int8), t, pool=p,
               block_rows=8)


@pytest.mark.parametrize("auto", [False, True])
def test_pool_resident_plane_matches_reference(auto, monkeypatch):
    """Weight-stationary: a pinned plane (row-tiled up to R) or the
    REPRO_AP_RESIDENT auto-pin gives the reference's dot products and
    APStats, with one weight encode for two calls."""
    if auto:
        monkeypatch.setenv("REPRO_AP_RESIDENT", "1")
    else:
        monkeypatch.delenv("REPRO_AP_RESIDENT", raising=False)
    assert apc.resident_enabled() == auto
    radix, K, max_abs = 3, 6, 3
    width = apc.mac_acc_width(radix, K, max_abs)
    tiled = apc.compile_mac_tiled(radix, K, width, 3)
    ref_tiled = ref_apc.compile_mac_tiled(radix, K, width, 3)
    cols = max(tiled.min_cols, 2 * width + 1)
    x, _ = _mac_operands(radix, K, max_abs, 16, 3)
    w4 = np.random.default_rng(4).integers(-1, 2, (4, K))
    w = np.tile(w4, (4, 1))
    pool, ref_pool = _pools(2, 8, cols)
    handle = None
    if not auto:
        w4_t = torch.from_numpy(w4)
        handle = pool.resident.pin("w4", apc.weight_digest(w4_t),
                                   lambda: apc.encode_weight_digits_jnp(
                                       w4_t))
    encodes = apc.get_registry().counter("mac.weight_encodes")
    before = encodes.value
    for _ in range(2):
        st, ref_st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
        acc = apc.run_mac_tiled(x, w, tiled, pool=pool, stats=st,
                                resident=handle)
        want = ref_apc.run_mac_tiled(jnp.asarray(x, jnp.int32),
                                     jnp.asarray(w, jnp.int8), ref_tiled,
                                     pool=ref_pool, stats=ref_st)
        assert np.array_equal(acc.numpy(), np.asarray(want))
        assert stats_fields(st) == stats_fields(ref_st)
    assert encodes.value - before == (1 if auto else 0)


# ---------------------------------------------------------------------------
# ternary_matmul(impl="ap") through the pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radix", [3, 4, 5])
def test_ternary_matmul_ap_pool_two_tiles_two_arrays(radix):
    """Column budget forcing >= 2 K-tiles over >= 2 arrays: bit-exact vs
    impl="ref" and vs the reference's pool route, with the reference's
    APStats and ``ap_matmul_cycle_counts``' cycles."""
    rng = np.random.default_rng(radix * 31)
    m, k, n, max_abs = 3, 24, 4, 3
    (tp, ts), (op, os_) = _weights(k, n, radix * 31)
    kp = op.shape[0] * 16
    xn = rng.integers(-max_abs, max_abs + 1, (m, k)).astype(np.float32)
    width = apc.mac_acc_width(radix, kp, max_abs)
    cols = apc.mac_layout(12, width)["n_cols"]
    pool, ref_pool = _pools(2, 8, cols)
    st, ref_st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    y = ternary_matmul(torch.from_numpy(xn), op, os_, impl="ap",
                       radix=radix, pool=pool, stats=st)
    want = ref_ops.ternary_matmul(jnp.asarray(xn), tp, ts, impl="ap",
                                  radix=radix, pool=ref_pool, stats=ref_st)
    assert np.array_equal(y.numpy(), np.asarray(want))
    assert torch.equal(y, ternary_matmul(torch.from_numpy(xn), op, os_,
                                         impl="ref"))
    assert stats_fields(st) == stats_fields(ref_st)
    cyc = ap_matmul_cycle_counts(radix, kp, width,
                                 k_tile=default_k_tile(cols, width))
    assert cyc["n_tiles"] >= 2
    assert (st.n_write_cycles, st.n_compare_cycles) == \
        (cyc["write_cycles"], cyc["compare_cycles"])
    assert pool.n_blocks(m * n) == 2


def test_ternary_matmul_ap_pool_rejects_like_reference():
    """An oversized k_tile, mesh= with pool=, and block_rows= with pool=
    raise on both sides."""
    (tp, ts), (op, os_) = _weights(16, 2, 6)
    xn = np.random.default_rng(6).integers(-2, 3, (2, 16)).astype(
        np.float32)
    width = apc.mac_acc_width(3, 16, 2)
    cols = apc.mac_layout(4, width)["n_cols"]
    pool, ref_pool = _pools(2, 8, cols)
    for fn, x, p, s, pl in (
            (ternary_matmul_ap, torch.from_numpy(xn), op, os_, pool),
            (ref_tap.ternary_matmul_ap, jnp.asarray(xn), tp, ts,
             ref_pool)):
        with pytest.raises(ValueError, match="k_tile"):
            fn(x, p, s, pool=pl, k_tile=16)
        with pytest.raises(ValueError, match="mesh"):
            fn(x, p, s, pool=pl, mesh=[CPU])
        with pytest.raises(ValueError, match="block_rows"):
            fn(x, p, s, pool=pl, block_rows=8)


# ---------------------------------------------------------------------------
# apc.run(pool=) and the drivers' pool=
# ---------------------------------------------------------------------------

def test_run_pool_route_and_driver_pool_match_reference():
    """``apc.run(pool=)`` and a driver's ``pool=`` (engine="apc") give the
    reference's digits and APStats; ``mesh=`` with ``pool=`` and
    ``block_rows=`` with ``pool=`` raise its ValueErrors."""
    from repro.core import build_lut_nonblocked as ref_build_lut
    from repro.core import truth_tables as ref_tt
    from repro_torch.core import build_lut_nonblocked
    from repro_torch.core import truth_tables as tt
    arr = _add_operands(3, 4, 50, 8)
    ours = apc.compile_named("add", 3, 4)
    theirs = ref_apc.compile_named("add", 3, 4)
    pool, ref_pool = _pools(2, 16, 9)
    st, ref_st = ap.APStats(radix=3), ref_ap.APStats(radix=3)
    out = apc.run(arr, ours, stats=st, pool=pool)
    want = ref_apc.run(jnp.asarray(arr), theirs, stats=ref_st,
                       pool=ref_pool)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert stats_fields(st) == stats_fields(ref_st)
    st, ref_st = ap.APStats(radix=3), ref_ap.APStats(radix=3)
    out = ap.ripple_add(arr, build_lut_nonblocked(tt.full_adder(3)), 4, 8,
                        stats=st, engine="apc", pool=pool, device=CPU)
    want = ref_ap.ripple_add(jnp.asarray(arr),
                             ref_build_lut(ref_tt.full_adder(3)), 4, 8,
                             stats=ref_st, engine="apc", pool=ref_pool)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert stats_fields(st) == stats_fields(ref_st)
    for fn, a, prog, p in ((apc.run, arr, ours, pool),
                           (ref_apc.run, jnp.asarray(arr), theirs,
                            ref_pool)):
        with pytest.raises(ValueError, match="mesh= or pool="):
            fn(a, prog, pool=p, mesh=object())
        with pytest.raises(ValueError, match="block_rows"):
            fn(a, prog, pool=p, block_rows=16)


# ---------------------------------------------------------------------------
# execute_sharded / run(mesh=)
# ---------------------------------------------------------------------------

def test_mac_sharded_matches_local():
    """The reference's ``test_mac_sharded_matches_local``: a one-device
    mesh; the port's mesh is ``[cpu]``.  Digits and counter rows equal the
    reference's sharded run and the local one."""
    radix, K, width = 3, 4, 3
    rng = np.random.default_rng(17)
    x = rng.integers(-3, 4, (120, K))
    w = rng.integers(-1, 2, (120, K))
    arr = apc.encode_mac_rows(x, w, radix, width)
    ours, theirs = apc.compile_mac(radix, K, width), \
        ref_apc.compile_mac(radix, K, width)
    got = apc.execute_sharded(arr, ours, [CPU], collect_stats=True,
                              block_rows=64)
    _same_run(got, ref_apc.execute_sharded(
        jnp.asarray(arr), theirs, make_smoke_mesh(), collect_stats=True,
        block_rows=64))
    out_l, tr_l = apc.execute(arr, ours, collect_stats=True, block_rows=64,
                              device=CPU)
    assert torch.equal(got[0], out_l)
    assert stats_fields(apc.to_ap_stats(got[1], ours, 120, radix)) == \
        stats_fields(apc.to_ap_stats(tr_l, ours, 120, radix))


@pytest.mark.parametrize("n_shards,rows", [(2, 37), (4, 130), (3, 5)])
def test_execute_sharded_repeated_device_sums_counters(n_shards, rows):
    """A mesh of one device repeated: each shard masks its own tail by its
    global row offset, and the counter tensor is the elementwise sum of
    the shards' (blocks per shard rows), equal in total to a local run."""
    arr = _add_operands(3, 4, rows, n_shards)
    compiled = apc.compile_named("add", 3, 4)
    out, tr = apc.execute_sharded(arr, compiled, [CPU] * n_shards,
                                  collect_stats=True, block_rows=8)
    out_l, tr_l = apc.execute(arr, compiled, collect_stats=True,
                              block_rows=8, device=CPU)
    assert torch.equal(out, out_l)
    shard_blocks = -(-rows // (8 * n_shards))
    assert tr.block_counts.shape == (shard_blocks, 10)
    padded = np.concatenate([tr_l.block_counts.numpy(), np.zeros(
        (shard_blocks * n_shards - tr_l.block_counts.shape[0], 10),
        np.int32)])
    assert np.array_equal(tr.block_counts.numpy(),
                          padded.reshape(n_shards, shard_blocks, 10)
                          .sum(axis=0))
    st = ap.APStats(radix=3)
    assert torch.equal(apc.run(arr, compiled, stats=st, mesh=[CPU, CPU]),
                       out_l)
    assert stats_fields(st) == stats_fields(
        apc.to_ap_stats(tr_l, compiled, rows, 3))
    out, tr = apc.execute_sharded(np.zeros((0, 9), np.int8), compiled,
                                  [CPU] * n_shards, collect_stats=True)
    assert out.shape == (0, 9) and int(tr.block_counts.abs().sum()) == 0
    with pytest.raises(ValueError, match="at least one device"):
        apc.execute_sharded(arr, compiled, [])
