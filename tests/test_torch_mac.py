"""The port's AP MAC (``apc/mac.py``, the fold plan, ``run_mac_tiled``,
the ``mac`` / ``mac_tiled`` drivers, ``mac_sparsity``) and the AP matmul
backend (``ternary_matmul(impl="ap")``) against the reference's, on the
same seeded inputs: schedule tensors equal array for array, encoders and
decoders equal, digits and every ``APStats`` field bit-identical.  The port
runs on the CPU (the program kernel's plain version), the reference's
Pallas kernel in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import apc as ref_apc
from repro.core import ap as ref_ap
from repro.core import build_lut_nonblocked as ref_build_lut
from repro.core import truth_tables as ref_tt
from repro.kernels.ternary_matmul import ap as ref_tap
from repro.kernels.ternary_matmul import ops as ref_ops

from repro_torch import apc
from repro_torch.apc.mac import W_MINUS, W_PLUS, W_ZERO
from repro_torch.convert import packed_mlp_from_arrays
from repro_torch.core import ap, build_lut_nonblocked
from repro_torch.core import truth_tables as tt
from repro_torch.kernels.ternary_matmul.ap import (ap_matmul_cycle_counts,
                                                   default_k_tile,
                                                   ternary_matmul_ap)
from repro_torch.kernels.ternary_matmul.ops import ternary_matmul
from repro_torch.kernels.ternary_matmul.ref import (pack_ternary,
                                                    ternary_matmul_ref)

CPU = "cpu"


def stats_fields(s):
    return (s.radix, s.n_rows, s.n_compare_cycles, s.n_write_cycles,
            s.sets, s.resets, tuple(int(h) for h in s.mismatch_hist))


def _tensors_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


def _programs_equal(ours, theirs):
    _tensors_equal(ours.schedule_tensors, theirs.schedule_tensors)
    assert (ours.n_steps, ours.n_compare_cycles, ours.n_write_cycles,
            ours.min_cols) == (theirs.n_steps, theirs.n_compare_cycles,
                               theirs.n_write_cycles, theirs.min_cols)


def _tiled_equal(ours, theirs):
    assert (ours.radix, ours.K, ours.width, ours.k_tile, ours.tiles,
            ours.reduce_groups, ours.support, ours.dense_write_cycles,
            ours.dense_compare_cycles) == (
        theirs.radix, theirs.K, theirs.width, theirs.k_tile, theirs.tiles,
        theirs.reduce_groups, theirs.support, theirs.dense_write_cycles,
        theirs.dense_compare_cycles)
    for a, b in zip(ours.programs + ours.reduce_programs,
                    theirs.programs + theirs.reduce_programs):
        _programs_equal(a, b)
    assert (ours.n_write_cycles, ours.n_compare_cycles, ours.min_cols,
            ours.n_pruned_passes) == (theirs.n_write_cycles,
                                      theirs.n_compare_cycles,
                                      theirs.min_cols,
                                      theirs.n_pruned_passes)


def _sparse(rng, shape, zero_bias=0.5):
    w = rng.integers(-1, 2, size=shape)
    w[rng.random(shape) < zero_bias] = 0
    return w


def _operands(radix, K, max_abs, rows, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-max_abs, max_abs + 1, (rows, K)),
            rng.integers(-1, 2, (rows, K)))


# ---------------------------------------------------------------------------
# Compile side: schedule tensors array for array
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radix", [3, 4])
@pytest.mark.parametrize("blk", [False, True])
def test_compile_mac_matches_reference(radix, blk):
    for K in range(1, 7):
        width = apc.mac_acc_width(radix, K, 3)
        assert width == ref_apc.mac_acc_width(radix, K, 3)
        assert apc.mac_layout(K, width) == ref_apc.mac_layout(K, width)
        _programs_equal(apc.compile_mac(radix, K, width, blocked=blk),
                        ref_apc.compile_mac(radix, K, width, blocked=blk))
    for n_parts in (2, 3, 5):
        _programs_equal(
            apc.compile_mac_reduce(radix, 4, n_parts, blocked=blk),
            ref_apc.compile_mac_reduce(radix, 4, n_parts, blocked=blk))


@pytest.mark.parametrize("radix", [3, 4])
@pytest.mark.parametrize("k_tile", [1, 2, 3])
def test_compile_mac_tiled_matches_reference(radix, k_tile):
    for K in range(1, 7):
        width = apc.mac_acc_width(radix, K, 2)
        for blk, max_cols in ((False, None), (True, None),
                              (False, 2 * width + 1 + 4 * (width + 1))):
            if max_cols is not None and apc.mac_layout(
                    min(k_tile, K), width)["n_cols"] > max_cols:
                continue
            _tiled_equal(
                apc.compile_mac_tiled(radix, K, width, k_tile, blocked=blk,
                                      max_cols=max_cols),
                ref_apc.compile_mac_tiled(radix, K, width, k_tile,
                                          blocked=blk, max_cols=max_cols))
    with pytest.raises(ValueError, match="budget"):
        apc.compile_mac_tiled(radix, 6, 3, k_tile, max_cols=7)


def test_sparse_support_compiles_like_reference():
    for radix, K, seed in ((3, 6, 0), (4, 5, 1), (3, 9, 2)):
        w = _sparse(np.random.default_rng(seed), (7, K), 0.6)
        sup = apc.mac_weight_support(w)
        assert sup == ref_apc.mac_weight_support(w)
        assert apc.weight_digest(w) == ref_apc.weight_digest(w)
        assert apc.weight_digest(torch.from_numpy(w)) == \
            ref_apc.weight_digest(w)
        width = apc.mac_acc_width(radix, K, 3)
        _programs_equal(apc.compile_mac(radix, K, width, support=sup),
                        ref_apc.compile_mac(radix, K, width, support=sup))
        for k_tile in (2, 4):
            ours = apc.compile_mac_tiled(radix, K, width, k_tile,
                                         support=sup)
            theirs = ref_apc.compile_mac_tiled(radix, K, width, k_tile,
                                               support=sup)
            _tiled_equal(ours, theirs)
            assert apc.mac_sparsity(ours) == ref_apc.mac_sparsity(theirs)


def test_support_masks_and_dense_identity():
    w = np.array([[1, 0, -1, 0], [1, 0, -1, 1]])
    assert apc.mac_weight_support(w) == (1 << W_PLUS, 1 << W_ZERO,
                                         1 << W_MINUS,
                                         (1 << W_ZERO) | (1 << W_PLUS))
    with pytest.raises(ValueError, match="ternary"):
        apc.mac_weight_support(np.array([[2, 0]]))
    with pytest.raises(ValueError, match="K axis"):
        apc.mac_weight_support(np.int8(1))
    dense = apc.compile_mac(3, 4, 6)
    sup = (apc.SUPPORT_DENSE,) * 4
    assert apc.compile_mac(3, 4, 6, support=sup) is dense
    tiled = apc.compile_mac_tiled(3, 4, 6, 2)
    assert apc.compile_mac_tiled(3, 4, 6, 2, support=sup) is tiled
    assert apc.mac_sparsity(tiled) == ref_apc.mac_sparsity(
        ref_apc.compile_mac_tiled(3, 4, 6, 2))
    with pytest.raises(ValueError, match="masks for K"):
        apc.compile_mac(3, 4, 6, support=(apc.SUPPORT_DENSE,) * 3)


def test_fold_plan_matches_reference():
    from repro.apc import graph as ref_graph
    for K, k_tile, width, max_cols in ((7, 1, 3, None), (9, 2, 2, 9),
                                      (6, 4, 3, None)):
        ours = apc.mac_fold_plan(apc.compile_mac_tiled(
            3, K, width, k_tile, max_cols=max_cols))
        theirs = ref_graph.mac_fold_plan(ref_apc.compile_mac_tiled(
            3, K, width, k_tile, max_cols=max_cols))
        assert [(s.parts, s.out_lo, s.out_hi) for s in ours] == \
            [(s.parts, s.out_lo, s.out_hi) for s in theirs]
        for a, b in zip(ours, theirs):
            _programs_equal(a.prog, b.prog)
    assert apc.CARRIED == ref_graph.CARRIED


def test_compile_caches_all_bounded_and_named_like_reference():
    from repro.apc import caches as ref_caches
    reg = apc.caches_mod.registry()
    assert set(reg) == set(ref_caches.registry())
    for name, fn in reg.items():
        assert fn.cache_info().maxsize is not None, name
    stats = apc.cache_stats()
    assert {"compile_mac", "compile_mac_reduce",
            "compile_mac_tiled"} <= set(stats)
    store = apc.ResidentStore(maxsize=1, name="mac-test")
    h = store.pin("a", "d1", lambda: torch.zeros(2))
    store.pin("b", "d2", lambda: torch.ones(2))
    with pytest.raises(apc.ResidentEvicted):
        h.resolve()
    assert apc.cache_stats()["mac-test"]["evictions"] == 1


# ---------------------------------------------------------------------------
# Encoders and decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radix", [3, 4, 5])
def test_encoders_and_decoders_match_reference(radix):
    K, max_abs, rows = 5, 6, 37
    width = apc.mac_acc_width(radix, K, max_abs)
    x, w = _operands(radix, K, max_abs, rows, radix)
    ours = apc.encode_mac_rows(x, w, radix, width)
    assert np.array_equal(ours, ref_apc.encode_mac_rows(x, w, radix, width))
    xt, wt = torch.from_numpy(x).to(torch.int32), torch.from_numpy(w)
    xj, wj = jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int8)
    dev = apc.encode_mac_rows_jnp(xt, wt, radix, width)
    assert dev.dtype == torch.int8
    assert np.array_equal(dev.numpy(), np.asarray(
        ref_apc.encode_mac_rows_jnp(xj, wj, radix, width)))
    assert np.array_equal(dev.numpy(), ours)
    assert np.array_equal(
        apc.encode_mac_x_rows_jnp(xt, radix, width).numpy(),
        np.asarray(ref_apc.encode_mac_x_rows_jnp(xj, radix, width)))
    # a decodable accumulator block: the exact dot products' digits
    acc = (x * w).sum(axis=1)
    arr = ours.copy()
    base = apc.mac_layout(K, width)["acc_base"]
    for i in range(width):
        arr[:, base + i] = (acc % radix ** width // radix ** i) % radix
    assert np.array_equal(apc.decode_mac_acc(arr, radix, K, width), acc)
    got = apc.decode_mac_acc_jnp(torch.from_numpy(arr), radix, K, width)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(
        ref_apc.decode_mac_acc_jnp(jnp.asarray(arr), radix, K, width)))
    assert np.array_equal(got.numpy(), acc)
    with pytest.raises(ValueError, match="too wide"):
        apc.decode_signed_digits_jnp(torch.zeros((1, 44), dtype=torch.int8),
                                     3)


def test_matmul_rows_and_assembly_match_reference():
    rng = np.random.default_rng(4)
    x = rng.integers(-5, 6, (3, 7))
    w = rng.integers(-1, 2, (7, 4))
    ours = apc.matmul_mac_rows(torch.from_numpy(x), torch.from_numpy(w))
    theirs = ref_apc.matmul_mac_rows(jnp.asarray(x), jnp.asarray(w))
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    before = apc.get_registry().counter("mac.weight_encodes").value
    wd = apc.encode_weight_digits_jnp(ours[1])
    assert apc.get_registry().counter("mac.weight_encodes").value == \
        before + 1
    xd = apc.encode_mac_x_rows_jnp(ours[0], 3, 4)
    assert np.array_equal(
        apc.assemble_mac_rows_jnp(xd, wd, 4).numpy(),
        np.asarray(ref_apc.assemble_mac_rows_jnp(
            jnp.asarray(xd.numpy()), jnp.asarray(wd.numpy()), 4)))
    with pytest.raises(ValueError, match="xd shape"):
        apc.assemble_mac_rows_jnp(xd[:, 1:], wd, 4)
    with pytest.raises(ValueError, match="has K="):
        apc.matmul_mac_rows(torch.from_numpy(x), torch.from_numpy(w[1:]))


def test_encode_mac_rows_validation():
    with pytest.raises(ValueError, match="ternary"):
        apc.encode_mac_rows(np.ones((2, 3), int), 2 * np.ones((2, 3), int),
                            3, 2)
    with pytest.raises(ValueError, match="shape"):
        apc.encode_mac_rows(np.ones((2, 3), int), np.ones((2, 4), int), 3, 2)
    with pytest.raises(ValueError, match="shape"):
        apc.encode_mac_rows_jnp(torch.ones((2, 3)), torch.ones((2, 4)), 3, 2)


# ---------------------------------------------------------------------------
# Execution: digits and APStats bit-identical
# ---------------------------------------------------------------------------

# the replay oracle's cost grows as K * width * r^3 passes
_ORACLE_SHAPES = {3: (4, 3), 4: (3, 2), 5: (2, 2)}     # radix -> (K, width)


@pytest.mark.parametrize("radix", [3, 4, 5])
def test_mac_driver_matches_reference(radix):
    """``mac`` with replay and with apc: digits and every APStats field
    equal each other and the reference's, and decode to x . w."""
    K, width = _ORACLE_SHAPES[radix]
    max_abs = (radix ** width - 1) // (2 * K)
    x, w = _operands(radix, K, max_abs, 61, radix * 11)
    arr = apc.encode_mac_rows(x, w, radix, width)
    ours_luts = (build_lut_nonblocked(tt.full_adder(radix)),
                 build_lut_nonblocked(tt.rev_subtractor(radix)))
    ref_luts = (ref_build_lut(ref_tt.full_adder(radix)),
                ref_build_lut(ref_tt.rev_subtractor(radix)))
    outs = []
    for engine in ("replay", "apc"):
        so, st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
        out = ap.mac(arr, *ours_luts, K, width, stats=so, engine=engine,
                     device=CPU)
        want = ref_ap.mac(jnp.asarray(arr), *ref_luts, K, width, stats=st,
                          engine=engine)
        assert np.array_equal(out.numpy(), np.asarray(want))
        assert stats_fields(so) == stats_fields(st)
        outs.append((out, stats_fields(so)))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]
    assert np.array_equal(apc.decode_mac_acc(outs[1][0].numpy(), radix, K,
                                             width), (x * w).sum(axis=1))


@pytest.mark.parametrize("radix", [3, 4, 5])
@pytest.mark.parametrize("k_tile", [1, 2, 3])
def test_run_mac_tiled_matches_untiled_and_reference(radix, k_tile):
    """Tiled partial sums + reduction equal the untiled MAC bit-for-bit and
    the reference's tiled run, counters included; tiled cycle counts are
    the exact sum of tiles + reduction."""
    K, max_abs, rows = 5, 3, 43
    width = apc.mac_acc_width(radix, K, max_abs)
    x, w = _operands(radix, K, max_abs, rows, radix * 19 + k_tile)
    want = (x * w).sum(axis=1)
    out_u, _ = apc.execute(apc.encode_mac_rows(x, w, radix, width),
                           apc.compile_mac(radix, K, width), device=CPU)
    assert np.array_equal(apc.decode_mac_acc(out_u.numpy(), radix, K,
                                             width), want)
    tiled = apc.compile_mac_tiled(radix, K, width, k_tile)
    so, st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    acc = apc.run_mac_tiled(x, w, tiled, stats=so, device=CPU)
    ref_acc = ref_apc.run_mac_tiled(
        jnp.asarray(x, jnp.int32), jnp.asarray(w, jnp.int8),
        ref_apc.compile_mac_tiled(radix, K, width, k_tile), stats=st)
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(), want)
    assert np.array_equal(acc.numpy(), np.asarray(ref_acc))
    assert stats_fields(so) == stats_fields(st)
    progs = tiled.programs + tiled.reduce_programs
    assert so.n_write_cycles == sum(p.n_write_cycles for p in progs)
    assert so.n_compare_cycles == sum(p.n_compare_cycles for p in progs)
    assert tiled.n_write_cycles == so.n_write_cycles
    if k_tile < K:
        assert len(tiled.tiles) >= 2 and tiled.reduce_programs


def test_tiled_row_work_at_least_untiled():
    """Sets/resets/histogram are per-row work: the tile programs do what
    the untiled sweeps do, and the reduction adds its own."""
    radix, K, k_tile, max_abs, rows = 3, 4, 2, 2, 29
    width = apc.mac_acc_width(radix, K, max_abs)
    x, w = _operands(radix, K, max_abs, rows, 7)
    su, stt = ap.APStats(radix=radix), ap.APStats(radix=radix)
    apc.run(apc.encode_mac_rows(x, w, radix, width),
            apc.compile_mac(radix, K, width), stats=su, device=CPU)
    acc = ap.mac_tiled(x, w, radix, width, k_tile=k_tile, stats=stt,
                       device=CPU)
    assert np.array_equal(acc.numpy(), (x * w).sum(axis=1))
    assert stt.sets >= su.sets
    assert stt.mismatch_hist.sum() >= su.mismatch_hist.sum()


@pytest.mark.parametrize("radix", [3, 4])
def test_mac_tiled_driver_matches_reference(radix):
    K, max_abs, rows, k_tile = 6, 4, 33, 4
    width = apc.mac_acc_width(radix, K, max_abs)
    x, w = _operands(radix, K, max_abs, rows, radix + 40)
    so, st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    acc = ap.mac_tiled(torch.from_numpy(x), torch.from_numpy(w), radix,
                       width, k_tile=k_tile, stats=so, blocked=True,
                       device=CPU)
    ref_acc = ref_ap.mac_tiled(jnp.asarray(x, jnp.int32),
                               jnp.asarray(w, jnp.int8), radix, width,
                               k_tile=k_tile, stats=st, blocked=True)
    assert np.array_equal(acc.numpy(), np.asarray(ref_acc))
    assert stats_fields(so) == stats_fields(st)


@pytest.mark.parametrize("radix,seed", [(3, 0), (4, 1), (5, 2)])
def test_sparse_mac_bit_parity_with_dense_and_reference(radix, seed):
    """On support-respecting data the pruned program gives the dense
    program's digits and sets/resets, and the reference's counters."""
    rng = np.random.default_rng(seed)
    K, rows = 6, 40
    width = apc.mac_acc_width(radix, K, 3)
    w = _sparse(rng, (rows, K), 0.6)
    w[:, 1] = 0                                # a whole zero column
    x = rng.integers(-3, 4, (rows, K))
    arr = apc.encode_mac_rows(x, w, radix, width)
    sup = apc.mac_weight_support(w)
    dense = apc.compile_mac(radix, K, width)
    pruned = apc.compile_mac(radix, K, width, support=sup)
    assert pruned.n_write_cycles < dense.n_write_cycles
    out_d, tr_d = apc.execute(arr, dense, collect_stats=True, device=CPU)
    out_p, tr_p = apc.execute(arr, pruned, collect_stats=True, device=CPU)
    assert torch.equal(out_d, out_p)
    sd = apc.to_ap_stats(tr_d, dense, rows, radix)
    sp = apc.to_ap_stats(tr_p, pruned, rows, radix)
    assert (sd.sets, sd.resets) == (sp.sets, sp.resets)
    want, want_tr = ref_apc.execute(
        jnp.asarray(arr), ref_apc.compile_mac(radix, K, width, support=sup),
        collect_stats=True)
    assert np.array_equal(out_p.numpy(), np.asarray(want))
    assert np.array_equal(tr_p.block_counts.numpy(),
                          np.asarray(want_tr.block_counts))


# ---------------------------------------------------------------------------
# The AP matmul backend
# ---------------------------------------------------------------------------

def _weights(k, n, seed):
    w = np.random.default_rng(seed).normal(0, 0.05, (k, n)).astype(
        np.float32)
    packed, scale = ref_ops.quantize_and_pack(jnp.asarray(w))
    ours = packed_mlp_from_arrays({"w_packed": np.asarray(packed),
                                   "w_scale": np.asarray(scale)},
                                  device=CPU)
    return (packed, scale), (ours["w_packed"], ours["w_scale"])


@pytest.mark.parametrize("radix,dtype,k_tile", [
    (3, torch.float32, None), (3, torch.bfloat16, 5),
    (4, torch.float32, 5), (5, torch.bfloat16, None)])
def test_ternary_matmul_ap_bitexact_vs_reference(radix, dtype, k_tile):
    m, k, n = 3, 16, 4
    (tp, ts), (op, os_) = _weights(k, n, radix * 7)
    x = np.random.default_rng(radix).integers(-4, 5, (m, k)).astype(
        np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    so, st = ap.APStats(radix=radix), ref_ap.APStats(radix=radix)
    ox = torch.from_numpy(x).to(dtype)
    y = ternary_matmul(ox, op, os_, impl="ap", radix=radix, stats=so,
                       k_tile=k_tile)
    want = ref_ops.ternary_matmul(jnp.asarray(x, jdt), tp, ts, impl="ap",
                                  radix=radix, stats=st, k_tile=k_tile)
    assert y.dtype == dtype
    assert np.array_equal(y.float().numpy(), np.asarray(want, np.float32))
    assert torch.equal(y, ternary_matmul_ref(ox, op, os_))
    assert stats_fields(so) == stats_fields(st)
    width = apc.mac_acc_width(radix, k, 4)
    assert so.n_write_cycles == ap_matmul_cycle_counts(
        radix, k, width, k_tile=k_tile)["write_cycles"]
    assert ap_matmul_cycle_counts(radix, k, width, k_tile=k_tile) == \
        ref_tap.ap_matmul_cycle_counts(radix, k, width, k_tile=k_tile)


def test_ternary_matmul_ap_k_padding():
    """x K smaller than packed K' (pack-time zero rows) stays exact."""
    (tp, ts), (op, os_) = _weights(19, 4, 3)
    x = np.random.default_rng(3).integers(-2, 3, (3, 19)).astype(np.float32)
    y = ternary_matmul_ap(torch.from_numpy(x), op, os_)
    assert np.array_equal(y.numpy(), np.asarray(ref_tap.ternary_matmul_ap(
        jnp.asarray(x), tp, ts)))
    assert torch.equal(y, ternary_matmul_ref(torch.from_numpy(x), op, os_))
    with pytest.raises(ValueError, match="exceeds packed"):
        ternary_matmul_ap(torch.ones((3, 40)), op, os_)


def test_ternary_matmul_ap_raises_like_reference():
    """Float activations and a too-narrow accumulator raise on both sides;
    the minimal valid width matches the reference bit for bit."""
    w_t = np.ones((16, 2), np.int8)
    half = np.full((2, 16), 0.5, np.float32)
    for fn, x, p in (
            (ternary_matmul_ap, torch.from_numpy(half),
             pack_ternary(torch.from_numpy(w_t))),
            (ref_tap.ternary_matmul_ap, jnp.asarray(half),
             ref_ops.pack_ternary(jnp.asarray(w_t)))):
        with pytest.raises(ValueError, match="integer-valued"):
            fn(x, p, p[0] * 0 + 1)
    k, n = 16, 3
    (tp, ts), (op, os_) = _weights(k, n, 9)
    x = np.random.default_rng(9).integers(-9, 10, (4, k)).astype(np.float32)
    x[0, 0] = 9.0
    req = apc.mac_acc_width(3, k, 9)
    for fn, xx, p, s in ((ternary_matmul_ap, torch.from_numpy(x), op, os_),
                         (ref_tap.ternary_matmul_ap, jnp.asarray(x), tp,
                          ts)):
        with pytest.raises(ValueError, match="mac_acc_width"):
            fn(xx, p, s, width=2)
    y = ternary_matmul_ap(torch.from_numpy(x), op, os_, width=req)
    assert np.array_equal(y.numpy(), np.asarray(
        ref_tap.ternary_matmul_ap(jnp.asarray(x), tp, ts, width=req)))


def test_unported_routes_raise_not_implemented():
    """The routes that raised NotImplementedError before the array pool
    and the graph runtime were ported now run and match the reference:
    ``ternary_matmul_ap(mesh=|pool=|runtime=)``,
    ``run_mac_tiled(pool=|resident=)`` and ``mac_tiled(pool=|runtime=)``;
    they keep the reference's ValueErrors (mesh= or runtime= with pool=,
    block_rows= with pool=, a K mismatch)."""
    (tp, ts), (op, os_) = _weights(16, 2, 1)
    xn = np.random.default_rng(1).integers(-2, 3, (2, 16)).astype(
        np.float32)
    x = torch.from_numpy(xn)
    width = apc.mac_acc_width(3, 16, 2)
    cols = apc.mac_layout(8, width)["n_cols"]
    pool = apc.ArrayPool(n_arrays=2, rows=2, cols=cols, device=CPU)
    ref_pool = ref_apc.ArrayPool(n_arrays=2, rows=2, cols=cols)
    want = ref_tap.ternary_matmul_ap(jnp.asarray(xn), tp, ts,
                                     pool=ref_pool)
    for kw in ({"mesh": [CPU, CPU]}, {"pool": pool},
               {"runtime": apc.Runtime(pool)}):
        y = ternary_matmul_ap(x, op, os_, **kw)
        assert np.array_equal(y.numpy(), np.asarray(want))
    for kw, match in (({"mesh": [CPU], "pool": pool}, "mesh"),
                      ({"runtime": apc.Runtime(pool), "pool": pool},
                       "runtime"),
                      ({"pool": pool, "block_rows": 8}, "block_rows")):
        with pytest.raises(ValueError, match=match):
            ternary_matmul_ap(x, op, os_, **kw)
    xi, wi = _operands(3, 4, 2, 3, 5)
    tiled = apc.compile_mac_tiled(3, 4, 3, 2)
    mac_pool = apc.ArrayPool(n_arrays=2, rows=2, cols=64, device=CPU)
    wi_t = torch.from_numpy(wi)
    handle = mac_pool.resident.pin("w", apc.weight_digest(wi_t),
                                   lambda: apc.encode_weight_digits_jnp(
                                       wi_t))
    for kw in ({"pool": mac_pool}, {"resident": handle, "device": CPU},
               {"pool": mac_pool, "resident": handle}):
        acc = apc.run_mac_tiled(xi, wi, tiled, **kw)
        assert np.array_equal(acc.numpy(), (xi * wi).sum(axis=1))
    for kw in ({"pool": mac_pool}, {"runtime": apc.Runtime(mac_pool)}):
        acc = ap.mac_tiled(xi, wi, 3, 3, k_tile=2, **kw)
        assert np.array_equal(acc.numpy(), (xi * wi).sum(axis=1))
    with pytest.raises(ValueError, match="runtime"):
        ap.mac_tiled(xi, wi, 3, 3, k_tile=2, pool=mac_pool,
                     runtime=apc.Runtime(mac_pool))
    with pytest.raises(ValueError, match="block_rows"):
        apc.run_mac_tiled(xi, wi, tiled, pool=mac_pool, block_rows=8)
    with pytest.raises(ValueError, match="compiled for"):
        apc.run_mac_tiled(xi[:, :3], wi[:, :3], tiled, device=CPU)


def test_mac_cycle_counts_static_and_rows_independent():
    radix, K, width = 3, 5, 4
    lut_add = build_lut_nonblocked(tt.full_adder(radix))
    lut_rsub = build_lut_nonblocked(tt.rev_subtractor(radix))
    compiled = apc.compile_mac(radix, K, width)
    want_writes = width + K * (2 + width * (lut_add.n_write_cycles
                                            + lut_rsub.n_write_cycles))
    want_compares = K * width * (lut_add.n_compare_cycles
                                 + lut_rsub.n_compare_cycles)
    assert compiled.n_write_cycles == want_writes
    assert compiled.n_compare_cycles == want_compares
    assert apc.compile_mac(radix, K, width) is compiled       # lru cache
    cyc = ap_matmul_cycle_counts(radix, K, width)
    assert cyc == ref_tap.ap_matmul_cycle_counts(radix, K, width)
    assert (cyc["write_cycles"], cyc["compare_cycles"]) == (want_writes,
                                                            want_compares)
    assert default_k_tile(650, 9) == ref_tap.default_k_tile(650, 9) == 64
    with pytest.raises(ValueError, match="column budget"):
        default_k_tile(19, 9)
