"""The port's fused executor (``apc.execute`` / ``apc.run``) against the
reference's on the same seeded inputs: digits, per-block counter rows and
every ``APStats`` field bit-identical.  The port runs on ``device="cpu"``
(the kernels' plain versions), the reference in Pallas interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import apc as ref_apc
from repro.core import ap as ref_ap

from repro_torch import apc
from repro_torch.convert import ap_stats_from_fields, compiled_from_arrays
from repro_torch.core import ap


def stats_fields(s):
    return (s.radix, s.n_rows, s.n_compare_cycles, s.n_write_cycles,
            s.sets, s.resets, tuple(int(h) for h in s.mismatch_hist))


def _operands(fn, radix, width, rows, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, radix ** width, rows)
    b = rng.integers(0, radix ** width, rows)
    if fn == "mul":
        arr = np.zeros((rows, 5 * width + 1), np.int8)
        for i in range(width):
            arr[:, i] = arr[:, width + i] = (a // radix ** i) % radix
            arr[:, 2 * width + i] = (b // radix ** i) % radix
        return arr
    extra = 0 if fn in ("min", "max", "modsum", "nor", "nand") else 1
    return ap.encode_operands(a, b, radix, width, extra_cols=extra)


@pytest.mark.parametrize("fn,radix,width,blk,kv", [
    ("add", 3, 5, False, "gather"),
    ("add", 4, 3, True, "onehot"),
    ("sub", 5, 3, True, "onehot_packed"),
    ("mul", 3, 2, False, "gather"),
    ("negate", 3, 4, False, "onehot"),
    ("modsum", 4, 4, False, "onehot_packed"),
])
def test_execute_matches_reference(fn, radix, width, blk, kv):
    """333 rows at the default block size (one 333-row block) and at 128
    (three blocks, 51 padding rows)."""
    ours = apc.compile_named(fn, radix, width, blocked=blk)
    theirs = ref_apc.compile_named(fn, radix, width, blocked=blk)
    arr = _operands(fn, radix, width, 333, seed=width)
    for block_rows in (None, 128):
        out, traced = apc.execute(arr, ours, collect_stats=True,
                                  block_rows=block_rows, kernel_variant=kv,
                                  device="cpu")
        want, want_traced = ref_apc.execute(
            jnp.asarray(arr), theirs, collect_stats=True,
            block_rows=block_rows, kernel_variant=kv, interpret=True)
        assert out.dtype == torch.int8 and out.device.type == "cpu"
        assert np.array_equal(out.numpy(), np.asarray(want))
        assert np.array_equal(traced.block_counts.numpy(),
                              np.asarray(want_traced.block_counts))
        assert stats_fields(apc.to_ap_stats(traced, ours, 333, radix)) == \
            stats_fields(ref_apc.to_ap_stats(want_traced, theirs, 333,
                                             radix))


def test_run_accumulates_like_reference():
    """Two runs merged into one APStats, as the drivers do."""
    ours = apc.compile_named("add", 3, 4)
    theirs = ref_apc.compile_named("add", 3, 4)
    s_ours, s_ref = ap.APStats(radix=3), ref_ap.APStats(radix=3)
    for seed in (1, 2):
        arr = _operands("add", 3, 4, 100, seed)
        out = apc.run(arr, ours, stats=s_ours, device="cpu")
        want = ref_apc.run(jnp.asarray(arr), theirs, stats=s_ref)
        assert np.array_equal(out.numpy(), np.asarray(want))
    assert stats_fields(s_ours) == stats_fields(s_ref)


def test_execute_without_stats_and_empty_batch():
    compiled = apc.compile_named("max", 3, 3)
    arr = _operands("max", 3, 3, 50, seed=4)
    out, traced = apc.execute(arr, compiled, device="cpu")
    want, _ = ref_apc.execute(jnp.asarray(arr),
                              ref_apc.compile_named("max", 3, 3))
    assert traced is None
    assert np.array_equal(out.numpy(), np.asarray(want))
    empty = np.zeros((0, 6), np.int8)
    out, traced = apc.execute(empty, compiled, collect_stats=True,
                              device="cpu")
    assert out.shape == (0, 6)
    assert traced.block_counts.shape == (1, 10)
    assert int(traced.block_counts.abs().sum()) == 0


def test_execute_rejects_narrow_arrays_and_unported_routes():
    compiled = apc.compile_named("add", 3, 4)
    with pytest.raises(ValueError, match="columns"):
        apc.execute(np.zeros((4, 8), np.int8), compiled, device="cpu")
    arr = np.zeros((4, 9), np.int8)
    with pytest.raises(NotImplementedError, match="pool"):
        apc.run(arr, compiled, pool=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        apc.run(arr, compiled, mesh=object(), device="cpu")


@pytest.mark.parametrize("k,k_tile", [(4, 2), (6, 3)])
def test_reference_mac_tiled_through_port_executor(k, k_tile):
    """Programs the port cannot compile yet (the K-tiled MAC) reach it as
    plain arrays and run bit-identically, counters included."""
    radix, rows = 3, 200
    width = ref_apc.mac_acc_width(radix, k, 2)
    tiled = ref_apc.compile_mac_tiled(radix, k, width, k_tile)
    rng = np.random.default_rng(k)
    for prog in tiled.programs + tiled.reduce_programs:
        ours = compiled_from_arrays(*prog.schedule_tensors,
                                    min_cols=prog.min_cols)
        arr = rng.integers(0, radix, (rows, prog.min_cols)).astype(np.int8)
        out, traced = apc.execute(arr, ours, collect_stats=True,
                                  block_rows=64, device="cpu")
        want, want_traced = ref_apc.execute(jnp.asarray(arr), prog,
                                            collect_stats=True,
                                            block_rows=64)
        assert np.array_equal(out.numpy(), np.asarray(want))
        assert np.array_equal(traced.block_counts.numpy(),
                              np.asarray(want_traced.block_counts))
        got = apc.to_ap_stats(traced, ours, rows, radix)
        ref_stats = ref_apc.to_ap_stats(want_traced, prog, rows, radix)
        assert stats_fields(got) == stats_fields(ref_stats)
        carried = ap_stats_from_fields(
            ref_stats.radix, ref_stats.n_rows, ref_stats.n_compare_cycles,
            ref_stats.n_write_cycles, ref_stats.sets, ref_stats.resets,
            ref_stats.mismatch_hist)
        assert stats_fields(carried) == stats_fields(got)


def test_traced_stats_totals():
    compiled = apc.compile_named("add", 3, 3)
    arr = _operands("add", 3, 3, 300, seed=9)
    _, traced = apc.execute(arr, compiled, collect_stats=True,
                            block_rows=64, device="cpu")
    stats = apc.to_ap_stats(traced, compiled, 300, 3)
    assert int(traced.sets) == stats.sets
    assert int(traced.resets) == stats.resets
    assert traced.mismatch_hist.tolist() == stats.mismatch_hist.tolist()
