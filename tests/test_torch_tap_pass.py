"""The port's TAP kernels (their plain versions, as run for CPU tensors)
against the reference's Pallas kernels in interpret mode: bit-identical
digits and per-block counter rows on the same seeded numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import apc as ref_apc
from repro.core import build_lut_blocked as ref_build_blocked
from repro.core import build_lut_nonblocked as ref_build_nonblocked
from repro.core import truth_tables as ref_tt
from repro.kernels.tap_pass import kernel as ref_kernel
from repro.kernels.tap_pass import ops as ref_ops
from repro.kernels.tap_pass import ref as ref_ref

from repro_torch import apc
from repro_torch.core import build_lut_blocked, build_lut_nonblocked
from repro_torch.core import truth_tables as tt
from repro_torch.kernels.tap_pass import kernel, ops, ref

VARIANTS = ("gather", "onehot", "onehot_packed")


def _dup_program(pkg):
    """Duplicate write columns (serial writes, every change charged) and
    duplicate compare columns (one mismatch per position)."""
    return pkg.compile_program((
        pkg.CompareWrite(compare_cols=(0,), key=(1,), write_cols=(2, 2),
                         write_vals=(1, 2)),
        pkg.CompareWrite(compare_cols=(1, 1), key=(0, 0), write_cols=(3,),
                         write_vals=(2,))))


def _hist12_program(pkg, build, tables):
    """Compares over 12 masked cells: mismatch counts past the top bin."""
    lut = build(tables.REGISTRY["max"](3))
    extra = tuple((c, 0) for c in range(2, 12))
    return pkg.compile_program((pkg.ApplyLUT(lut, (0, 1), extra_key=extra),))


PROGRAMS = {
    "add3x4": (3, lambda p: p.compile_named("add", 3, 4)),
    "add3x4_blocked": (3, lambda p: p.compile_named("add", 3, 4,
                                                    blocked=True)),
    "max3x4": (3, lambda p: p.compile_named("max", 3, 4)),
    "sub5x3_blocked": (5, lambda p: p.compile_named("sub", 5, 3,
                                                    blocked=True)),
    "mul3x2": (3, lambda p: p.compile_named("mul", 3, 2)),
    "dup_write_cols": (3, _dup_program),
}


def _programs(name):
    if name == "hist12":
        return (3, _hist12_program(apc, build_lut_nonblocked, tt),
                _hist12_program(ref_apc, ref_build_nonblocked, ref_tt))
    radix, make = PROGRAMS[name]
    return radix, make(apc), make(ref_apc)


def _digits(rows, cols, radix, seed):
    """Every value a cell can hold: -1 (don't-care), 0..radix-1, and
    radix (the fault model's stuck-between-levels value)."""
    return np.random.default_rng(seed).integers(
        -1, radix + 1, (rows, cols)).astype(np.int8)


def _both(name, kv, rows, n_valid, block_rows, stats, seed=0):
    radix, ours, theirs = _programs(name)
    t_ours, v_ours, p_ours, _ = apc.resolve_schedule(ours, kv)
    t_ref, v_ref, p_ref, _ = ref_apc.resolve_schedule(theirs, kv)
    assert (v_ours, p_ours) == (v_ref, p_ref)
    arr = _digits(rows, ours.min_cols + 1, radix, seed)
    out, counts = kernel.tap_run_program(
        torch.from_numpy(arr), *t_ours, n_valid, block_rows=block_rows,
        collect_stats=stats, pack=p_ours)
    want, want_counts = ref_kernel.tap_run_program(
        jnp.asarray(arr), *t_ref, jnp.int32(n_valid), block_rows=block_rows,
        collect_stats=stats, interpret=True, variant=v_ref, pack=p_ref)
    assert np.array_equal(out.numpy(), np.asarray(want))
    if stats:
        assert counts.dtype == torch.int32
        assert counts.shape == (rows // block_rows, 10)
        assert np.array_equal(counts.numpy(), np.asarray(want_counts))
    else:
        assert counts is None and want_counts is None
    return out, counts


@pytest.mark.parametrize("kv", VARIANTS)
@pytest.mark.parametrize("name", list(PROGRAMS) + ["hist12"])
def test_program_plain_matches_reference_kernel(name, kv):
    """384 padded rows at block_rows=128, 333 valid: the padding rows
    (-1, matching every key) must get no writes and no counts."""
    _both(name, kv, rows=384, n_valid=333, block_rows=128, stats=True)


@pytest.mark.parametrize("name", ["add3x4_blocked", "dup_write_cols"])
def test_program_plain_without_stats_matches_reference(name):
    _both(name, "gather", rows=384, n_valid=333, block_rows=128,
          stats=False)


def test_hist12_top_bin_saturates():
    _, counts = _both("hist12", "gather", rows=128, n_valid=128,
                      block_rows=64, stats=True, seed=5)
    hist = counts[:, 2:].sum(dim=0)
    assert hist[-1] > 0                       # mass past 7 mismatches kept
    n_compares = _programs("hist12")[1].n_compare_cycles
    assert int(hist.sum()) == 128 * n_compares   # every compare of every row


def test_dup_write_cols_charge_every_change():
    """Serial same-column writes: writing 1 then 2 charges both changes
    wherever the cell held neither."""
    arr = torch.tensor([[1, 0, 0, 0], [1, 0, 1, 0], [0, 0, 0, 0]],
                       dtype=torch.int8)
    compiled = _dup_program(apc)
    out, counts = kernel.tap_run_program(
        arr, *compiled.schedule_tensors, 3, block_rows=3,
        collect_stats=True)
    assert out[:, 2].tolist() == [2, 2, 0]
    assert out[:, 3].tolist() == [2, 2, 2]
    assert counts[0, 0].item() == 2 + 1 + 3   # sets: 0->1->2, 1->2, col 3


@pytest.mark.parametrize("width", [1, 3, 8])
def test_tap_ripple_add_matches_reference(width):
    """Width <= 3 runs the short-schedule kernel, width 8 the program
    kernel (more than UNROLL_STEP_LIMIT steps)."""
    rows = 1000
    lut = build_lut_nonblocked(tt.full_adder(3))
    ref_lut = ref_build_nonblocked(ref_tt.full_adder(3))
    rng = np.random.default_rng(width)
    arr = np.concatenate([rng.integers(0, 3, (rows, 2 * width)),
                          np.zeros((rows, 1))], axis=1).astype(np.int8)
    out = ops.tap_ripple_add(arr, lut, width, 2 * width, block_rows=256,
                             device="cpu")
    want = ref_ops.tap_ripple_add(jnp.asarray(arr), ref_lut, width,
                                  2 * width, block_rows=256)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert (len(ref.ripple_add_schedule(lut, width, 2 * width))
            <= ops.UNROLL_STEP_LIMIT) == (width <= 3)


@pytest.mark.parametrize("blk", [False, True])
def test_tap_apply_lut_matches_reference(blk):
    build, ref_build = ((build_lut_blocked, ref_build_blocked) if blk
                        else (build_lut_nonblocked, ref_build_nonblocked))
    arr = _digits(500, 5, 3, seed=7)
    out = ops.tap_apply_lut(arr, build(tt.full_adder(3)), (4, 0, 2),
                            block_rows=128, device="cpu")
    want = ref_ops.tap_apply_lut(jnp.asarray(arr),
                                 ref_build(ref_tt.full_adder(3)), (4, 0, 2),
                                 block_rows=128)
    assert np.array_equal(out.numpy(), np.asarray(want))


def test_apply_schedule_matches_reference_oracle():
    lut = build_lut_blocked(tt.full_subtractor(4))
    sched = ref.ripple_add_schedule(lut, 3, 6)
    ref_sched = ref_ref.ripple_add_schedule(
        ref_build_blocked(ref_tt.full_subtractor(4)), 3, 6)
    assert sched == ref_sched
    arr = _digits(256, 7, 4, seed=3)
    out = kernel.tap_apply_schedule(torch.from_numpy(arr), sched,
                                    block_rows=128)
    want = ref_ref.apply_schedule(jnp.asarray(arr), ref_sched)
    assert np.array_equal(out.numpy(), np.asarray(want))


def test_schedule_tensors_match_compiled_program():
    """The schedule kernel's dense tensors are the program kernel's layout
    (without the histogram flags)."""
    lut = build_lut_nonblocked(tt.full_adder(3))
    sched = ref.ripple_add_schedule(lut, 3, 6)
    compiled = apc.lower._compile_steps(tuple(
        apc.Step(keys=k, compare_cols=c, write_cols=w, write_vals=v)
        for k, c, w, v in sched))
    cmp_cols, keys, key_valid, wr_cols, wr_vals = \
        kernel.schedule_tensors(sched)
    assert np.array_equal(cmp_cols, compiled.cmp_cols)
    assert np.array_equal(keys, compiled.keys)
    assert np.array_equal(key_valid.astype(bool), compiled.key_valid)
    assert np.array_equal(wr_cols, compiled.wr_cols)
    assert np.array_equal(wr_vals, compiled.wr_vals)


def test_pad_rows_and_traffic_model_match_reference():
    arr = _digits(10, 3, 3, seed=1)
    padded, rows = ops._pad_rows(torch.from_numpy(arr), 8)
    want, want_rows = ref_ops._pad_rows(jnp.asarray(arr), 8)
    assert rows == want_rows == 10
    assert np.array_equal(padded.numpy(), np.asarray(want))
    lut = build_lut_nonblocked(tt.full_adder(3))
    ref_lut = ref_build_nonblocked(ref_tt.full_adder(3))
    for n_rows in (0, 8, 4096):
        assert (ops.hbm_traffic_model(n_rows, 9, lut, 4)
                == ref_ops.hbm_traffic_model(n_rows, 9, ref_lut, 4))


def test_wrapper_argument_checks():
    compiled = apc.compile_named("add", 3, 2)
    arr = torch.zeros((100, 5), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple"):
        kernel.tap_run_program(arr, *compiled.schedule_tensors, 100,
                               block_rows=64)
    with pytest.raises(ValueError, match="pack"):
        kernel.tap_run_program(arr, *compiled.schedule_tensors, 100,
                               block_rows=100, pack=0)
    with pytest.raises(ValueError, match="multiple"):
        kernel.tap_apply_schedule(arr, ((), (), (0,), (1,)), block_rows=64)


def test_schedule_columns_checked_on_the_host():
    """A schedule past the array's columns is refused before any launch:
    numpy schedules in the wrapper, compiled ones by ``min_cols``."""
    compiled = apc.compile_named("add", 3, 2)           # touches 5 columns
    arr = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="column >= 4"):
        kernel.tap_run_program(arr, *compiled.schedule_tensors, 8,
                               block_rows=8)
    with pytest.raises(ValueError, match="columns"):
        apc.execute(arr, compiled, device="cpu")
    lut = build_lut_nonblocked(tt.full_adder(3))
    with pytest.raises(ValueError, match="column >= 4"):
        ops.tap_ripple_add(arr, lut, 8, 16, device="cpu")   # > 64 steps
