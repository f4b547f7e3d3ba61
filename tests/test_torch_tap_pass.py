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


def _random_slots(rng, slots, keys, ccols, wcols, cols):
    """Random dense schedule tensors: -1 padded columns, invalid keys,
    don't-care key digits, duplicate write columns."""
    cmp_cols = rng.integers(-1, cols, (slots, ccols)).astype(np.int32)
    key_digits = rng.integers(-1, 3, (slots, keys, ccols)).astype(np.int8)
    key_valid = rng.random((slots, keys)) < 0.7
    hist_flag = rng.random(slots) < 0.6
    wr_cols = rng.integers(-1, cols, (slots, wcols)).astype(np.int32)
    wr_vals = rng.integers(0, 3, (slots, wcols)).astype(np.int8)
    return [torch.from_numpy(a) for a in (cmp_cols, key_digits, key_valid,
                                          hist_flag, wr_cols, wr_vals)]


@pytest.mark.parametrize("pack", [1, 2, 4])
@pytest.mark.parametrize("masking", ["n_valid", "block_valid"])
@pytest.mark.parametrize("stats", [True, False])
def test_program_plain_numpy_body_matches_torch_body(pack, masking, stats):
    """CPU tensors replay in NumPy, card tensors in PyTorch ops: the two
    bodies of run_program_plain give the same digits and counter rows on
    random schedules (no tolerance)."""
    rng = np.random.default_rng(pack * 10 + (masking == "n_valid"))
    for trial in range(6):
        block_rows, n_blocks, cols = 16, 3, 9
        rows = block_rows * n_blocks
        sched = _random_slots(rng, pack * int(rng.integers(1, 12)),
                              int(rng.integers(1, 4)),
                              int(rng.integers(1, 5)),
                              int(rng.integers(1, 4)), cols)
        arr = torch.from_numpy(rng.integers(-1, 3, (rows, cols))
                               .astype(np.int8))
        kw = dict(block_rows=block_rows, collect_stats=stats, pack=pack,
                  block_valid=None if masking == "n_valid" else tuple(
                      int(v) for v in rng.integers(0, block_rows + 1,
                                                   n_blocks)))
        n_valid = int(rng.integers(0, rows + 1))
        got = ref._run_program_numpy(arr, *sched, n_valid, **kw)
        want = ref._run_program_torch(arr, *sched, n_valid, **kw)
        assert torch.equal(got[0], want[0]), trial
        if stats:
            assert torch.equal(got[1], want[1]), trial
        else:
            assert got[1] is None and want[1] is None


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


# ---------------------------------------------------------------------------
# Slot records: the CUDA program kernel's form of a schedule
# ---------------------------------------------------------------------------

def _mac_program(which):
    width = apc.mac_acc_width(3, 64, 7)
    tiled = apc.compile_mac_tiled(3, 64, width, 16)
    return (tiled.programs[0] if which == "tile"
            else tiled.reduce_programs[0])


def _padded_to(sched, layout):
    """The dense tensors widened to the layout: -1 columns, 0 keys and
    values, invalid keys."""
    cmp_cols, keys, key_valid, hist_flag, wr_cols, wr_vals = (
        np.asarray(t) for t in sched)
    S = cmp_cols.shape[0]

    def widen(a, shape, fill):
        out = np.full(shape, fill, a.dtype)
        out[tuple(slice(0, n) for n in a.shape)] = a[
            tuple(slice(0, n) for n in shape)]
        return out
    return (widen(cmp_cols, (S, layout.C), -1),
            widen(keys, (S, layout.K, layout.C), 0),
            widen(key_valid.astype(bool), (S, layout.K), False),
            hist_flag.astype(bool),
            widen(wr_cols, (S, layout.W), -1),
            widen(wr_vals, (S, layout.W), 0))


@pytest.mark.parametrize("kv", VARIANTS)
@pytest.mark.parametrize("name", ["add3x4", "add3x4_blocked", "max3x4",
                                  "sub5x3_blocked", "mul3x2",
                                  "dup_write_cols", "hist12", "mac_tile",
                                  "mac_reduce"])
def test_records_decode_to_the_dense_schedule(name, kv):
    """Encoding a compiled program's schedule into slot records and
    decoding them gives the six dense tensors back, at the record
    layout's widths, for every schedule form."""
    from repro_torch.kernels.tap_pass import records
    prog = (_mac_program(name[4:]) if name.startswith("mac")
            else _programs(name)[1])
    sched, _, pack, _ = apc.resolve_schedule(prog, kv)
    cols = prog.min_cols + 1
    rec = records.build_records(sched, cols, pack)
    assert rec.records.dtype == np.int32
    assert rec.records.shape[1] == rec.layout.words
    assert rec.layout.words % 4 == 0
    assert rec.records.shape[0] % rec.chunk_slots == 0
    assert rec.chunk_slots % pack == 0
    assert rec.n_slots == sched[0].shape[0]
    got = records.decode_records(rec.records[:rec.n_slots], cols, rec.layout)
    for a, b in zip(got, _padded_to(sched, rec.layout)):
        assert a.dtype == b.dtype or a.dtype == bool
        assert np.array_equal(a, b)
    nk = np.asarray(sched[2]).astype(bool).sum(axis=1)
    assert rec.n_hist_keys == int((nk * np.asarray(sched[3])).sum())
    padding = records.decode_records(rec.records[rec.n_slots:], cols,
                                     rec.layout)
    assert (padding[0] == -1).all() and (padding[4] == -1).all()
    assert not padding[2].any() and not padding[3].any()


@pytest.mark.parametrize("name,kv,kind", [
    ("add3x4", "gather", 1), ("mul3x2", "gather", 2),
    ("max3x4", "onehot", 1), ("mac_tile", "gather", 2),
    ("mac_reduce", "gather", 1), ("add3x4_blocked", "gather", 0),
    ("sub5x3_blocked", "gather", 0), ("dup_write_cols", "gather", 0),
    ("hist12", "gather", 0), ("max3x4", "onehot_packed", 0)])
def test_records_choose_the_unrolled_kernels(name, kv, kind):
    """One key, at most four compare and three distinct write columns, no
    packing: an unrolled kernel (kind 1 for three compare columns, 2 for
    four), in the wide layout; anything else the general kernel (kind 0)
    in the program's own packed layout."""
    from repro_torch.kernels.tap_pass import records
    prog = (_mac_program(name[4:]) if name.startswith("mac")
            else _programs(name)[1])
    sched, _, pack, _ = apc.resolve_schedule(prog, kv)
    got, layout = records.choose_layout(sched, pack)
    assert got == kind and layout.wide == (kind != 0)
    if kind:
        assert layout.words == 16 and (layout.K, layout.W) == (1, 3)


def test_records_map_outside_columns_to_the_dummy_column():
    """-1 and columns past ``cols`` become the dummy column ``cols`` (a
    write there carries -1); the valid keys move first."""
    from repro_torch.kernels.tap_pass import records
    sched = (np.array([[2, -1, 7]], np.int32),
             np.array([[[9, 9, 9], [1, 2, 3]]], np.int8),
             np.array([[False, True]]), np.array([True]),
             np.array([[5, 0, -1]], np.int32), np.array([[1, 2, 3]], np.int8))
    layout = records.Layout(2, 3, 3)
    rec = records.encode_records(sched, 6, layout)
    cmp_cols, keys, key_valid, hist, wr_cols, wr_vals = (
        records.decode_records(rec, 6, layout))
    assert cmp_cols.tolist() == [[2, -1, -1]]
    assert keys[0, 0].tolist() == [1, 2, 3] and keys[0, 1].tolist() == [0] * 3
    assert key_valid.tolist() == [[True, False]] and hist.tolist() == [True]
    assert wr_cols.tolist() == [[5, 0, -1]] and wr_vals.tolist() == [[1, 2, 0]]
    raw = rec.view(np.uint8)
    assert raw[0, 4 * layout.wcols_at + 4:4 * layout.wcols_at + 6].view(
        "<u2")[0] == 6                          # the dummy column
    with pytest.raises(ValueError, match="does not fit"):
        records.encode_records(sched, 6, records.Layout(2, 2, 3))


@pytest.mark.parametrize("cols,block_rows,n_blocks,want", [
    (41, 4096, 256, (1024, 256)),     # add 3x20 at 2^20 rows
    (650, 4096, 3, (44, 128)),        # the AP matmul's tile program
    (145, 4096, 3, (32, 128)),        # its reduction
    (41, 10, 100, (12, 128)),         # blocks smaller than a CTA
    (41, 333, 1, (16, 128)),
    (258, 4096, 16, (220, 128))])
def test_program_kernel_cta_shape(cols, block_rows, n_blocks, want):
    """Four rows per thread, the most rows whose tile fits in shared
    memory, halved until the grid gives each of 132 SMs two CTAs; never
    more rows than a block."""
    assert kernel.cta_shape(cols, block_rows, n_blocks, 4096, 132) == want


# ---------------------------------------------------------------------------
# The schedule kernel's host side: slot records, their cache, launch shape
# ---------------------------------------------------------------------------

def _short_schedule(name):
    """(schedule, cols) of the short schedules the entry points build."""
    if name == "blocked_full_adder":
        return ref.schedule_from_lut(build_lut_blocked(tt.full_adder(3)),
                                     (0, 1, 2)), 3
    build = build_lut_blocked if name.endswith("blocked") else \
        build_lut_nonblocked
    return ref.ripple_add_schedule(build(tt.full_adder(3)), 3, 6), 7


@pytest.mark.parametrize("name,kind", [("ripple_add_w3", 1),
                                       ("ripple_add_w3_blocked", 0),
                                       ("blocked_full_adder", 0)])
def test_schedule_plan_records_decode_to_schedule_tensors(name, kind):
    """A short schedule takes the slot kind ``choose_layout`` gives its
    dense tensors (the non-blocked ripple add the unrolled (1, 3, 3) slot,
    blocked schedules the general one), and its records decode back to
    ``schedule_tensors`` with no histogram flag."""
    from repro_torch.kernels.tap_pass import records
    sched, cols = _short_schedule(name)
    plan = kernel.schedule_plan(sched, cols, torch.device("cpu"))
    dense = kernel.schedule_tensors(sched)
    six = (dense[0], dense[1], dense[2], np.zeros(len(sched), bool),
           dense[3], dense[4])
    assert records.choose_layout(six, 1) == (plan.kind, plan.layout)
    assert plan.kind == kind
    assert plan.records.shape == (len(sched), plan.layout.words)
    got = records.decode_records(plan.records.numpy(), cols, plan.layout)
    for a, b in zip(got, _padded_to(six, plan.layout)):
        assert np.array_equal(a, b)


def test_schedule_plan_cached_per_schedule_object():
    """The same schedule object gets the same plan at no cost of hashing
    it; an equal schedule that is another object, or another column count,
    gets its own encoding; however many schedules come and go, each plan
    decodes to its own schedule."""
    from repro_torch.kernels.tap_pass import records
    cpu = torch.device("cpu")
    sched, cols = _short_schedule("ripple_add_w3")
    plan = kernel.schedule_plan(sched, cols, cpu)
    assert kernel.schedule_plan(sched, cols, cpu) is plan
    assert kernel.schedule_plan(sched, cols + 1, cpu) is not plan
    twin = tuple(list(sched))
    assert twin == sched and twin is not sched
    assert torch.equal(kernel.schedule_plan(twin, cols, cpu).records,
                       plan.records)
    rng = np.random.default_rng(11)
    for i in range(3 * kernel.MAX_SCHEDULE_PLANS):
        steps = tuple(
            ((tuple(int(v) for v in rng.integers(-1, 3, 2)),), (0, 1),
             (int(rng.integers(2, 5)),), (int(rng.integers(-1, 3)),))
            for _ in range(int(rng.integers(1, 6))))
        p = kernel.schedule_plan(steps, 5, cpu)
        got = records.decode_records(p.records.numpy(), 5, p.layout)
        want = kernel.schedule_tensors(steps)
        assert np.array_equal(got[0][:, :2], want[0])
        assert np.array_equal(got[1][:, :1, :2], want[1])
        assert np.array_equal(got[4][:, :1], want[3])
        assert np.array_equal(got[5][:, :1], want[4])
    assert len(kernel._plans) <= kernel.MAX_SCHEDULE_PLANS


def test_entry_points_build_each_schedule_once():
    """``tap_ripple_add`` and ``tap_apply_lut`` build a schedule once per
    LUT and placement and hand the same tuple to the schedule kernel after,
    so its plan (cached per schedule object) is hit by a caller's repeated
    calls; another LUT or placement gets a schedule of its own."""
    cpu = torch.device("cpu")
    lut_n = build_lut_nonblocked(tt.full_adder(3))
    lut_b = build_lut_blocked(tt.full_adder(3))
    arr = np.random.default_rng(12).integers(0, 3, (64, 7)).astype(np.int8)
    for builder, call in (
            (ops._ripple_schedule,
             lambda: ops.tap_ripple_add(arr, lut_n, 3, 6, device="cpu")),
            (ops._lut_schedule,
             lambda: ops.tap_apply_lut(arr, lut_b, [4, 0, 2],
                                       device="cpu"))):
        call()
        hits = builder.cache_info().hits
        call()
        assert builder.cache_info().hits == hits + 1
    sched = ops._ripple_schedule(lut_n, 3, 6, 0, None)
    assert sched == ref.ripple_add_schedule(lut_n, 3, 6)
    assert ops._ripple_schedule(lut_n, 3, 6, 0, None) is sched
    assert (kernel.schedule_plan(ops._ripple_schedule(lut_n, 3, 6, 0, None),
                                 7, cpu)
            is kernel.schedule_plan(sched, 7, cpu))
    for lut, args in ((lut_b, (3, 6, 0, None)), (lut_n, (3, 6, 0, 4)),
                      (lut_n, (2, 6, 0, None))):
        assert (ops._ripple_schedule(lut, *args)
                == ref.ripple_add_schedule(lut, *args) != sched)
    assert (ops._lut_schedule(lut_b, (4, 0, 2))
            == ref.schedule_from_lut(lut_b, (4, 0, 2))
            != ops._lut_schedule(lut_b, (0, 1, 2)))


def test_schedule_plan_refuses_columns_past_the_array():
    """A step touching a column at or past ``cols`` raises ValueError at
    encode time, every time (a refused schedule is not cached)."""
    sched, _ = _short_schedule("ripple_add_w3")       # touches 7 columns
    for _ in range(2):
        with pytest.raises(ValueError, match="column >= 6"):
            kernel.schedule_plan(sched, 6, torch.device("cpu"))


@pytest.mark.parametrize("rows,want_rows", [(4096, 8), (65536, 128),
                                            (1 << 20, 1024), (1000, 4),
                                            (13, 4)])
def test_schedule_kernel_fills_the_card(rows, want_rows):
    """The schedule kernel's CTAs: at least two per SM of 132 where the
    rows allow (4096 rows on 512 CTAs, not 4), four rows per thread, at
    least four warps."""
    cta_rows, threads = kernel.schedule_shape(7, rows, 64, 16, 132)
    assert cta_rows == want_rows
    assert -(-rows // cta_rows) >= 2 * 132 or cta_rows == 4
    assert threads >= 128 and 4 * threads >= cta_rows and threads % 32 == 0
