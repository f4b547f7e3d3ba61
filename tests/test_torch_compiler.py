"""The port's copies of the framework-free compiler against the reference:
LUT pass lists, schedule tensors, packed schedules and cycle counts must be
equal array for array, and programs must round-trip through plain arrays."""
import numpy as np
import pytest

from repro import apc as ref_apc
from repro.core import blocked as ref_blocked
from repro.core import nonblocked as ref_nonblocked
from repro.core import truth_tables as ref_tt

from repro_torch import apc
from repro_torch.convert import compiled_from_arrays
from repro_torch.core import blocked, nonblocked
from repro_torch.core import truth_tables as tt

FNS = ("full_adder", "full_subtractor", "rev_subtractor", "half_adder",
       "min", "max", "modsum", "nor", "nand", "not_copy")
NAMED = ("add", "sub", "mul", "negate", "min", "max", "modsum", "nor",
         "nand")


def _passes(lut):
    return (lut.fn_name, lut.radix, lut.width, lut.blocked,
            [(p.key, p.write_cols, p.write_vals, p.pass_num, p.group_num)
             for p in lut.passes],
            [(b.write_cols, b.write_vals, b.keys) for b in lut.blocks],
            lut.n_compare_cycles, lut.n_write_cycles)


def _tensors_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.parametrize("radix", [2, 3, 4, 5])
@pytest.mark.parametrize("fn", FNS)
def test_lut_pass_lists_match_reference(fn, radix):
    ours = tt.REGISTRY[fn](radix)
    theirs = ref_tt.REGISTRY[fn](radix)
    assert ours.table == theirs.table
    assert (_passes(nonblocked.build_lut_nonblocked(ours))
            == _passes(ref_nonblocked.build_lut_nonblocked(theirs)))
    assert (_passes(blocked.build_lut_blocked(ours))
            == _passes(ref_blocked.build_lut_blocked(theirs)))


@pytest.mark.parametrize("radix", [3, 4, 5])
@pytest.mark.parametrize("fn", NAMED)
@pytest.mark.parametrize("blk", [False, True])
def test_compiled_and_packed_tensors_match_reference(fn, radix, blk):
    width = 2 if fn == "mul" else 3
    ours = apc.compile_named(fn, radix, width, blocked=blk)
    theirs = ref_apc.compile_named(fn, radix, width, blocked=blk)
    _tensors_equal(ours.schedule_tensors, theirs.schedule_tensors)
    assert (ours.n_steps, ours.n_compare_cycles, ours.n_write_cycles,
            ours.min_cols, ours.writes_distinct, ours.compares_distinct) == (
        theirs.n_steps, theirs.n_compare_cycles, theirs.n_write_cycles,
        theirs.min_cols, theirs.writes_distinct, theirs.compares_distinct)
    p, q = ours.packed(), theirs.packed()
    _tensors_equal(p.schedule_tensors, q.schedule_tensors)
    assert (p.n_groups, p.pack, p.n_slots) == (q.n_groups, q.pack, q.n_slots)
    for kv in apc.KERNEL_VARIANTS:
        a = apc.resolve_schedule(ours, kv)
        b = ref_apc.resolve_schedule(theirs, kv)
        assert a[1:] == b[1:]
        _tensors_equal(a[0], b[0])


@pytest.mark.parametrize("fn,radix,width", [("add", 3, 20), ("mul", 3, 5),
                                            ("max", 3, 8)])
def test_benchmark_programs_match_reference(fn, radix, width):
    ours = apc.compile_named(fn, radix, width)
    theirs = ref_apc.compile_named(fn, radix, width)
    _tensors_equal(ours.schedule_tensors, theirs.schedule_tensors)
    _tensors_equal(ours.packed().schedule_tensors,
                   theirs.packed().schedule_tensors)


@pytest.mark.parametrize("fn,radix,width,blk", [
    ("add", 3, 6, False), ("sub", 5, 4, True), ("mul", 3, 3, False),
    ("negate", 4, 3, True), ("max", 3, 4, False)])
def test_compiled_from_arrays_round_trip(fn, radix, width, blk):
    for src in (apc.compile_named(fn, radix, width, blocked=blk),
                ref_apc.compile_named(fn, radix, width, blocked=blk)):
        back = compiled_from_arrays(*src.schedule_tensors,
                                    min_cols=src.min_cols)
        _tensors_equal(back.schedule_tensors, src.schedule_tensors)
        assert (back.n_compare_cycles, back.n_write_cycles, back.min_cols) \
            == (src.n_compare_cycles, src.n_write_cycles, src.min_cols)
        _tensors_equal(back.packed().schedule_tensors,
                       src.packed().schedule_tensors)


@pytest.mark.parametrize("radix,k,width,k_tile", [(3, 4, 4, 2),
                                                  (3, 5, 5, 2)])
def test_reference_mac_programs_round_trip(radix, k, width, k_tile):
    """The MAC compiler is not ported yet: its programs reach the port as
    plain arrays and must come back unchanged."""
    tiled = ref_apc.compile_mac_tiled(radix, k, width, k_tile)
    for prog in tiled.programs + tiled.reduce_programs:
        back = compiled_from_arrays(*prog.schedule_tensors,
                                    min_cols=prog.min_cols)
        _tensors_equal(back.schedule_tensors, prog.schedule_tensors)
        assert (back.n_compare_cycles, back.n_write_cycles, back.min_cols,
                back.writes_distinct, back.compares_distinct) == (
            prog.n_compare_cycles, prog.n_write_cycles, prog.min_cols,
            prog.writes_distinct, prog.compares_distinct)


def test_default_kernel_variant_is_gather(monkeypatch):
    monkeypatch.delenv("REPRO_AP_KERNEL_VARIANT", raising=False)
    assert apc.default_kernel_variant() == "gather"
    monkeypatch.setenv("REPRO_AP_KERNEL_VARIANT", "onehot_packed")
    assert apc.default_kernel_variant() == "onehot_packed"
