"""The port's ``core.ap`` drivers under both engines against the reference
simulator, and Table XI priced from the port's counters against the
reference benchmark: digits, every ``APStats`` field and the energy report
bit-identical on the same seeded inputs."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ap as ref_ap
from repro.core import build_lut_blocked as ref_build_blocked
from repro.core import build_lut_nonblocked as ref_build_nonblocked
from repro.core import energy as ref_energy
from repro.core import truth_tables as ref_tt
from repro.core.circuit import CellParams as RefCellParams

from repro_torch.convert import ap_stats_from_fields
from repro_torch.core import ap, build_lut_blocked, build_lut_nonblocked
from repro_torch.core import energy
from repro_torch.core import truth_tables as tt
from repro_torch.core.circuit import CellParams

sys.path.insert(0, ".")

ENGINES = ("replay", "apc")


def stats_fields(s):
    return (s.radix, s.n_rows, s.n_compare_cycles, s.n_write_cycles,
            s.sets, s.resets, tuple(int(h) for h in s.mismatch_hist))


def _luts(fn, radix, blk):
    ours = (build_lut_blocked if blk else build_lut_nonblocked)(
        tt.REGISTRY[fn](radix))
    theirs = (ref_build_blocked if blk else ref_build_nonblocked)(
        ref_tt.REGISTRY[fn](radix))
    return ours, theirs


def _check(run_ours, run_ref, arr, radix):
    want_stats = ref_ap.APStats(radix=radix)
    want = np.asarray(run_ref(jnp.asarray(arr), want_stats))
    for engine in ENGINES:
        stats = ap.APStats(radix=radix)
        out = run_ours(arr, stats, engine)
        assert out.device.type == "cpu"
        assert np.array_equal(out.numpy(), want), engine
        assert stats_fields(stats) == stats_fields(want_stats), engine
    return want


@pytest.mark.parametrize("radix,width,blk", [(3, 5, False), (4, 3, True)])
def test_ripple_add_and_sub(radix, width, blk):
    rng = np.random.default_rng(radix)
    a = rng.integers(0, radix ** width, 150)
    b = rng.integers(0, radix ** width, 150)
    arr = ap.encode_operands(a, b, radix, width)
    add, ref_add = _luts("full_adder", radix, blk)
    out = _check(
        lambda x, s, e: ap.ripple_add(x, add, width, 2 * width, stats=s,
                                      engine=e, device="cpu"),
        lambda x, s: ref_ap.ripple_add(x, ref_add, width, 2 * width,
                                       stats=s), arr, radix)
    got = ap.decode_digits(out, list(range(width, 2 * width)), radix)
    assert np.array_equal(got, (a + b) % radix ** width)
    sub, ref_sub = _luts("full_subtractor", radix, blk)
    out = _check(
        lambda x, s, e: ap.ripple_sub(x, sub, width, 2 * width, stats=s,
                                      engine=e, device="cpu"),
        lambda x, s: ref_ap.ripple_sub(x, ref_sub, width, 2 * width,
                                       stats=s), arr, radix)
    got = ap.decode_digits(out, list(range(width, 2 * width)), radix)
    assert np.array_equal(got, (a - b) % radix ** width)


@pytest.mark.parametrize("radix", [3, 5])
def test_negate(radix):
    w, rows = 3, 120
    b = np.random.default_rng(radix).integers(0, radix ** w, rows)
    arr = np.zeros((rows, 2 * w + 1), np.int8)
    for i in range(w):
        arr[:, i] = (b // radix ** i) % radix
    not_copy, ref_not_copy = _luts("not_copy", radix, False)
    half, ref_half = _luts("half_adder", radix, False)
    out = _check(
        lambda x, s, e: ap.negate(x, not_copy, half, w, 0, w, 2 * w,
                                  stats=s, engine=e, device="cpu"),
        lambda x, s: ref_ap.negate(x, ref_not_copy, ref_half, w, 0, w,
                                   2 * w, stats=s), arr, radix)
    got = ap.decode_digits(out, list(range(w, 2 * w)), radix)
    assert np.array_equal(got, (-b) % radix ** w)


@pytest.mark.parametrize("fn", ["min", "max", "modsum", "nand"])
def test_elementwise(fn):
    radix, w, rows = 3, 4, 100
    rng = np.random.default_rng(len(fn))
    arr = rng.integers(0, radix, (rows, 2 * w)).astype(np.int8)
    lut, ref_lut = _luts(fn, radix, fn == "max")
    _check(lambda x, s, e: ap.elementwise(x, lut, w, stats=s, engine=e,
                                          device="cpu"),
           lambda x, s: ref_ap.elementwise(x, ref_lut, w, stats=s),
           arr, radix)


@pytest.mark.parametrize("radix,w", [(3, 2), (4, 2)])
def test_multiply(radix, w):
    rows = 80
    rng = np.random.default_rng(w + radix)
    a = rng.integers(0, radix ** w, rows)
    b = rng.integers(0, radix ** w, rows)
    arr = np.zeros((rows, 5 * w + 1), np.int8)
    for i in range(w):
        arr[:, i] = arr[:, w + i] = (a // radix ** i) % radix
        arr[:, 2 * w + i] = (b // radix ** i) % radix
    add, ref_add = _luts("full_adder", radix, False)
    half, ref_half = _luts("half_adder", radix, False)
    args = (w, radix, 0, w, 2 * w, 3 * w, 5 * w)
    out = _check(
        lambda x, s, e: ap.multiply(x, add, half, *args, stats=s, engine=e,
                                    device="cpu"),
        lambda x, s: ref_ap.multiply(x, ref_add, ref_half, *args, stats=s),
        arr, radix)
    got = ap.decode_digits(out, list(range(3 * w, 5 * w)), radix)
    assert np.array_equal(got, a * b)


def test_primitives_match_reference():
    arr = np.random.default_rng(0).integers(-1, 4, (64, 5)).astype(np.int8)
    t, j = torch.from_numpy(arr), jnp.asarray(arr)
    cols, key = (0, 2, 4), (1, 0, 2)
    assert np.array_equal(ap.compare(t, cols, key).numpy(),
                          np.asarray(ref_ap.compare(j, cols, key)))
    assert np.array_equal(ap.mismatch_count(t, cols, key).numpy(),
                          np.asarray(ref_ap.mismatch_count(j, cols, key)))
    tag = ap.compare(t, (1,), (2,))
    new, s, r = ap.write(t, tag, (3, 3, 0), (1, 2, 0))
    want, ws, wr = ref_ap.write(j, jnp.asarray(tag.numpy()), (3, 3, 0),
                                (1, 2, 0))
    assert np.array_equal(new.numpy(), np.asarray(want))
    assert (int(s), int(r)) == (int(ws), int(wr))
    assert np.array_equal(t.numpy(), arr)          # write does not mutate


def test_apply_lut_extra_key_matches_reference():
    arr = np.random.default_rng(1).integers(0, 3, (90, 6)).astype(np.int8)
    lut, ref_lut = _luts("full_adder", 3, True)
    extra = ((5, 1), (4, 2))
    stats, want_stats = ap.APStats(radix=3), ref_ap.APStats(radix=3)
    out = ap.apply_lut(torch.from_numpy(arr), lut, (0, 1, 2), extra,
                       stats=stats)
    want = ref_ap.apply_lut(jnp.asarray(arr), ref_lut, (0, 1, 2), extra,
                            stats=want_stats)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert stats_fields(stats) == stats_fields(want_stats)
    pure = ap.apply_lut_pure(torch.from_numpy(arr), lut, (0, 1, 2), extra)
    assert torch.equal(pure, out)


def test_energy_from_equal_stats():
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 10 ** 6, 8)
    fields = dict(n_rows=512, n_compare_cycles=420, n_write_cycles=421,
                  sets=123456, resets=120000)
    for radix in (2, 3):
        ours = ap_stats_from_fields(radix, mismatch_hist=hist, **fields)
        theirs = ref_ap.APStats(radix=radix, **fields)
        theirs.mismatch_hist = hist.astype(np.int64)
        for n_masked in (2, 3, 5):
            a = energy.energy_from_stats(ours, n_masked,
                                         CellParams(radix=radix))
            b = ref_energy.energy_from_stats(theirs, n_masked,
                                             RefCellParams(radix=radix))
            assert (a.write_energy_j, a.compare_energy_j, a.sets,
                    a.resets, a.total_j) == (
                b.write_energy_j, b.compare_energy_j, b.sets, b.resets,
                b.total_j)
    assert energy.area_table() == ref_energy.area_table()
    assert energy.EQUIV_WIDTHS == ref_energy.EQUIV_WIDTHS


@pytest.mark.parametrize("radix,width", [(2, 8), (3, 5), (2, 32), (3, 20)])
def test_table_xi_pairs_match_reference_benchmark(radix, width):
    """The 8b/5t and 32b/20t pairs of Table XI: the reference benchmark's
    simulation against the port's fused add on the same seeded digits."""
    from benchmarks.table_xi import simulate
    want_stats, want_rep = simulate(radix, width, 64)
    rng = np.random.default_rng(0)                 # simulate's own seed
    a_d = rng.integers(0, radix, size=(64, width)).astype(np.int8)
    b_d = rng.integers(0, radix, size=(64, width)).astype(np.int8)
    arr = np.concatenate([a_d, b_d, np.zeros((64, 1), np.int8)], axis=1)
    stats = ap.APStats(radix=radix)
    lut = build_lut_nonblocked(tt.full_adder(radix))
    ap.ripple_add(arr, lut, width, carry_col=2 * width, stats=stats,
                  engine="apc", device="cpu")
    assert stats_fields(stats) == stats_fields(want_stats)
    rep = energy.energy_from_stats(stats, n_masked=3,
                                   params=CellParams(radix=radix))
    assert (rep.write_energy_j, rep.compare_energy_j, rep.total_j) == (
        want_rep.write_energy_j, want_rep.compare_energy_j,
        want_rep.total_j)
