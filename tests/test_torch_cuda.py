"""The CUDA kernels against their plain versions, on the card.  Marked
``cuda``: they skip on a host without one.  Run them on a machine with a
card: ``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``
(``python3 chip_smoke.py`` covers the same ground at full size)."""
import numpy as np
import pytest
import torch

from repro_torch import apc
from repro_torch.core import build_lut_blocked, build_lut_nonblocked
from repro_torch.core import truth_tables as tt
from repro_torch.kernels.tap_pass import kernel, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _digits(rows, cols, radix, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -1, radix + 1, (rows, cols)).astype(np.int8))


@pytest.mark.parametrize("kv", ["gather", "onehot", "onehot_packed"])
@pytest.mark.parametrize("fn,radix,width,blk", [
    ("add", 3, 20, False), ("add", 3, 20, True), ("mul", 3, 5, False),
    ("max", 3, 8, False), ("sub", 5, 8, True),
    ("add", 2, 128, False), ("add", 3, 80, False)])
@pytest.mark.parametrize("stats", [True, False])
def test_program_kernel_matches_plain(dev, fn, radix, width, blk, kv,
                                      stats):
    compiled = apc.compile_named(fn, radix, width, blocked=blk)
    sched, _, pack, _ = apc.resolve_schedule(compiled, kv)
    arr = _digits(384, compiled.min_cols + 1, radix, width).to(dev)
    out, counts = kernel.tap_run_program(arr, *sched, 333, block_rows=128,
                                         collect_stats=stats, pack=pack)
    want, want_counts = ref.run_program_plain(
        arr, *sched, 333, block_rows=128, collect_stats=stats, pack=pack)
    assert torch.equal(out, want)
    if stats:
        assert torch.equal(counts, want_counts)


@pytest.mark.parametrize("blk", [False, True])
def test_schedule_kernel_matches_plain(dev, blk):
    build = build_lut_blocked if blk else build_lut_nonblocked
    sched = ref.ripple_add_schedule(build(tt.full_adder(3)), 3, 6)
    arr = _digits(4096, 7, 3, 1).to(dev)
    assert torch.equal(kernel.tap_apply_schedule(arr, sched),
                       ref.apply_schedule(arr, sched))


def _any_int8(rng, n, radix=3):
    """n int8 values: mostly -1..radix, the rest anywhere in int8."""
    return tuple(int(v) for v in np.where(
        rng.random(n) < 0.7, rng.integers(-1, radix + 1, n),
        rng.integers(-128, 128, n)))


def _random_steps(rng, n_steps, K, C, W, cols, duplicate_writes):
    """A step tuple whose first step has K keys over C compare columns and
    W write columns; the others fewer (-1 padding in the dense form), some
    with no key (unconditional) or keys over no column (match every row).
    Compare columns may repeat; write columns repeat only with
    ``duplicate_writes``."""
    steps = []
    for s in range(n_steps):
        nc, nk, nw = ((C, K, W) if s == 0 else
                      (rng.integers(0, C + 1), rng.integers(0, K + 1),
                       rng.integers(1, W + 1)))
        cc = tuple(int(c) for c in rng.integers(0, cols, nc))
        keys = tuple(_any_int8(rng, nc) for _ in range(nk))
        if duplicate_writes and nw > 1:
            wc = rng.integers(0, cols, nw)
            wc[1] = wc[0]
        else:
            wc = rng.choice(cols, nw, replace=False)
        steps.append((keys, cc, tuple(int(c) for c in wc),
                      _any_int8(rng, nw)))
    return tuple(steps)


@pytest.mark.parametrize("rows", [4096, 1000, 13])
@pytest.mark.parametrize("K,C,W,dup,kind", [
    (1, 3, 3, False, 1),            # the unrolled slots
    (1, 4, 3, False, 2),
    (0, 2, 2, False, 1),            # no key anywhere: every row tagged
    (2, 3, 3, False, 0),            # the general slot
    (4, 6, 4, False, 0),
    (4, 6, 4, True, 0),
    (1, 3, 3, True, 0)])            # duplicate writes: the general slot
def test_schedule_kernel_random_schedules(dev, K, C, W, dup, kind, rows):
    """Random short schedules with any int8 keys and values, on digits
    -1..radix, rows not a multiple of 4 nor of a CTA: bit-identical to
    the plain version, one launch each, the slot kind ``choose_layout``
    gives."""
    rng = np.random.default_rng(K * 1000 + C * 100 + W * 10 + dup + rows)
    cols = 9
    sched = _random_steps(rng, 40, K, C, W, cols, dup)
    assert kernel.schedule_plan(sched, cols, dev).kind == kind
    arr = _digits(rows, cols, 3, rows + K).to(dev)
    before = kernel.launch_counts["tap_apply_schedule"]
    out = kernel.tap_apply_schedule(arr, sched, block_rows=rows)
    assert kernel.launch_counts["tap_apply_schedule"] == before + 1
    assert torch.equal(out, ref.apply_schedule(arr, sched))


# ---------------------------------------------------------------------------
# The packed-ternary matmul kernel
# ---------------------------------------------------------------------------

ODD_SHAPES = [(1, 17, 1), (3, 17, 130), (1, 1000, 130), (3, 1000, 1),
              (8, 16, 8), (100, 300, 96), (17, 64, 129), (40, 513, 257)]


def _packed_case(m, k, n, seed, dtype):
    from repro_torch.kernels.ternary_matmul import quantize_and_pack
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32))
    packed, scale = quantize_and_pack(w)
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    return x.to(dtype), packed, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", ODD_SHAPES)
def test_ternary_matmul_kernel_matches_plain(dev, m, k, n, dtype):
    """fp32 sums in another order than the plain version's matmul: within
    1e-4 (fp32) / 5e-2 (bf16, one rounding of the output), as the
    reference's own kernel test holds it."""
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref
    x, packed, scale = _packed_case(m, k, n, m * 1000 + k + n, dtype)
    x, packed, scale = x.to(dev), packed.to(dev), scale.to(dev)
    before = dict(tk.launch_counts)
    y = tk.ternary_matmul(x, packed, scale)
    torch.cuda.synchronize()
    ran = tk.kernel_for(dtype, m)
    assert tk.launch_counts == {k: n + (k == ran) for k, n in before.items()}
    want = ternary_matmul_ref(x, packed, scale)
    assert y.dtype == dtype and y.shape == (m, n)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(y.float(), want.float(), atol=tol, rtol=tol)


def test_ternary_matmul_kernel_exact_on_integers(dev):
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import pack_ternary
    rng = np.random.default_rng(7)
    w_t = torch.from_numpy(rng.integers(-1, 2, (1024, 130)).astype(np.int8))
    x = torch.from_numpy(rng.integers(-7, 8, (5, 1024)).astype(np.float32))
    y = tk.ternary_matmul(x.to(dev), pack_ternary(w_t).to(dev),
                          torch.ones(130, device=dev))
    assert torch.equal(y.cpu(), x @ w_t.float())


def test_ternary_matmul_kernel_refuses_other_dtypes(dev):
    from repro_torch.kernels.ternary_matmul import kernel as tk
    x, packed, scale = _packed_case(4, 32, 8, 0, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk.ternary_matmul(x.to(dev), packed.to(dev), scale.to(dev))


def test_failed_build_raises_and_does_not_fall_back(dev, tmp_path,
                                                    monkeypatch):
    """A kernel whose source does not compile raises on CUDA tensors; the
    plain version is never taken and no launch is counted."""
    import dataclasses

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.ternary_matmul import kernel as tk
    (tmp_path / "ternary_matmul.cu").write_text("this is not CUDA C++\n")
    broken = dataclasses.replace(cuda_lib.LIBRARIES["ternary_matmul"],
                                 csrc=tmp_path)
    monkeypatch.setitem(cuda_lib.LIBRARIES, "ternary_matmul", broken)
    monkeypatch.setattr(cuda_lib, "_entries", {})
    x, packed, scale = _packed_case(4, 32, 8, 0, torch.float32)
    before = tk.launch_counts["ternary_matmul"]
    with pytest.raises(RuntimeError, match="build failed"):
        tk.ternary_matmul(x.to(dev), packed.to(dev), scale.to(dev))
    assert tk.launch_counts["ternary_matmul"] == before


# ---------------------------------------------------------------------------
# The packed-ternary matmul on the tensor cores (bf16, M >= 16)
# ---------------------------------------------------------------------------

TC_SHAPES = [(16, 17, 1), (17, 64, 129), (100, 300, 96), (128, 1000, 130),
             (129, 513, 257), (2048, 1024, 3072), (16, 3072, 1024),
             (2048, 3072, 1024)]
# (tokens, outputs, K split) of the tensor-core kernel: every tile of
# both dtypes, and K splits over clusters of 2 and 8
TC_FORCED = [(16, 64, 1), (64, 64, 1), (64, 128, 1), (128, 128, 1),
             (64, 256, 1), (16, 64, 8), (64, 128, 2)]


def _tc_call(tk, x, packed, scale):
    """One call that must launch the tensor-core kernel and nothing else."""
    before = dict(tk.launch_counts)
    y = tk.ternary_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert tk.launch_counts == {
        k: n + (k == "ternary_matmul_tc") for k, n in before.items()}
    return y


@pytest.mark.parametrize("m,k,n", TC_SHAPES)
def test_tensor_core_kernel_matches_plain(dev, m, k, n):
    """bf16 x on the tensor cores within 5e-2 of the plain version (the
    reference's bf16 tolerance), one launch of the tensor-core kernel and
    none of the CUDA-core kernel per call."""
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref
    x, packed, scale = _packed_case(m, k, n, m * 1000 + k + n,
                                    torch.bfloat16)
    x, packed, scale = x.to(dev), packed.to(dev), scale.to(dev)
    y = _tc_call(tk, x, packed, scale)
    want = ternary_matmul_ref(x, packed, scale)
    assert y.dtype == torch.bfloat16 and y.shape == (m, n)
    torch.testing.assert_close(y.float(), want.float(), atol=5e-2,
                               rtol=5e-2)


@pytest.mark.parametrize("dtype,shape", [
    (dtype, shape) for dtype in (torch.bfloat16, torch.float32)
    for shape in TC_FORCED] + [(torch.bfloat16, (256, 128, 1)),
                               (torch.bfloat16, (128, 256, 1))])
@pytest.mark.parametrize("m,k,n", [(16, 1024, 3072), (2048, 1024, 3072),
                                   (129, 513, 257)])
def test_tensor_core_integers_bit_identical(dev, m, k, n, shape, dtype):
    """Integer activations |x| <= 7: every fp32 sum is exact, also each
    partial of a K split, and both sides round acc * scale once, so y
    equals the plain version's bit for bit, at every tile and split."""
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import (pack_ternary,
                                                        ternary_matmul_ref)
    rng = np.random.default_rng(m + k + n)
    kp = -(-k // 16) * 16
    w_t = torch.from_numpy(rng.integers(-1, 2, (kp, n)).astype(np.int8))
    x = torch.from_numpy(rng.integers(-7, 8, (m, k)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.01, 0.05, n).astype(np.float32))
    x = x.to(dev, dtype)
    packed, scale = pack_ternary(w_t).to(dev), scale.to(dev)
    y = tk._launch_tensor_cores(x, packed, scale, shape=shape)
    assert torch.equal(y, ternary_matmul_ref(x, packed, scale))


def test_tensor_core_x_narrower_than_packed_k(dev):
    """x with K = 40 against K' = 64 words (the last 24 trits nonzero): the
    missing columns count as zero, as in the plain version."""
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import (pack_ternary,
                                                        ternary_matmul_ref)
    rng = np.random.default_rng(3)
    w_t = torch.from_numpy(rng.integers(-1, 2, (64, 96)).astype(np.int8))
    x = torch.from_numpy(rng.integers(-7, 8, (48, 40)).astype(np.float32))
    x = x.to(dev, torch.bfloat16)
    packed, ones = pack_ternary(w_t).to(dev), torch.ones(96, device=dev)
    y = _tc_call(tk, x, packed, ones)
    assert torch.equal(y, ternary_matmul_ref(x, packed, ones))
    want = x.double() @ w_t[:40].to(dev, torch.double)
    assert torch.equal(y.double(), want.to(torch.bfloat16).double())


def test_tensor_core_failed_build_raises_and_does_not_fall_back(
        dev, tmp_path, monkeypatch):
    """A tensor-core kernel whose source does not compile raises on a bf16
    call with M >= 16; neither the CUDA-core kernel nor the plain version
    is taken, and no launch is counted."""
    import dataclasses

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.ternary_matmul import kernel as tk
    (tmp_path / "ternary_matmul_tc.cu").write_text("this is not CUDA C++\n")
    broken = dataclasses.replace(cuda_lib.LIBRARIES["ternary_matmul_tc"],
                                 csrc=tmp_path)
    monkeypatch.setitem(cuda_lib.LIBRARIES, "ternary_matmul_tc", broken)
    monkeypatch.setattr(cuda_lib, "_entries", {})
    x, packed, scale = _packed_case(32, 64, 16, 0, torch.bfloat16)
    before = dict(tk.launch_counts)
    with pytest.raises(RuntimeError, match="build failed"):
        tk.ternary_matmul(x.to(dev), packed.to(dev), scale.to(dev))
    assert tk.launch_counts == before


def test_ap_matmul_on_the_card_matches_ref(dev):
    """The K-tiled AP matmul through the program kernel: bit-identical to
    impl="ref", cycles equal to the schedule's static counts."""
    from repro_torch.core.ap import APStats
    from repro_torch.kernels.ternary_matmul import ternary_matmul
    from repro_torch.kernels.ternary_matmul.ap import ap_matmul_cycle_counts
    x, packed, scale = _packed_case(3, 40, 24, 5, torch.float32)
    x = torch.round(x * 3).to(dev)
    packed, scale = packed.to(dev), scale.to(dev)
    st = APStats(radix=3)
    y = ternary_matmul(x, packed, scale, impl="ap", k_tile=7, stats=st)
    assert torch.equal(y, ternary_matmul(x, packed, scale, impl="ref"))
    width = apc.mac_acc_width(3, 48, int(x.abs().max()))
    cyc = ap_matmul_cycle_counts(3, 48, width, k_tile=7)
    assert (st.n_write_cycles, st.n_compare_cycles) == (
        cyc["write_cycles"], cyc["compare_cycles"])


# ---------------------------------------------------------------------------
# The program kernel's semantics (four rows per thread, slot records)
# ---------------------------------------------------------------------------

VARIANTS = ("gather", "onehot", "onehot_packed")
MAX_SLOTS = 3000          # the plain replay's time grows with the slots


def _program_at(cols):
    """A program of 41 (add 3x20), 145 (the AP matmul's reduction) or 650
    (its tile program) columns."""
    if cols == 41:
        return apc.compile_named("add", 3, 20)
    width = apc.mac_acc_width(3, 1024, 7)
    tiled = apc.compile_mac_tiled(3, 1024, width, 64)
    return tiled.programs[0] if cols == 650 else tiled.reduce_programs[0]


def _first_slots(sched, pack, n=MAX_SLOTS):
    """The schedule's first n slots (whole groups of pack)."""
    keep = min(sched[0].shape[0], n // pack * pack)
    return tuple(t[:keep] for t in sched)


@pytest.mark.parametrize("kv", VARIANTS)
@pytest.mark.parametrize("cols", [41, 145, 650])
@pytest.mark.parametrize("rows,block_rows,n_valid", [
    (1000, 10, 955),          # blocks smaller than a CTA's rows
    (8192, 4096, 8000)])      # blocks of several CTAs
def test_program_kernel_at_widths_and_blocks(dev, cols, kv, rows,
                                             block_rows, n_valid):
    """Digits of every value a cell may hold (-1, 0..radix), padding rows
    past n_valid, each schedule form: digits and every counter row equal
    to the plain version, counters on and off."""
    prog = _program_at(cols)
    assert prog.min_cols == cols
    sched, _, pack, _ = apc.resolve_schedule(prog, kv)
    sched = _first_slots(sched, pack)
    arr = _digits(rows, cols, 3, cols + rows).to(dev)
    for stats in (True, False):
        out, counts = kernel.tap_run_program(
            arr, *sched, n_valid, block_rows=block_rows,
            collect_stats=stats, pack=pack)
        want, want_counts = ref.run_program_plain(
            arr, *sched, n_valid, block_rows=block_rows,
            collect_stats=stats, pack=pack)
        assert torch.equal(out, want)
        if stats:
            assert counts.shape == (rows // block_rows, 10)
            assert torch.equal(counts, want_counts)


def _random_schedule(rng, S, K, C, W, cols, distinct_writes):
    """Any int8 keys and values, columns past ``cols`` and -1 padding,
    slots with no valid key, histogram flags on and off."""
    cmp_cols = rng.integers(-1, cols + 3, (S, C))
    keys = np.where(rng.random((S, K, C)) < 0.7,
                    rng.integers(-1, 3, (S, K, C)),
                    rng.integers(-128, 128, (S, K, C)))
    key_valid = rng.random((S, K)) < 0.7
    hist_flag = rng.random(S) < 0.8
    if distinct_writes:
        wr_cols = np.stack([rng.choice(cols + 3, W, replace=False) - 1
                            for _ in range(S)])
    else:                              # duplicates apply serially
        wr_cols = rng.integers(-1, cols + 2, (S, W))
        wr_cols[:, 1] = wr_cols[:, 0]
    wr_vals = np.where(rng.random((S, W)) < 0.7, rng.integers(-1, 3, (S, W)),
                       rng.integers(-128, 128, (S, W)))
    return (cmp_cols.astype(np.int32), keys.astype(np.int8), key_valid,
            hist_flag, wr_cols.astype(np.int32), wr_vals.astype(np.int8))


@pytest.mark.parametrize("K,C,W,pack,distinct,kind", [
    (1, 3, 3, 1, True, 1),          # the unrolled kernels
    (1, 4, 3, 1, True, 2),
    (1, 2, 1, 1, True, 1),
    (3, 12, 4, 1, False, 0),        # the general kernel: mm past bin 7
    (2, 4, 3, 1, True, 0),
    (1, 4, 3, 2, True, 0),          # groups: tags against the pre-group row
    (2, 3, 2, 4, False, 0)])
def test_program_kernel_random_schedules(dev, K, C, W, pack, distinct,
                                         kind):
    """Every semantic at once, on any int8 digits: -1 matches any key,
    columns outside [0, cols) are skipped, a slot with no valid key writes
    unconditionally, duplicate compare columns count per position,
    duplicate write columns apply serially, groups of ``pack`` tag against
    the pre-group row, rows past n_valid are untouched and uncounted, the
    histogram is per valid key on histogram slots with its top bin
    saturating.  The plain version reads a skipped column as -1."""
    from repro_torch.kernels.tap_pass.records import choose_layout
    rng = np.random.default_rng(K * 100 + C * 10 + W + pack)
    cols = 40
    sched = _random_schedule(rng, 96, K, C, W, cols, distinct)
    assert choose_layout(sched, pack)[0] == kind
    plain = list(sched)
    plain[0] = np.where(sched[0] < cols, sched[0], -1).astype(np.int32)
    plain[4] = np.where(sched[4] < cols, sched[4], -1).astype(np.int32)
    digits = np.where(rng.random((515, cols)) < 0.6,
                      rng.integers(-1, 3, (515, cols)),
                      rng.integers(-128, 128, (515, cols))).astype(np.int8)
    arr = torch.from_numpy(digits).to(dev)
    on_dev = tuple(torch.from_numpy(t).to(dev) for t in sched)
    for block_rows in (5, 103, 515):
        out, counts = kernel.tap_run_program(
            arr, *on_dev, 500, block_rows=block_rows, collect_stats=True,
            pack=pack)
        want, want_counts = ref.run_program_plain(
            arr, *(torch.from_numpy(t).to(dev) for t in plain), 500,
            block_rows=block_rows, collect_stats=True, pack=pack)
        assert torch.equal(out, want)
        assert torch.equal(counts, want_counts)
        assert torch.equal(out[500:], arr[500:])


@pytest.mark.parametrize("K,C,W,pack,distinct,kind", [
    (1, 3, 3, 1, True, 1), (1, 4, 3, 1, True, 2),
    (3, 12, 4, 1, False, 0), (2, 3, 2, 4, False, 0)])
@pytest.mark.parametrize("stats", [True, False])
def test_program_kernel_block_valid_random_schedules(dev, K, C, W, pack,
                                                     distinct, kind, stats):
    """Per-block valid rows: random schedules, block counts and valid
    counts from 1 to block_rows; rows past a block's count are untouched
    and uncounted, and ``n_valid`` is not read."""
    from repro_torch.kernels.tap_pass.records import choose_layout
    rng = np.random.default_rng(K * 100 + C * 10 + W + pack + 7)
    cols = 40
    sched = _random_schedule(rng, 64, K, C, W, cols, distinct)
    assert choose_layout(sched, pack)[0] == kind
    plain = list(sched)
    plain[0] = np.where(sched[0] < cols, sched[0], -1).astype(np.int32)
    plain[4] = np.where(sched[4] < cols, sched[4], -1).astype(np.int32)
    on_dev = tuple(torch.from_numpy(t).to(dev) for t in sched)
    plain = tuple(torch.from_numpy(t).to(dev) for t in plain)
    for block_rows, n_blocks in ((5, 7), (103, 3), (1024, 2), (4096, 5)):
        rows = block_rows * n_blocks
        digits = np.where(rng.random((rows, cols)) < 0.6,
                          rng.integers(-1, 3, (rows, cols)),
                          rng.integers(-128, 128, (rows, cols)))
        arr = torch.from_numpy(digits.astype(np.int8)).to(dev)
        bv = rng.integers(1, block_rows + 1, n_blocks)
        bv[0], bv[-1] = 1, block_rows
        bv = torch.from_numpy(bv.astype(np.int32)).to(dev)
        out, counts = kernel.tap_run_program(
            arr, *on_dev, 0, block_rows=block_rows, collect_stats=stats,
            pack=pack, block_valid=bv)
        want, want_counts = ref.run_program_plain(
            arr, *plain, 0, block_rows=block_rows, collect_stats=stats,
            pack=pack, block_valid=bv)
        assert torch.equal(out, want)
        if stats:
            assert torch.equal(counts, want_counts)
        pad = (torch.arange(block_rows, device=dev)[None, :]
               >= bv[:, None].long()).reshape(-1)
        assert torch.equal(out[pad], arr[pad])
    with pytest.raises(ValueError, match="block_valid"):
        kernel.tap_run_program(arr, *on_dev, 0, block_rows=block_rows,
                               block_valid=bv[:-1])


def test_pool_and_runtime_on_the_card_match_the_cpu(dev):
    """ArrayPool.run (fault-free, block_valid, faulty) and Runtime.run_graph
    over coalesced MAC graphs on cuda:0 give the CPU port's digits, counter
    rows and fault state; a fault-free pool.run is one launch."""
    from repro_torch.core import ap
    rng = np.random.default_rng(3)
    r, w, rows = 3, 20, 3 * 4096 + 100
    arr = ap.encode_operands(rng.integers(0, r ** w, rows),
                             rng.integers(0, r ** w, rows), r, w)
    compiled = apc.compile_named("add", r, w)
    for kw, bv in (({}, None), ({}, (4096, 1, 77)),
                   ({"faults": apc.FaultConfig(flip_rate=1e-5, seed=1,
                                               dead_arrays=(2,),
                                               retire_after=100)}, None)):
        got = []
        for d in (dev, "cpu"):
            pool = apc.ArrayPool(4, 4096, 2 * w + 2, device=d, **kw)
            a = arr[:3 * 4096] if bv else arr
            before = kernel.launch_counts["tap_run_program"]
            out, tr = pool.run(a, compiled, collect_stats=True,
                               block_valid=bv, radix=r)
            if d is dev and "faults" not in kw:
                assert kernel.launch_counts["tap_run_program"] == before + 1
            got.append((out.cpu(), tr.block_counts.cpu(),
                        pool.fault_model and pool.fault_model.snapshot()))
        assert torch.equal(got[0][0], got[1][0])
        assert torch.equal(got[0][1], got[1][1])
        assert got[0][2] == got[1][2]
    radix, K, max_abs = 3, 40, 3
    width = apc.mac_acc_width(radix, K, max_abs)
    tiled = apc.compile_mac_tiled(radix, K, width, 16)
    macs = [(rng.integers(-max_abs, max_abs + 1, (n, K)),
             rng.integers(-1, 2, (n, K))) for n in (1000, 333)]
    results = []
    for d in (dev, "cpu"):
        graphs = [apc.ProgramGraph() for _ in macs]
        for g, (x, wt) in zip(graphs, macs):
            g.add_mac_tiled(torch.from_numpy(x).to(d),
                            torch.from_numpy(wt).to(d), tiled)
        merged, _ = apc.coalesce_graphs(graphs, block_rows=256)
        assert any(n.block_valid for n in merged.nodes)
        pool = apc.ArrayPool(4, 256, tiled.min_cols, device=d)
        res = apc.Runtime(pool).run_graph(merged, collect_stats=True)
        results.append(res)
    for nid in results[1]:
        assert torch.equal(results[0][nid].cpu(), results[1][nid])
        assert torch.equal(results[0].traced[nid].block_counts.cpu(),
                           results[1].traced[nid].block_counts)
    assert results[0].report == results[1].report


def test_program_records_cached_per_program(dev):
    """The records are encoded once per schedule tensors and column count;
    an in-place change of a schedule tensor encodes them again."""
    compiled = apc.compile_named("add", 3, 4)
    sched = tuple(torch.from_numpy(np.asarray(t)).to(dev)
                  for t in compiled.schedule_tensors)
    first = kernel.program_records(sched, 13, 1, dev)
    assert kernel.program_records(sched, 13, 1, dev) is first
    assert kernel.program_records(sched, 14, 1, dev) is not first
    sched[5].add_(0)
    assert kernel.program_records(sched, 13, 1, dev) is not first


# ---------------------------------------------------------------------------
# The packed-ternary matmul: fp32 on the tensor cores, and decode
# ---------------------------------------------------------------------------

FP32_TC_SHAPES = [(16, 17, 129), (17, 300, 257), (2048, 513, 130),
                  (16, 513, 1), (17, 17, 96), (2048, 300, 3072),
                  (2048, 1024, 3072), (16, 3072, 1024), (2048, 3072, 1024)]


def _routed(tk, x, packed, scale, name):
    before = dict(tk.launch_counts)
    y = tk.ternary_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert tk.kernel_for(x.dtype, x.shape[0]) == name
    assert tk.launch_counts == {k: n + (k == name)
                                for k, n in before.items()}
    return y


@pytest.mark.parametrize("m,k,n", FP32_TC_SHAPES)
def test_fp32_on_tensor_cores(dev, m, k, n):
    """fp32 x with M >= 16 runs on the tensor cores as three bf16 passes:
    within 1e-4 of the plain version, and bit for bit on integers (|x| <=
    7, and up to 2^19 at K = 17)."""
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import (pack_ternary,
                                                        ternary_matmul_ref)
    x, packed, scale = _packed_case(m, k, n, m + k + n, torch.float32)
    x, packed, scale = x.to(dev), packed.to(dev), scale.to(dev)
    y = _routed(tk, x, packed, scale, "ternary_matmul_tc")
    assert y.dtype == torch.float32 and y.shape == (m, n)
    torch.testing.assert_close(y, ternary_matmul_ref(x, packed, scale),
                               atol=1e-4, rtol=1e-4)
    rng = np.random.default_rng(m * k)
    big = (1 << 19) - 1 if k == 17 else 7
    w_t = torch.from_numpy(
        rng.integers(-1, 2, (-(-k // 16) * 16, n)).astype(np.int8))
    xi = torch.from_numpy(rng.integers(-big, big + 1, (m, k)).astype(
        np.float32)).to(dev)
    packed = pack_ternary(w_t).to(dev)
    y = _routed(tk, xi, packed, scale, "ternary_matmul_tc")
    assert torch.equal(y, ternary_matmul_ref(xi, packed, scale))


def test_fp32_on_tensor_cores_unaligned_rows(dev):
    """x whose rows do not start on 16 bytes (an offset storage, K = 300)
    takes the element-by-element staging: the same result."""
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref
    x, packed, scale = _packed_case(40, 300, 130, 9, torch.float32)
    buf = torch.empty(40 * 300 + 1, device=dev)
    xu = buf[1:].view(40, 300)
    xu.copy_(x.to(dev))
    assert xu.data_ptr() % 16 != 0 and xu.is_contiguous()
    packed, scale = packed.to(dev), scale.to(dev)
    y = _routed(tk, xu, packed, scale, "ternary_matmul_tc")
    torch.testing.assert_close(y, ternary_matmul_ref(xu, packed, scale),
                               atol=1e-4, rtol=1e-4)
    for shape in TC_FORCED:
        torch.testing.assert_close(
            tk._launch_tensor_cores(xu, packed, scale, shape=shape), y,
            atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 8, 15])
def test_decode_on_cuda_cores(dev, m, dtype):
    """Decode batches (M < 16) run on the CUDA-core kernel with its grid
    spread over the card (K split over a cluster at qwen3-0.6b's widths):
    within tolerance of the plain version, exact on integers."""
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import (pack_ternary,
                                                        ternary_matmul_ref)
    for k, n in ((1024, 3072), (3072, 1024), (1000, 130)):
        x, packed, scale = _packed_case(m, k, n, m + k, dtype)
        x, packed, scale = x.to(dev), packed.to(dev), scale.to(dev)
        y = _routed(tk, x, packed, scale, "ternary_matmul")
        tol = 1e-4 if dtype == torch.float32 else 5e-2
        torch.testing.assert_close(
            y.float(), ternary_matmul_ref(x, packed, scale).float(),
            atol=tol, rtol=tol)
        rng = np.random.default_rng(k + m)
        w_t = torch.from_numpy(
            rng.integers(-1, 2, (-(-k // 16) * 16, n)).astype(np.int8))
        xi = torch.from_numpy(rng.integers(-7, 8, (m, k)).astype(
            np.float32)).to(dev, dtype)
        packed = pack_ternary(w_t).to(dev)
        y = _routed(tk, xi, packed, scale, "ternary_matmul")
        assert torch.equal(y, ternary_matmul_ref(xi, packed, scale))


# ---------------------------------------------------------------------------
# The packed matmul at qwen2-72b's MLP width (K = 8192)
# ---------------------------------------------------------------------------

QWEN2_72B = (8192, 29568)           # w1: d_model x d_ff


@pytest.fixture(scope="module")
def qwen2_72b_w1():
    """Seeded trits and scales at qwen2-72b's w1, packed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.ternary_matmul.ref import PACK, pack_ternary
    dev = torch.device("cuda", 0)
    k, n = QWEN2_72B
    gen = torch.Generator(device=dev)
    gen.manual_seed(72)
    packed = torch.empty((k // PACK, n), dtype=torch.int32, device=dev)
    for lo in range(0, k, 1024):
        packed[lo // PACK:(lo + 1024) // PACK] = pack_ternary(torch.randint(
            -1, 2, (1024, n), generator=gen, device=dev, dtype=torch.int8))
    scale = torch.rand(n, generator=gen, device=dev) * 0.04 + 0.01
    return packed, scale, gen


@pytest.mark.parametrize("kname", ["ternary_matmul", "ternary_matmul_tc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 16])
def test_packed_matmul_at_k8192(dev, qwen2_72b_w1, m, dtype, kname):
    """Both kernels at qwen2-72b's w1 (K = 8192, N = 29568), routed or not:
    within 1e-4 (fp32) / 5e-2 (bf16) of the plain version, and bit for bit
    on integer activations |x| <= 7."""
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref
    packed, scale, gen = qwen2_72b_w1
    launch = {"ternary_matmul": tk._launch_cuda_cores,
              "ternary_matmul_tc": tk._launch_tensor_cores}[kname]
    x = torch.randn((m, QWEN2_72B[0]), generator=gen, device=dev).to(dtype)
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(
        launch(x, packed, scale).float(),
        ternary_matmul_ref(x, packed, scale).float(), atol=tol, rtol=tol)
    xi = torch.randint(-7, 8, (m, QWEN2_72B[0]), generator=gen,
                       device=dev).to(dtype)
    assert torch.equal(launch(xi, packed, scale),
                       ternary_matmul_ref(xi, packed, scale))


# ---------------------------------------------------------------------------
# The model stack with packed MLPs: the kernel route against the plain one
# ---------------------------------------------------------------------------

def _packed_qwen3_wide(dev, dtype):
    """qwen3-0.6b's smoke family at d_model 256, d_ff 768, packed MLPs."""
    from repro_torch import configs
    from repro_torch.models import model, quant
    cfg = configs.get_smoke_config("qwen3-0.6b").with_(
        d_model=256, d_ff=768, compute_dtype=dtype)
    params = quant.quantize_model_params(model.init_params(cfg, seed=0,
                                                           device=dev))
    return cfg, model.cast_params(cfg, params)


def _launches(tk, fn):
    before = dict(tk.launch_counts)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in tk.launch_counts.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_packed_model_kernel_route_matches_plain(dev, dtype, tol):
    """forward at 2 x 16 tokens (M = 32: the tensor cores) and a decode step
    at batch 2 (the CUDA cores), 3 launches per layer each, against
    ``plain_packed_mlp()`` on the same params (allclose, atol = rtol)."""
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.models import mlp, model
    cfg, params = _packed_qwen3_wide(dev, dtype)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16))).to(dev)
    n = 3 * cfg.n_layers
    with torch.inference_mode():
        got, moved = _launches(tk, lambda: model.forward(
            cfg, params, {"tokens": toks}))
        assert moved == {"ternary_matmul": 0, "ternary_matmul_tc": n}
        with mlp.plain_packed_mlp():
            want = model.forward(cfg, params, {"tokens": toks})
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        caches = [model.init_cache(cfg, 2, 32, device=dev) for _ in "ab"]
        for pos in range(3):
            (got, _), moved = _launches(tk, lambda: model.decode_step(
                cfg, params, caches[0], toks[:, pos], pos))
            assert moved == {"ternary_matmul": n, "ternary_matmul_tc": 0}
            with mlp.plain_packed_mlp():
                want, _ = model.decode_step(cfg, params, caches[1],
                                            toks[:, pos], pos)
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)


def test_plain_packed_mlp_launches_nothing(dev):
    from repro_torch.kernels.ternary_matmul import kernel as tk
    from repro_torch.models import mlp, model
    cfg, params = _packed_qwen3_wide(dev, "bfloat16")
    toks = torch.zeros((2, 16), dtype=torch.long, device=dev)
    with torch.inference_mode(), mlp.plain_packed_mlp():
        _, moved = _launches(tk, lambda: model.forward(
            cfg, params, {"tokens": toks}))
        cache = model.init_cache(cfg, 2, 32, device=dev)
        _, moved_dec = _launches(tk, lambda: model.decode_step(
            cfg, params, cache, toks[:, 0], 0))
    assert moved == moved_dec == {"ternary_matmul": 0,
                                  "ternary_matmul_tc": 0}


# ---------------------------------------------------------------------------
# AP-backed serving on the card (the tiny engine of tests/test_torch_serve.py
# in fp32, weights drawn on the CPU and moved)
# ---------------------------------------------------------------------------

def _tiny_ap_engine(device, params_cpu, cfg):
    from repro_torch.models import model
    from repro_torch.serve import Engine, ServeCfg
    params = model._tree_map(lambda t, _: t.to(device), params_cpu)
    ctx = apc.APServeContext(apc.Runtime(apc.ArrayPool(
        n_arrays=4, rows=64, cols=64, device=device)), x_levels=7)
    return Engine(cfg, params, ServeCfg(max_len=10), ap_ctx=ctx,
                  device=device)


@pytest.fixture(scope="module")
def tiny_fp32():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model
    from repro_torch.models.quant import quantize_model_params
    base = get_smoke_config("qwen3-0.6b")
    cfg = base.with_(n_layers=2, d_model=16, d_ff=24, n_heads=2,
                     n_kv_heads=2, head_dim=8, vocab=32,
                     compute_dtype="float32",
                     ternary=base.ternary.__class__(enabled=True))
    return cfg, model.cast_params(cfg, quantize_model_params(
        model.init_params(cfg, seed=0, device="cpu")))


def test_ap_engine_card_matches_cpu(dev, tiny_fp32):
    """Tokens and APStats of AP serving on the card equal the CPU's (the
    program kernel against its plain version, through the whole engine)."""
    cfg, params = tiny_fp32
    prompt = np.array([[3, 5, 7]], np.int32)
    out = []
    for where in (dev, torch.device("cpu")):
        eng = _tiny_ap_engine(where, params, cfg)
        before = kernel.launch_counts["tap_run_program"]
        toks = eng.generate(prompt, 3)
        rep = eng.ap_report()
        out.append((toks, rep,
                    kernel.launch_counts["tap_run_program"] - before))
    (card_toks, card_rep, launched), (cpu_toks, cpu_rep, _) = out
    np.testing.assert_array_equal(card_toks, cpu_toks)
    for key in ("sets", "resets", "write_cycles", "compare_cycles",
                "energy_total_j", "n_graphs", "n_programs",
                "makespan_cycles", "sequential_cycles"):
        assert card_rep[key] == cpu_rep[key], key
    assert launched == card_rep["n_programs"] and card_rep["n_graphs"] == 20


def test_ap_batched_matches_sequential_on_card(dev, tiny_fp32):
    from repro_torch.serve import AdmissionCfg, BatchServer
    cfg, params = tiny_fp32
    prompts = [np.array([[1 + i, 2 + i, 3 + i]], np.int32) for i in range(3)]
    eng = _tiny_ap_engine(dev, params, cfg)
    seq = []
    for p in prompts:
        toks = eng.generate(p, 2)
        seq.append((toks, eng.ap_report()))
    with BatchServer(eng, admission=AdmissionCfg(max_inflight=4)) as srv:
        handles = [srv.submit(p, 2) for p in prompts]
        got = [(h.result(timeout=300), h.ap_report()) for h in handles]
    for (bt, br), (st, sr) in zip(got, seq):
        np.testing.assert_array_equal(bt, st)
        for key in ("sets", "resets", "write_cycles", "compare_cycles",
                    "energy_total_j", "n_graphs", "n_programs",
                    "makespan_cycles", "sequential_cycles"):
            assert br[key] == sr[key], key


def test_current_ap_context_none_while_capturing(dev):
    """Inside a CUDA graph capture the AP path is off (it syncs the host);
    outside it the active context is returned."""
    ctx = apc.APServeContext(apc.Runtime(apc.ArrayPool(
        n_arrays=1, rows=64, cols=64, device=dev)))
    seen = {}
    x = torch.ones(4, device=dev)
    with apc.ap_serving(ctx):
        seen["before"] = apc.current_ap_context()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            seen["capturing"] = apc.current_ap_context()
            y = x * 2
        graph.replay()
        seen["after"] = apc.current_ap_context()
    assert seen["before"] is ctx and seen["after"] is ctx
    assert seen["capturing"] is None
    assert float(y.sum()) == 8.0


def test_program_spans_on_the_profilers_clock(dev):
    """A program span around a kernel launch and a synchronize, mapped to
    epoch ns (``Tracer.epoch_ns``), holds that kernel's ``torch.profiler``
    interval: each end of the span within 50 us of the kernel's."""
    from repro_torch.apc import trace
    slack, n = 50_000, 5
    x = torch.randn(2048, 2048, device=dev)
    torch.mm(x, x)
    torch.cuda.synchronize(dev)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with trace.tracing() as tr:
        prof.start()
        for i in range(n + 1):           # the first launch is not timed
            torch.cuda.synchronize(dev)
            with trace.span("launch", i=i):
                torch.mm(x, x)
                torch.cuda.synchronize(dev)
        prof.stop()
    kernels = sorted((e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if str(e.device_type()).endswith("CUDA"))
    per = len(kernels) // (n + 1)
    assert per >= 1 and len(kernels) == per * (n + 1)
    spans = sorted((e for e in tr.events if e.name == "launch"),
                   key=lambda e: e.args["i"])
    for i, rec in enumerate(spans[1:], start=1):
        start, end = tr.epoch_ns(rec)
        mine = kernels[i * per:(i + 1) * per]
        k0, k1 = mine[0][0], max(e for _, e in mine)
        assert -slack <= k0 - start <= slack, (i, k0 - start)
        assert -slack <= end - k1 <= slack, (i, end - k1)
