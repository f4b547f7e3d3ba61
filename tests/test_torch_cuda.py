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
