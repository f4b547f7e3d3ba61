"""``portbench/work.py`` against counts worked out by hand."""
import pytest

from portbench import work


def test_peaks_are_the_published_ones():
    assert work.BF16_FLOPS == 989e12
    assert work.HBM_BYTES_PER_S == 3.35e12
    assert work.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)


@pytest.mark.parametrize("m,k,n,xb,want", [
    # words 2 x 4 x 4 B, x 2 x 32 x 2 B, scale 4 x 4 B, y 2 x 4 x 2 B
    (2, 32, 4, 2, 32 + 128 + 16 + 16),
    # K = 17 pads to two words a column: 2 x 3 x 4, x 1 x 17 x 4, 12, 12
    (1, 17, 3, 4, 24 + 68 + 12 + 12),
])
def test_packed_matmul_bytes(m, k, n, xb, want):
    assert work.packed_matmul_bytes(m, k, n, xb) == want


def test_packed_matmul_least_time_takes_the_longer_bound():
    assert work.packed_matmul_flops(2, 32, 4) == 512
    assert work.packed_matmul_seconds(2, 32, 4, 2) == \
        pytest.approx(192 / 3.35e12)
    # 4096 x 4096 x 4096 bf16: 137.4 GFLOP over 989 TFLOP/s, bytes far less
    assert work.packed_matmul_seconds(4096, 4096, 4096, 2) == \
        pytest.approx(2 * 4096 ** 3 / 989e12)


def test_program_cells_and_launch():
    # step 0: 2 keys x 3 compare columns + 1 write; step 1: 1 x 0 + 2
    assert work.program_cells([2, 1], [3, 0], [1, 2]) == 9
    # 1000 rows x 10 one-byte columns, read and written: 2e4 bytes
    assert work.program_launch_seconds(1000, 10, 9) == \
        pytest.approx(2e4 / 3.35e12)
    # 1e6 rows x 30000 cells, four cells an INT32 operation (0.448 ms),
    # above the rows' 1.3 GB of bytes (0.388 ms)
    assert work.program_launch_seconds(10 ** 6, 650, 30000) == \
        pytest.approx(3e10 / (4 * 132 * 64 * 1.98e9))


def test_dense_token_flops_by_hand():
    model = dict(n_layers=1, d_model=4, n_heads=2, n_kv_heads=1,
                 head_dim=2, d_ff=8, vocab=10)
    # weights: wq 4x4, wk 4x2, wv 4x2, wo 4x4 = 48; mlp 3 x 4 x 8 = 96;
    # 2 x 144 + attention 4 x 2 heads x 2 x 3 positions + head 2 x 4 x 10
    assert work.dense_token_flops(model, 3) == 288 + 48 + 80
    assert work.steps_flops(model, [(2, 5), (0, 1)]) == \
        5 * (288 + 48 + 80) + (288 + 16 + 80)
