"""The port's packed-ternary matmul against the reference's, on the same
seeded inputs: pack/unpack words equal, quantization equal away from
rounding boundaries, ``ternary_matmul_op`` within the reference tests'
tolerances (1e-4 fp32, 5e-2 bf16) and exact on integers, the same padding
semantics, the same dispatcher names and errors.  The port runs on the CPU
(the kernel's plain version), the reference's Pallas kernel in interpret
mode."""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ternary_matmul import ops as ref_ops
from repro.kernels.ternary_matmul import ref as ref_ref

from repro_torch.convert import packed_mlp_from_arrays
from repro_torch.kernels.ternary_matmul import kernel, ops, ref
from repro_torch.kernels.ternary_matmul.ops import (quantize_and_pack,
                                                    ternary_matmul,
                                                    ternary_matmul_op)

ROOT = Path(__file__).resolve().parents[1]
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _ref_weights(k, n, seed):
    """The reference's quantize_and_pack of seeded weights, carried into
    the port by convert.packed_mlp_from_arrays."""
    w = np.random.default_rng(seed).normal(0, 0.05, (k, n)).astype(
        np.float32)
    packed, scale = ref_ops.quantize_and_pack(jnp.asarray(w))
    ours = packed_mlp_from_arrays({"w_packed": np.asarray(packed),
                                   "w_scale": np.asarray(scale)},
                                  device="cpu")
    return w, (packed, scale), (ours["w_packed"], ours["w_scale"])


def _x(m, k, seed, dtype):
    x = np.random.default_rng(seed).normal(0, 1, (m, k)).astype(np.float32)
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(dtype)


def _trit_patterns():
    """48 x 20 trits: every digit value at every position of a word, digit
    2 in position 15 (bit 31) included, plus seeded random columns."""
    cols = [np.full(48, v) for v in (-1, 0, 1)]
    cols += [np.tile([-1, 0, 1], 16), np.tile([1, 0, -1], 16),
             np.where(np.arange(48) % 16 == 15, 1, -1)]
    rng = np.random.default_rng(11)
    cols += [rng.integers(-1, 2, 48) for _ in range(14)]
    return np.stack(cols, axis=1).astype(np.int8)


def test_pack_unpack_word_for_word():
    w = _trit_patterns()
    theirs = np.array(ref_ref.pack_ternary(jnp.asarray(w)))
    ours = ref.pack_ternary(torch.from_numpy(w))
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), theirs)
    assert (theirs < 0).any()              # bit 31 set: the int32 wrap
    assert np.array_equal(ref.unpack_ternary(ours, torch.int8).numpy(), w)
    assert np.array_equal(
        ref.unpack_ternary(torch.from_numpy(theirs)).numpy(),
        np.asarray(ref_ref.unpack_ternary(jnp.asarray(theirs))))
    with pytest.raises(ValueError, match="multiple of 16"):
        ref.pack_ternary(torch.zeros((17, 2), dtype=torch.int8))


def test_quantize_ternary_matches_away_from_rounding_boundaries():
    """Scales equal to 1e-6 (the mean sums in another order); trits equal
    wherever |w / scale| lies more than 1e-5 from a rounding boundary
    (+-0.5).  On these inputs 1 of the 16384 entries is that close."""
    w = np.random.default_rng(5).normal(0, 0.05, (128, 128)).astype(
        np.float32)
    t_ter, t_scale = (np.asarray(a) for a in
                      ref_ref.quantize_ternary(jnp.asarray(w)))
    o_ter, o_scale = ref.quantize_ternary(torch.from_numpy(w))
    np.testing.assert_allclose(o_scale.numpy(), t_scale, rtol=1e-6)
    near = np.abs(np.abs(w / t_scale[None, :]) - 0.5) <= 1e-5
    assert int(near.sum()) == 1
    assert np.array_equal(o_ter.numpy()[~near], t_ter[~near])
    assert o_ter.dtype == torch.int8 and o_scale.dtype == torch.float32


def test_quantize_and_pack_matches_reference():
    w = np.random.default_rng(6).normal(0, 0.05, (300, 96)).astype(
        np.float32)
    t_packed, t_scale = ref_ops.quantize_and_pack(jnp.asarray(w))
    o_packed, o_scale = quantize_and_pack(torch.from_numpy(w))
    assert np.array_equal(o_packed.numpy(), np.asarray(t_packed))
    np.testing.assert_allclose(o_scale.numpy(), np.asarray(t_scale),
                               rtol=1e-6)


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (32, 256, 128),
                                   (100, 300, 96), (256, 512, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ternary_matmul_op_matches_reference(m, k, n, dtype):
    _, (t_packed, t_scale), (o_packed, o_scale) = _ref_weights(
        k, n, m * 1000 + k + n)
    tx, ox = _x(m, k, 1, dtype)
    want = np.asarray(ref_ops.ternary_matmul_op(tx, t_packed, t_scale),
                      np.float32)
    y = ternary_matmul_op(ox, o_packed, o_scale)
    assert y.dtype == dtype and tuple(y.shape) == (m, n)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(ref_ref.ternary_matmul_ref(tx, t_packed, t_scale),
                   np.float32), atol=tol, rtol=tol)


def test_ternary_matmul_exact_integers():
    """With integer activations the ternary product is exact."""
    rng = np.random.default_rng(7)
    w_t = rng.integers(-1, 2, (64, 32)).astype(np.int8)
    x = rng.integers(-3, 4, (16, 64)).astype(np.float32)
    y = ternary_matmul_op(torch.from_numpy(x),
                          ref.pack_ternary(torch.from_numpy(w_t)),
                          torch.ones(32))
    assert np.array_equal(y.numpy(), x @ w_t.astype(np.float32))


def test_x_narrower_than_packed_k_is_zero_padded():
    """K = 19 against K' = 32 (pack-time zero rows)."""
    _, (t_packed, t_scale), (o_packed, o_scale) = _ref_weights(19, 24, 3)
    tx, ox = _x(5, 19, 4, torch.float32)
    want = np.asarray(ref_ops.ternary_matmul_op(tx, t_packed, t_scale))
    np.testing.assert_allclose(
        ternary_matmul_op(ox, o_packed, o_scale).numpy(), want, atol=1e-4,
        rtol=1e-4)


def test_x_wider_than_packed_k_meets_zero_weights():
    """The reference wrapper's quirk, reproduced: x with K = 40 against
    K' = 32 (which ternary_matmul_ref refuses) multiplies its extra columns
    by zero padding words, so they count only through NaN."""
    _, (t_packed, t_scale), (o_packed, o_scale) = _ref_weights(32, 24, 8)
    tx, ox = _x(6, 40, 9, torch.float32)
    tx = tx.at[2, 37].set(jnp.nan)
    ox[2, 37] = float("nan")
    want = np.asarray(ref_ops.ternary_matmul_op(tx, t_packed, t_scale))
    y = ternary_matmul_op(ox, o_packed, o_scale).numpy()
    np.testing.assert_allclose(y, want, atol=1e-4, rtol=1e-4)
    assert np.isnan(y[2]).all() and not np.isnan(np.delete(y, 2, 0)).any()
    np.testing.assert_allclose(
        np.delete(y, 2, 0),
        ternary_matmul_op(ox[:, :32], o_packed, o_scale).numpy()[[0, 1, 3,
                                                                   4, 5]],
        atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="exceeds packed"):
        kernel.ternary_matmul(ox, o_packed, o_scale)


def test_dispatcher_names_and_errors():
    _, (t_packed, t_scale), (o_packed, o_scale) = _ref_weights(48, 8, 12)
    tx, ox = _x(3, 48, 13, torch.float32)
    y = ternary_matmul(ox, o_packed, o_scale)                  # "pallas"
    assert torch.equal(ternary_matmul(ox, o_packed, o_scale, impl="packed"),
                       y)
    assert torch.equal(ternary_matmul(ox, o_packed, o_scale, impl="ref"),
                       ref.ternary_matmul_ref(ox, o_packed, o_scale))
    for impl_ in ("pallas", "ref"):
        np.testing.assert_allclose(
            ternary_matmul(ox, o_packed, o_scale, impl=impl_).numpy(),
            np.asarray(ref_ops.ternary_matmul(tx, t_packed, t_scale,
                                              impl=impl_)),
            atol=1e-4, rtol=1e-4)
    for mod, x, p, s in ((ops, ox, o_packed, o_scale),
                         (ref_ops, tx, t_packed, t_scale)):
        with pytest.raises(TypeError, match="no extra kwargs"):
            mod.ternary_matmul(x, p, s, impl="ref", radix=3)
        with pytest.raises(ValueError, match="unknown impl"):
            mod.ternary_matmul(x, p, s, impl="dense")
    with pytest.raises(TypeError):
        ternary_matmul(ox, o_packed, o_scale, impl="pallas", interpret=True)


def test_cpu_path_counts_no_launch_and_launcher_refuses_cpu():
    _, _, (o_packed, o_scale) = _ref_weights(32, 8, 14)
    before = dict(kernel.launch_counts)
    ternary_matmul(torch.ones((2, 32)), o_packed, o_scale)
    assert kernel.launch_counts == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel._launch(torch.ones((2, 32)), o_packed, o_scale)
    assert kernel.m_tile(1) == 1 and kernel.m_tile(3) == 4
    assert kernel.m_tile(16) == 16 and kernel.m_tile(2048) == 16


def test_new_modules_load_no_jax_and_default_to_cuda():
    """The slice's modules import neither JAX nor the reference, and their
    entry points that take no tensor device raise without a card."""
    code = (
        "import sys, torch, numpy as np\n"
        "import repro_torch.kernels.ternary_matmul, repro_torch.models.quant\n"
        "from repro_torch import apc\n"
        "from repro_torch.core import ap, build_lut_nonblocked\n"
        "from repro_torch.core import truth_tables as tt\n"
        "from repro_torch.convert import packed_mlp_from_arrays\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'repro'"
        " or m.split('.')[0].startswith('jax')]\n"
        "assert not bad, bad\n"
        "torch.cuda.is_available = lambda: False\n"
        "x = np.ones((4, 3), np.int64)\n"
        "lut = build_lut_nonblocked(tt.full_adder(3))\n"
        "calls = [lambda: apc.run_mac_tiled(x, x, "
        "apc.compile_mac_tiled(3, 3, 4, 2)),\n"
        "  lambda: ap.mac_tiled(x, x, 3, 4, k_tile=2),\n"
        "  lambda: ap.mac(np.zeros((4, 20), np.int8), lut, lut, 3, 4),\n"
        "  lambda: packed_mlp_from_arrays({'w1_scale': np.ones(2)})]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'CUDA' in str(e)\n"
        "    else:\n"
        "        raise SystemExit('ran without a card')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("dtype,m,want", [
    (torch.bfloat16, 16, "ternary_matmul_tc"),
    (torch.bfloat16, 17, "ternary_matmul_tc"),
    (torch.bfloat16, 2048, "ternary_matmul_tc"),
    (torch.bfloat16, 15, "ternary_matmul"),
    (torch.bfloat16, 1, "ternary_matmul"),
    (torch.float32, 1, "ternary_matmul"),
    (torch.float32, 16, "ternary_matmul_tc"),
    (torch.float32, 2048, "ternary_matmul_tc")])
def test_routing_rule(dtype, m, want):
    """One rule for both dtypes: M >= 16 goes to the tensor-core kernel
    (fp32 as three bf16 passes), M < 16 to the CUDA-core kernel."""
    assert kernel.kernel_for(dtype, m) == want


@pytest.mark.parametrize("m,n,k16,want", [
    (1, 3072, 64, (1, 1, 2)),          # qwen3-0.6b w1: 96 CTAs x 2
    (1, 1024, 192, (1, 1, 4)),         # qwen3-0.6b w2: 32 CTAs x 4
    (4, 3072, 64, (4, 1, 2)), (8, 3072, 64, (8, 1, 2)),
    (15, 3072, 64, (16, 1, 2)),
    (1, 29568, 512, (1, 4, 1)),        # qwen2-72b w1: 231 CTAs
    (1, 96, 1, (1, 1, 1)),             # one K chunk: nothing to split
    (3, 130, 63, (4, 1, 2))])
def test_cuda_core_grid_fills_the_card(m, n, k16, want):
    """128 columns per CTA where that grid gives each of 132 SMs a CTA,
    else 32, with the K chunks split over a cluster of 2 or 4 CTAs while
    the grid is smaller than the card."""
    assert kernel.cuda_core_shape(m, n, k16, 132) == want


def _split_inputs():
    """Seeded fp32: normals, large and tiny magnitudes (down to 2^-110),
    the largest finite values, integers up to 2^24, signed zeros and
    infinities."""
    rng = np.random.default_rng(31)
    big = np.finfo(np.float32).max
    vals = [rng.normal(0, 1, 4096),
            rng.normal(0, 1, 512) * 10.0 ** rng.integers(-30, 38, 512),
            rng.uniform(1, 2, 256) * 2.0 ** rng.integers(-110, -60, 256),
            rng.integers(-(1 << 24), (1 << 24) + 1, 1024),
            [big, -big, np.nextafter(big, 0), 1 << 24, -(1 << 24),
             (1 << 24) - 1, 0.0, -0.0, np.inf, -np.inf]]
    return torch.from_numpy(np.concatenate(vals).astype(np.float32))


def test_bf16x3_split_is_exact():
    """hi + mid + lo gives x back bit for bit, every part a bf16 value;
    a zero keeps its sign in hi (mid and lo +0, so the fp32 sum of a -0
    reads +0), an infinity is all hi."""
    x = _split_inputs()
    parts = ref.split_bf16x3(x)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    hi, mid, lo = (p.to(torch.float32) for p in parts)
    back = (hi + mid) + lo
    finite = torch.isfinite(x) & (x != 0)
    assert torch.equal(back[finite].view(torch.int32),
                       x[finite].view(torch.int32))
    zero = x == 0
    assert torch.equal(hi[zero].view(torch.int32), x[zero].view(torch.int32))
    assert not (mid[zero].view(torch.int32).any()
                or lo[zero].view(torch.int32).any())
    inf = torch.isinf(x)
    assert torch.equal(hi[inf], x[inf]) and not mid[inf].any()
    assert not lo[inf].any()
    # each part holds at most 8 significant bits: bf16 of it is itself
    for p in (hi, mid, lo):
        assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)


@pytest.mark.parametrize("m,k,n", [(8, 16, 8), (32, 256, 128),
                                   (100, 300, 96), (17, 513, 257)])
def test_three_pass_product_matches_reference(m, k, n):
    """The three-pass product (the tensor-core kernel's fp32 arithmetic)
    within 1e-4 of the reference's kernel (interpret mode), and exact on
    integer activations."""
    _, (t_packed, t_scale), (o_packed, o_scale) = _ref_weights(
        k, n, m * 1000 + k + n + 1)
    tx, ox = _x(m, k, 2, torch.float32)
    want = np.asarray(ref_ops.ternary_matmul_op(tx, t_packed, t_scale))
    y = ref.ternary_matmul_3pass(ox, o_packed, o_scale)
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, n)
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)
    xi = np.random.default_rng(m + k).integers(-7, 8, (m, k)).astype(
        np.float32)
    ones = torch.ones(n)
    yi = ref.ternary_matmul_3pass(torch.from_numpy(xi), o_packed, ones)
    exact = xi.astype(np.float64) @ ref.unpack_ternary(
        o_packed, torch.float64).numpy()[:k]
    assert np.array_equal(yi.numpy(), exact.astype(np.float32))
    want_i = np.asarray(ref_ops.ternary_matmul_op(
        jnp.asarray(xi), t_packed, jnp.ones(n, jnp.float32)))
    assert np.array_equal(yi.numpy(), want_i)


@pytest.mark.parametrize("m,n,k16,want,want32", [
    # qwen3-0.6b w1 and w2 prefill: 384 and 128 CTAs (fp32: 192, 64)
    (2048, 3072, 64, (128, 128, 1), (64, 256, 1)),
    (2048, 1024, 192, (128, 128, 1), (64, 256, 1)),
    (512, 3072, 64, (128, 128, 1), (64, 256, 2)),
    # qwen3-0.6b w1 and w2 at M = 16: 96 (fp32: 192) and 64 (128) CTAs
    (16, 3072, 64, (16, 64, 2), (16, 64, 4)),
    (16, 1024, 192, (16, 64, 4), (16, 64, 8)),
    (128, 3072, 64, (64, 128, 2), (64, 128, 2)),
    (16, 29568, 512, (16, 64, 2), (16, 64, 2)),      # qwen2-72b w1
    (63, 29568, 512, (64, 64, 1), (64, 64, 1)),
    (100, 29568, 512, (64, 128, 1), (64, 256, 1)),
    (1024, 1024, 64, (64, 128, 1), (64, 128, 1)),
    (16, 3072, 1, (16, 64, 1), (16, 64, 1))])       # one K step: no split
def test_tensor_core_m_tile_fills_the_card(m, n, k16, want, want32):
    """The tensor-core kernel's shape rule on 132 SMs: 16 tokens by 64
    outputs up to 16 rows, 64 by 64 below 64, else (bf16) 128 or 64 tokens
    by 128 outputs or (fp32) 64 tokens by 256 or 128 outputs, then K split
    over a cluster: the 16-token tile's while the grid holds fewer than 4
    CTAs an SM and every CTA keeps two steps, another's while the grid
    covers less than three quarters of the card and every CTA keeps eight
    steps.  At a decode batch of 16 the split fills the card:
    qwen3-0.6b's w1 on at least 96 CTAs and w2 on at least 64 (the 16-row
    tile of the kernel before it: 24 and 8)."""
    for dtype, expected in ((torch.bfloat16, want), (torch.float32, want32)):
        shape = kernel.tc_shape(m, n, k16, 132, dtype)
        assert shape == expected
        bt, bw, split = shape
        assert (bt, bw) in kernel.TC_TILES[dtype]
        assert split in kernel.TC_SPLITS
        assert -(-k16 // kernel.TC_TILES[dtype][bt, bw]) >= split
        ctas = -(-m // bt) * -(-n // bw) * split
        if (m, n, k16) == (16, 3072, 64):
            assert ctas >= 96
        if (m, n, k16) == (16, 1024, 192):
            assert ctas >= 64


def _tc_sum_model(x, packed, scale, split, words):
    """A plain model of the tensor-core kernel's sums: K' in steps of
    ``words`` words (16 words deep) split over ``split`` CTAs (rank r takes
    steps [r s / split, (r + 1) s / split)); in each CTA the product of
    every 16-deep slice of x's bf16
    parts (hi, mid, lo for fp32 x) and the weights added into an fp32 sum;
    fp32 x: the sum starts from zero every 1024 of K and is then added
    into the CTA's total; the totals added in rank order, times scale,
    rounded once to x's dtype."""
    m, k = x.shape
    w = ref.unpack_ternary(packed, torch.float32)
    kp, n = w.shape
    xp = torch.zeros((m, kp), dtype=x.dtype)
    xp[:, :k] = x
    fp32 = x.dtype == torch.float32
    parts = ref.split_bf16x3(xp) if fp32 else (xp,)
    sk = 16 * words
    steps = -(-kp // sk)
    chunk = 1024 // sk if fp32 else steps
    totals = []
    for r in range(split):
        beg, end = r * steps // split, (r + 1) * steps // split
        total = torch.zeros((m, n))
        for c0 in range(beg, end, chunk):
            acc = torch.zeros((m, n))
            for k0 in range(c0 * sk, min(end, c0 + chunk) * sk, 16):
                for p in parts:
                    acc = acc + p[:, k0:k0 + 16].float() @ w[k0:k0 + 16]
            total = total + acc
        totals.append(total)
    y = totals[0]
    for t in totals[1:]:
        y = y + t
    return (y * scale).to(x.dtype)


@functools.cache
def _k8192_case():
    """qwen2-72b's K = 8192 at N = 128 and M = 16: the reference's weights,
    normal fp32 x and integer x (|x| <= 7), with the reference's kernel's
    outputs (interpret mode)."""
    _, (t_packed, t_scale), (o_packed, o_scale) = _ref_weights(8192, 128, 81)
    tx, ox = _x(16, 8192, 82, torch.float32)
    xi = np.random.default_rng(83).integers(-7, 8, (16, 8192)).astype(
        np.float32)
    want = np.array(ref_ops.ternary_matmul_op(tx, t_packed, t_scale))
    want_i = np.array(ref_ops.ternary_matmul_op(jnp.asarray(xi), t_packed,
                                                t_scale))
    return o_packed, o_scale, ox, torch.from_numpy(xi), want, want_i


@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_tensor_core_summation_order_matches_reference(split):
    """The tensor-core kernel's order of sums (K in its tiles' steps split
    over a cluster, promoted fp32 chunks of 1024, partials in rank order),
    modelled in plain PyTorch, within 1e-4 + 1e-4·|want| of the reference's
    kernel at K = 8192, and exact on integer x in both dtypes."""
    packed, scale, x, xi, want, want_i = _k8192_case()
    for words in sorted(set(kernel.TC_TILES[torch.float32].values())):
        y = _tc_sum_model(x, packed, scale, split, words)
        np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)
        yi = _tc_sum_model(xi, packed, scale, split, words)
        assert np.array_equal(yi.numpy(), want_i)
    for words in sorted(set(kernel.TC_TILES[torch.bfloat16].values())):
        yb = _tc_sum_model(xi.to(torch.bfloat16), packed, scale, split,
                           words)
        assert torch.equal(yb, torch.from_numpy(want_i).to(torch.bfloat16))


def test_bf16_prefill_on_cpu_takes_plain_version():
    """bf16 x at M = 2048 on the CPU: the plain version, no launch counted,
    within 5e-2 of the reference's kernel (interpret mode)."""
    _, (t_packed, t_scale), (o_packed, o_scale) = _ref_weights(64, 128, 21)
    tx, ox = _x(2048, 64, 22, torch.bfloat16)
    before = dict(kernel.launch_counts)
    y = ternary_matmul(ox, o_packed, o_scale)
    assert kernel.launch_counts == before
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (2048, 128)
    want = np.asarray(ref_ops.ternary_matmul_op(tx, t_packed, t_scale),
                      np.float32)
    np.testing.assert_allclose(y.float().numpy(), want, atol=5e-2,
                               rtol=5e-2)


def test_tensor_core_library_is_registered():
    """The tensor-core kernel is its own library on the one build path,
    with its source under csrc/, computing with warpgroup wgmma (A, the
    weights, from registers) and no mma.sync."""
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.LIBRARIES["ternary_matmul_tc"]
    src = lib.csrc / lib.source
    assert src == (ROOT / "src" / "repro_torch" / "kernels" /
                   "ternary_matmul" / "csrc" / "ternary_matmul_tc.cu")
    assert src.is_file() and lib.entry == "ternary_matmul_tc_launch"
    assert lib.path().parent == cuda_lib.BUILD_DIR
    text = src.read_text()
    assert "wgmma.mma_async.sync.aligned.m64n" in text
    assert "mma.sync" not in text
    assert "split3" in text             # fp32 x as three bf16 passes
    assert f'extern "C" int {lib.entry}(' in text
    assert set(kernel.launch_counts) == {"ternary_matmul",
                                         "ternary_matmul_tc"}
