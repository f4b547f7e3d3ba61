"""The decode-attention kernel (``kernels/decode_attention``) and the
dispatch of ``models.attention.attend_decode`` between it and the einsum
path.

The tests marked ``cuda`` hold the kernel against the einsum path on the
card and skip on a host without one; run them on a machine with a card:
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_decode_attention.py``.  The others run on the CPU, where
every call takes the einsum path."""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.apc.metrics import get_registry
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.models import attention as attn

COUNTERS = ("kernel", "einsum")


def _counts():
    """Kernel calls (its ``launch_counts``) and einsum-path calls (the
    registry's ``attn.decode.einsum``)."""
    return {"kernel": dk.launch_counts["decode_attention"],
            "einsum": get_registry().counter("attn.decode.einsum").value}


def _delta(before):
    now = _counts()
    return {k: now[k] - before[k] for k in COUNTERS}


def _todays_einsum_path(q, cache, pos, ring):
    """``attend_decode`` as it stood before the kernel: the frozen oracle
    of the calls that keep the einsum path."""
    k, v = cache["k"], cache["v"]
    length = k.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    k, v = attn._repeat_kv(k, n_rep), attn._repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    valid_len = min(pos + 1, length) if ring else pos + 1
    if valid_len < length:
        s[..., valid_len:] = attn.NEG_INF
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


def _case(b, h, hk, hd, length, dtype, seed, device="cpu"):
    """q [b, 1, h, hd] and a cache of ``length`` slots, drawn on the CPU
    (CUDA generators draw other numbers), then moved."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=g).to(dtype)
    cache = attn.init_kv_cache(b, hk, hd, length, dtype=dtype)
    cache["k"].copy_(torch.randn(cache["k"].shape, generator=g))
    cache["v"].copy_(torch.randn(cache["v"].shape, generator=g))
    return q.to(device), {n: t.to(device) for n, t in cache.items()}


def _ulp(x, dtype):
    """One ulp of ``dtype`` at each element's magnitude."""
    _, e = torch.frexp(x.float())
    mant = 8 if dtype == torch.bfloat16 else 11
    return torch.ldexp(torch.ones_like(x.float()), e - mant)


def _within_one_ulp(got, want):
    """|got - want| within one ulp of the output's dtype, the ulp taken at
    each element's magnitude but at no less than 1/256 of its head's
    largest: two fp32 sums in another order differ by about 1e-6 of the
    row's magnitude, which is more than an ulp of an element that cancels
    to near zero."""
    want32 = want.float()
    floor = want32.abs().amax(dim=-1, keepdim=True) * 2.0 ** -8
    tol = _ulp(torch.maximum(want32.abs(), floor), want.dtype)
    diff = (got.float() - want32).abs()
    bad = diff > tol
    assert not bad.any(), (
        f"{int(bad.sum())} elements off by more than one ulp; worst "
        f"{float((diff / tol).max()):.2f} ulps")


# ---------------------------------------------------------------------------
# CPU: the dispatch and the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("pos", [0, 5, 15, 20])
def test_cpu_and_fp32_calls_keep_the_einsum_path(dtype, ring, pos):
    """fp32 queries (the AP route) and CPU tensors: bit-identical to the
    einsum path as it stood, and counted as einsum calls."""
    q, cache = _case(2, 8, 2, 64, 16, dtype, seed=pos)
    before = _counts()
    got = attn.attend_decode(q, cache, pos, ring)
    assert _delta(before) == {"kernel": 0, "einsum": 1}
    assert torch.equal(got, _todays_einsum_path(q, cache, pos, ring))


@pytest.mark.parametrize("hd,ok", [(32, True), (64, True), (96, True),
                                   (128, True), (256, True), (16, False),
                                   (48, False), (80, False), (288, False)])
def test_kernel_terms_head_dim(hd, ok):
    q, cache = _case(1, 4, 2, hd, 8, torch.bfloat16, seed=hd)
    assert dk.takes(q, cache["k"], cache["v"]) is ok
    assert not dk.supports(q, cache["k"], cache["v"])   # on the CPU


def test_kernel_terms_other_than_head_dim():
    q, cache = _case(2, 8, 2, 64, 16, torch.bfloat16, seed=1)
    k, v = cache["k"], cache["v"]
    assert dk.takes(q, k, v)
    assert dk.takes(q.half(), k.half(), v.half())
    assert not dk.takes(q.float(), k.float(), v.float())     # fp32
    assert not dk.takes(q, k.float(), v.float())             # mixed
    assert dk.takes(q[:, :, :6], k, v)                       # 3 a kv head
    assert not dk.takes(q[:, :, :7], k, v)                   # 7 % 2 != 0
    assert not dk.takes(q.expand(2, 2, 8, 64), k, v)         # 2 tokens
    assert not dk.takes(q, k[..., :32], v[..., :32])         # hd differs
    wide = torch.zeros(2, 16, 2, 72, dtype=torch.bfloat16)
    assert not dk.takes(q, wide[..., 1:65], wide[..., 1:65])  # misaligned
    assert dk.takes(q, wide[..., 8:72], wide[..., 8:72])      # 16-byte rows
    g = q.detach().clone().requires_grad_(True)
    assert not dk.takes(g, k, v)
    with torch.no_grad():
        assert dk.takes(g, k, v)


@pytest.mark.parametrize("hd,kernel", [(64, True), (48, False)])
def test_dispatch_routes_by_the_kernel_terms(monkeypatch, hd, kernel):
    """With the device check lifted (as on the card), a call the kernel
    takes goes to ``decode_attention`` with the written slots' count and
    no einsum call; an unsupported head_dim falls back to the einsum path,
    bit for bit."""
    calls = []

    def plain(q, k, v, n_valid, scale=None):
        calls.append((n_valid, scale))
        return dref.decode_attention_ref(q, k, v, n_valid, scale)

    monkeypatch.setattr(dk, "supports", dk.takes)
    monkeypatch.setattr(dk, "decode_attention", plain)
    q, cache = _case(2, 8, 2, hd, 16, torch.bfloat16, seed=hd)
    before = _counts()
    got = attn.attend_decode(q, cache, 9, ring=False)
    assert calls == ([(10, None)] if kernel else [])
    assert _delta(before) == {"kernel": 0, "einsum": int(not kernel)}
    want = _todays_einsum_path(q, cache, 9, False)
    if kernel:
        assert torch.equal(got, dref.decode_attention_ref(
            q, cache["k"], cache["v"], 10))
        _within_one_ulp(got, want)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("h,hk", [(8, 2), (4, 4), (6, 2)])
@pytest.mark.parametrize("pos,ring", [(0, False), (10, False), (31, True),
                                      (40, True), (40, False)])
def test_plain_version_matches_the_einsum_path(h, hk, pos, ring):
    """The plain version reads only the first min(pos + 1, length) slots
    without repeating kv heads: in fp32 it agrees with the einsum path to
    fp32 rounding, ring and linear caches alike."""
    q, cache = _case(3, h, hk, 32, 32, torch.float32, seed=pos)
    n_valid = min(pos + 1, 32)
    got = dref.decode_attention_ref(q, cache["k"], cache["v"], n_valid)
    want = _todays_einsum_path(q, cache, pos, ring)
    assert got.dtype == torch.float32 and got.shape == q.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_plain_version_reads_only_valid_slots():
    q, cache = _case(2, 4, 2, 32, 16, torch.bfloat16, seed=3)
    want = dref.decode_attention_ref(q, cache["k"], cache["v"], 5)
    cache["k"][:, 5:] = float("nan")
    cache["v"][:, 5:] = float("inf")
    assert torch.equal(dref.decode_attention_ref(q, cache["k"], cache["v"],
                                                 5), want)


@pytest.mark.parametrize("n_valid", [0, 17])
def test_decode_attention_refuses_n_valid_outside_the_cache(n_valid):
    q, cache = _case(1, 4, 2, 32, 16, torch.bfloat16, seed=0)
    with pytest.raises(ValueError, match="n_valid"):
        dk.decode_attention(q, cache["k"], cache["v"], n_valid)


@pytest.mark.parametrize("n_rep,group", [(1, 1), (2, 2), (3, 4), (4, 4),
                                         (5, 8), (7, 8), (8, 8), (16, 8)])
def test_group_size(n_rep, group):
    assert dk.group_size(n_rep) == group


@pytest.mark.parametrize("ctas,n_tiles,want", [
    (1024, 8, (1, 8)),      # qwen2-72b at batch 128: one split
    (8, 8, (8, 1)),         # one sequence of 512 slots: every tile apart
    (8, 1, (1, 1)),         # one slot written
    (64, 8, (4, 2)),
    (8, 16, (16, 1)),
    (2, 100, (100, 1)),
    (264, 4, (1, 4)),
    (263, 4, (2, 2))])
def test_split_shape(ctas, n_tiles, want):
    assert dk.split_shape(ctas, n_tiles, 132) == want


def test_split_shape_covers_every_tile_once():
    rng = np.random.default_rng(0)
    for _ in range(500):
        ctas, n_tiles = int(rng.integers(1, 3000)), int(rng.integers(1, 400))
        splits, per = dk.split_shape(ctas, n_tiles, 132)
        assert 1 <= splits <= n_tiles
        assert splits * per >= n_tiles > (splits - 1) * per
        if ctas >= 2 * 132:
            assert splits == 1


@pytest.mark.parametrize("scale", [None, 1 / 128])
def test_the_launch_takes_the_scale(monkeypatch, scale):
    """The kernel's launch arguments on the CPU, the entry stubbed: the
    scale is ``hd ** -0.5`` by default, the very float the launch has
    always passed (so the cells that leave it bit-identical), and the
    caller's where given."""
    import types

    from repro_torch.kernels import cuda_lib
    launches = []

    def entry(name):
        assert name == "decode_attention"
        return lambda *args: launches.append(args) or 0

    monkeypatch.setattr(dk, "supports", dk.takes)
    monkeypatch.setattr(dk, "_sm_count", lambda index: 132)
    monkeypatch.setattr(cuda_lib, "entry", entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    q, cache = _case(128, 32, 8, 128, 512, torch.bfloat16, seed=1)
    dk.decode_attention(q, cache["k"], cache["v"], 300, scale=scale)
    (args,) = launches
    # q, k, v, out, part, 6 strides, b, h, hk, hd, n_valid, scale, ...
    assert args[11:16] == (128, 32, 8, 128, 300)
    assert type(args[16]) is float
    assert args[16] == (128 ** -0.5 if scale is None else 1 / 128)


def test_decode_step_counts_einsum_calls_on_the_cpu():
    """A bf16 decode step on the CPU: one einsum call per attention
    layer, no kernel call."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    cfg = get_smoke_config("qwen2-72b").with_(head_dim=32)
    params = M.cast_params(cfg, M.init_params(cfg, seed=0, device="cpu"))
    cache = M.init_cache(cfg, 2, 8, device="cpu")
    before = _counts()
    with torch.inference_mode():
        M.decode_step(cfg, params, cache, torch.zeros(2, dtype=torch.int32),
                      0)
    assert _delta(before) == {"kernel": 0, "einsum": cfg.n_layers}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


POSITIONS = (0, 1, 63)    # and length - 1, length + 5


@pytest.mark.cuda
@pytest.mark.parametrize("length", [16, 512, 1024])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("h,hk", [(64, 8), (16, 8), (4, 4)])
@pytest.mark.parametrize("b", [1, 8, 128])
def test_kernel_matches_the_einsum_path(dev, b, h, hk, hd, length):
    """Through ``attend_decode`` on the card, at every position of a ring
    and of a linear cache: within one bf16 ulp of the einsum path, every
    call a kernel call."""
    q, cache = _case(b, h, hk, hd, length, torch.bfloat16,
                     seed=b * 7 + hd + length, device=dev)
    for pos in POSITIONS + (length - 1, length + 5):
        for ring in (False, True):
            before = _counts()
            got = attn.attend_decode(q, cache, pos, ring)
            assert _delta(before) == {"kernel": 1, "einsum": 0}
            want = attn._attend_decode_einsum(q, cache["k"], cache["v"],
                                              pos, ring)
            assert got.dtype == torch.bfloat16 and got.shape == q.shape
            _within_one_ulp(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,length", [(1, 512), (128, 512)])
def test_kernel_at_granites_scale(dev, b, length):
    """GQA 32:8 (a group of 4 query heads), head 128, scores times 1/128
    (granite's ``attention_multiplier``): within one bf16 ulp of the
    einsum path at the same scale, every call a kernel call."""
    q, cache = _case(b, 32, 8, 128, length, torch.bfloat16, seed=b,
                     device=dev)
    for pos in (0, 127, 300, length - 1):
        before = _counts()
        got = attn.attend_decode(q, cache, pos, False, scale=1 / 128)
        assert _delta(before) == {"kernel": 1, "einsum": 0}
        want = attn._attend_decode_einsum(q, cache["k"], cache["v"], pos,
                                          False, 1 / 128)
        _within_one_ulp(got, want)
        if pos:                      # one slot: softmax 1 at any scale
            assert not torch.equal(got, attn.attend_decode(q, cache, pos,
                                                           False))


@pytest.mark.cuda
@pytest.mark.parametrize("h,hk,hd", [(64, 8, 128), (56, 8, 96),
                                     (32, 32, 160), (16, 1, 32)])
def test_kernel_fp16(dev, h, hk, hd):
    q, cache = _case(8, h, hk, hd, 300, torch.float16, seed=hd, device=dev)
    for pos in (0, 70, 299, 400):
        got = attn.attend_decode(q, cache, pos, ring=True)
        _within_one_ulp(got, attn._attend_decode_einsum(
            q, cache["k"], cache["v"], pos, True))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 9, 17, 33])
def test_kernel_splits_agree(dev, b):
    """The slots split as the batch leaves SMs free (on an H100's 132:
    the 8 tiles of 500 slots in 8, 4, 2 and 1 splits, merged by the second
    pass): within one ulp of the einsum path."""
    q, cache = _case(b, 64, 8, 128, 512, torch.bfloat16, seed=5,
                     device=dev)
    splits, per = dk.split_shape(b * 8, 8, dk._sm_count(dev.index))
    assert splits * per >= 8 > (splits - 1) * per
    got = dk.decode_attention(q, cache["k"], cache["v"], 500)
    _within_one_ulp(got, attn._attend_decode_einsum(
        q, cache["k"], cache["v"], 499, False))


@pytest.mark.cuda
def test_kernel_reads_only_valid_slots_on_the_card(dev):
    q, cache = _case(8, 16, 8, 128, 256, torch.bfloat16, seed=9, device=dev)
    want = dk.decode_attention(q, cache["k"], cache["v"], 100)
    cache["k"][:, 100:] = float("nan")
    cache["v"][:, 100:] = float("nan")
    assert torch.equal(dk.decode_attention(q, cache["k"], cache["v"], 100),
                       want)


@pytest.mark.cuda
def test_fp32_queries_on_the_card_keep_the_einsum_path(dev):
    """The AP route's fp32 queries: the einsum path, bit for bit."""
    q, cache = _case(8, 16, 8, 128, 64, torch.float32, seed=2, device=dev)
    before = _counts()
    got = attn.attend_decode(q, cache, 40, ring=False)
    assert _delta(before) == {"kernel": 0, "einsum": 1}
    assert torch.equal(got, _todays_einsum_path(q, cache, 40, False))


@pytest.mark.cuda
def test_refused_launches_raise(dev):
    q, cache = _case(2, 8, 2, 64, 16, torch.bfloat16, seed=0, device=dev)
    k, v = cache["k"], cache["v"]
    with pytest.raises(ValueError, match="does not take"):
        dk.decode_attention(q.float(), k.float(), v.float(), 4)
    q48, c48 = _case(2, 8, 2, 48, 16, torch.bfloat16, seed=0, device=dev)
    with pytest.raises(ValueError, match="does not take"):
        dk.decode_attention(q48, c48["k"], c48["v"], 4)
    wide = torch.zeros(2, 16, 2, 72, dtype=torch.bfloat16, device=dev)
    before = dict(dk.launch_counts)
    with pytest.raises(ValueError, match="does not take"):
        dk.decode_attention(q, wide[..., 1:65], wide[..., 1:65], 4)
    with pytest.raises(ValueError, match="n_valid"):
        dk.decode_attention(q, k, v, 17)
    assert dk.launch_counts == before


@pytest.mark.cuda
def test_engine_tokens_same_with_kernel_and_einsum(dev, monkeypatch):
    """Greedy ``Engine.generate`` of the tiny qwen2-72b config in bf16 on
    the card: the same tokens through the kernel as through the einsum
    path."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.quant import quantize_model_params
    from repro_torch.serve import Engine, ServeCfg
    cfg = get_smoke_config("qwen2-72b").with_(
        d_model=256, n_heads=8, n_kv_heads=2, head_dim=64, n_layers=2)
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, (4, 8)).astype(np.int32)

    def run():
        eng = Engine(cfg, M.cast_params(cfg, quantize_model_params(
            M.init_params(cfg, seed=0, device=dev))),
            ServeCfg(max_len=64), device=dev)
        return eng.generate(prompts, 40)

    before = _counts()
    with_kernel = run()
    assert _delta(before)["kernel"] > 0
    monkeypatch.setattr(dk, "supports", lambda q, k, v: False)
    before = _counts()
    with_einsum = run()
    assert _delta(before)["kernel"] == 0
    np.testing.assert_array_equal(with_kernel, with_einsum)
