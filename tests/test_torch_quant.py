"""The port's packed-ternary MLP weights (``models/quant.py``) against the
reference's: the packed words and scales equal on the same seeded weights
(2-D and stacked leaves, and through a parameter tree), and the plain
in-graph ``unpack_matmul`` within 1e-5 of the kernel's plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import quant as ref_quant

from repro_torch.convert import packed_mlp_from_arrays
from repro_torch.kernels.ternary_matmul.ref import ternary_matmul_ref
from repro_torch.models import quant


def _mlp(rng, shapes):
    return {k: rng.normal(0, 0.1, s).astype(np.float32)
            for k, s in shapes.items()}


def _assert_packed_equal(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    for key, val in theirs.items():
        val = np.asarray(val)
        got = ours[key].numpy()
        assert got.dtype == val.dtype and got.shape == val.shape, key
        if key.endswith("_packed"):
            assert np.array_equal(got, val), key
        else:
            np.testing.assert_allclose(got, val, rtol=1e-6, err_msg=key)


def test_unpack_matmul_matches_kernel_ref():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 0.05, (64, 48)).astype(np.float32))
    packed, scale = quant._pack_one(w)
    x = torch.from_numpy(rng.normal(0, 1, (8, 64)).astype(np.float32))
    torch.testing.assert_close(quant.unpack_matmul(x, packed, scale),
                               ternary_matmul_ref(x, packed, scale),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [64, 40])
def test_pack_one_and_unpack_matmul_match_reference(k):
    """K = 40 is padded to K' = 48 with zero-quantized rows on both sides;
    x with K < K' is zero-padded by unpack_matmul."""
    rng = np.random.default_rng(k)
    w = rng.normal(0, 0.05, (k, 24)).astype(np.float32)
    t_packed, t_scale = ref_quant._pack_one(jnp.asarray(w))
    o_packed, o_scale = quant._pack_one(torch.from_numpy(w))
    assert np.array_equal(o_packed.numpy(), np.asarray(t_packed))
    np.testing.assert_allclose(o_scale.numpy(), np.asarray(t_scale),
                               rtol=1e-6)
    x = rng.normal(0, 1, (5, k)).astype(np.float32)
    want = ref_quant.unpack_matmul(jnp.asarray(x), t_packed, t_scale)
    ours = packed_mlp_from_arrays({"w_packed": np.asarray(t_packed),
                                   "w_scale": np.asarray(t_scale)},
                                  device="cpu")
    got = quant.unpack_matmul(torch.from_numpy(x), ours["w_packed"],
                              ours["w_scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_pack_mlp_handles_stacked():
    rng = np.random.default_rng(1)
    mlp = _mlp(rng, {"w1": (3, 32, 16), "w3": (3, 32, 16),
                     "w2": (3, 16, 32)})
    ours = quant.pack_mlp_params({k: torch.from_numpy(v)
                                  for k, v in mlp.items()})
    assert ours["w1_packed"].shape == (3, 2, 16)       # 32/16 = 2 words
    assert ours["w1_packed"].dtype == torch.int32
    assert ours["w2_scale"].shape == (3, 32)
    theirs = ref_quant.pack_mlp_params({k: jnp.asarray(v)
                                        for k, v in mlp.items()})
    _assert_packed_equal(ours, theirs)


def test_quantize_model_params_walks_the_tree():
    """Every 'mlp' subtree with a w1 is replaced by its packed form, the
    rest of the tree is left as it is; words and scales equal the
    reference's."""
    rng = np.random.default_rng(2)
    shapes = {"w1": (48, 32), "w3": (48, 32), "w2": (32, 48)}
    tree = {"embed": rng.normal(0, 1, (10, 48)).astype(np.float32),
            "stack": {"pos_0": {"mlp": _mlp(rng, shapes),
                                "attn": {"wq": np.ones((4, 4), np.float32)}},
                      "pos_1": {"mlp": _mlp(rng, {k: (2,) + s for k, s
                                                  in shapes.items()})}},
            "head": {"mlp": {"not_w1": np.zeros(3, np.float32)}}}

    def to(fn, node):
        if isinstance(node, dict):
            return {k: to(fn, v) for k, v in node.items()}
        return fn(node)
    ours = quant.quantize_model_params(to(torch.from_numpy, tree))
    theirs = ref_quant.quantize_model_params(to(jnp.asarray, tree))
    assert torch.equal(ours["embed"], torch.from_numpy(tree["embed"]))
    assert torch.equal(ours["stack"]["pos_0"]["attn"]["wq"],
                       torch.ones((4, 4)))
    assert set(ours["head"]["mlp"]) == {"not_w1"}
    for pos in ("pos_0", "pos_1"):
        _assert_packed_equal(ours["stack"][pos]["mlp"],
                             theirs["stack"][pos]["mlp"])
    # weight bytes: packed int32 words = K*N/16 * 4 = K*N/4 bytes
    pk = ours["stack"]["pos_0"]["mlp"]["w1_packed"]
    assert pk.numel() * 4 * 4 == 48 * 32
