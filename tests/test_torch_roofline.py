"""The port's roofline terms, the dry-run's collective byte tally, and the
residuals that remat "dots" saves, on the CPU.

The roofline mirrors ``tests/test_roofline.py::
test_roofline_terms_and_dominance`` at the H100's spec-sheet peaks.  The
reference's three HLO-parser tests have no counterpart (the port reads no
HLO); in their place the tally of :class:`repro_torch.launch.dryrun.
LocalCost` is held on a known redistribute.  The remat test holds the
count and the bytes of the products that "dots" saves per smoke
architecture to the reference's ``saved_residuals`` (dots minus full: the
residuals the checkpointed super-blocks add), with grads bit-identical
across "none", "dots" and "full" (``tests/test_torch_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.launch.mesh import make_smoke_mesh
from repro.models import model as ref_model
from repro.train.train_step import make_loss_fn as ref_make_loss_fn
from repro_torch import configs
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import params_from_arrays
from repro_torch.launch import roofline
from repro_torch.models import model as M
from repro_torch.train import train_step as ts

REMAT_ARCHS = ("qwen3-0.6b", "mamba2-2.7b", "gemma3-27b",
               "qwen3-moe-30b-a3b")
BATCH, SEQ = 2, 48


def test_roofline_terms_and_dominance():
    rec = {
        "status": "ok", "arch": "x", "shape": "train_4k",
        "params_active": 1_000_000_000,
        "flops": 1e13, "bytes_accessed": 1e12,
        "collectives": {"total": 1e12},
    }
    out = roofline.analyze(rec, chips=256, shapes=SHAPES)
    assert out["terms"]["compute_s"] == pytest.approx(1e13 / 989e12)
    assert out["terms"]["memory_s"] == pytest.approx(1e12 / 3.35e12)
    assert out["terms"]["collective_s"] == pytest.approx(1e12 / 450e9)
    assert out["dominant"] == "collective_s"
    want_mf = 6.0 * 1e9 * 256 * 4096
    assert out["model_flops_global"] == pytest.approx(want_mf)
    assert out["roofline_fraction"] == pytest.approx(
        (want_mf / (256 * 989e12)) / (1e12 / 450e9))
    assert out["model_to_hlo_flops"] == pytest.approx(want_mf / (256 * 1e13))


def test_collective_tally_of_a_known_redistribute():
    """Shard(0) -> Replicate of an fp32 [8, 4] over 2 ranks: one
    all-gather whose result is the whole tensor, 128 bytes."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import dryrun
    try:
        mesh = dryrun.build_mesh((2,), ("data",))
        x = distribute_tensor(torch.ones(8, 4), mesh, [Shard(0)],
                              src_data_rank=None)
        cost = dryrun.LocalCost()
        with cost:
            y = x.redistribute(mesh, [Replicate()])
        rec = cost.record()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert tuple(y.shape) == (8, 4)
    assert rec["collectives"]["all-gather"] == 128
    assert rec["collectives"]["total"] == 128
    assert rec["collectives"]["count"] == 1
    assert rec["flops"] == 0


def _ref_saved(arch: str, remat: str) -> tuple[int, int]:
    from jax._src.ad_checkpoint import saved_residuals
    cfg = _cfg(ref_get_smoke_config(arch)).with_(remat=remat)
    mesh = make_smoke_mesh()
    params = ref_model.init_params(cfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((BATCH, SEQ), jnp.int32),
             "targets": jnp.zeros((BATCH, SEQ), jnp.int32)}
    with mesh:
        res = saved_residuals(ref_make_loss_fn(cfg, mesh), params, batch)
    return len(res), sum(int(np.prod(a.shape)) * a.dtype.itemsize
                         for a, _ in res)


def _cfg(cfg):
    """At most two super-blocks, so that the reference unrolls its stack
    (a scan saves one stacked residual per position) and the counts are
    per layer on both sides."""
    return cfg.with_(n_layers=min(cfg.n_layers, 2 * cfg.pattern_period))


def _port_saved(arch: str, monkeypatch) -> tuple[int, int]:
    """The products ``dots_policy`` saves in one forward pass."""
    cfg = _cfg(configs.get_smoke_config(arch)).with_(remat="dots")
    saved = []
    inner = M.dots_policy

    def spy(ctx, func, *args, **kwargs):
        policy = inner(ctx, func, *args, **kwargs)
        if policy == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE \
                and not ctx.is_recompute:
            a, b = (args[1], args[2]) if "addmm" in str(func) else args[:2]
            saved.append(a.shape[0] * b.shape[1] * a.element_size())
        return policy

    monkeypatch.setattr(M, "dots_policy", spy)
    ref_cfg = _cfg(ref_get_smoke_config(arch))
    params = params_from_arrays(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))), device="cpu")
    batch = {k: torch.zeros((BATCH, SEQ), dtype=torch.int32)
             for k in ("tokens", "targets")}
    ts.value_and_grad(ts.make_loss_fn(cfg), params, batch)
    return len(saved), sum(saved)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_dots_saves_the_reference_residuals(arch, monkeypatch):
    dots, full = _ref_saved(arch, "dots"), _ref_saved(arch, "full")
    want = (dots[0] - full[0], dots[1] - full[1])
    assert want[0] > 0
    assert _port_saved(arch, monkeypatch) == want
