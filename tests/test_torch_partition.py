"""The port's partition rules, input specs and the dry-run's per-rank FLOP
count, on the CPU in this process.

``partition_spec_tree`` is held equal, leaf for leaf, to the reference's
``PartitionSpec`` read as a tuple, on every architecture's published and
smoke tree (the reference's from ``jax.eval_shape(init_params)``, the
port's built on ``meta``), ``ep`` on and off, without a mesh and at the
production mesh sizes (a stand-in with ``.shape``: no ranks needed).
``input_specs`` is held equal in shapes and dtypes on every applicable
(architecture, shape) cell.  The dry-run's count on a data-parallel (8, 1)
mesh of the "fake" backend is exactly 1/8 of one rank's.
"""
import functools

import jax
import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke_config
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro_torch import configs
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.configs.shapes import SHAPES, ShapeCell, applicable
from repro_torch.models import common
from repro_torch.models import model as M

MESH_SIZES = {"none": None, "16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class _Sizes:
    """A mesh stand-in: names to sizes under ``.shape``, no ranks."""

    def __init__(self, sizes):
        self.shape = sizes
        self.axis_names = tuple(sizes)


def _cfgs(arch: str, size: str):
    if size == "full":
        return ref_get_config(arch), configs.get_config(arch)
    return ref_get_smoke_config(arch), configs.get_smoke_config(arch)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str, size: str):
    cfg = _cfgs(arch, size)[0]
    return jax.eval_shape(lambda: ref_model.init_params(
        cfg, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str, size: str):
    return M.init_params(_cfgs(arch, size)[1], device="meta")


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("mesh", tuple(MESH_SIZES))
@pytest.mark.parametrize("ep", (False, True))
@pytest.mark.parametrize("size", ("full", "smoke"))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_spec_tree_matches_reference(arch, size, ep, mesh):
    sizes = MESH_SIZES[mesh]
    stand_in = _Sizes(sizes) if sizes else None
    want = jax.tree.map(
        tuple, ref_common.partition_spec_tree(_ref_shapes(arch, size), ep=ep,
                                              mesh=stand_in),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = common.partition_spec_tree(_port_params(arch, size), ep=ep,
                                     mesh=stand_in)
    assert _as_tuples(got) == _as_tuples(want)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 2)
    spec = (("pod", "data"), None, "model")
    assert common.placements(spec, Mesh()) == (Shard(0), Shard(0), Shard(2))
    assert common.placements((None, "data"), Mesh()) == (
        Replicate(), Shard(1), Replicate())
    # an axis that does not divide its dim is dropped with a shape
    assert common.placements(("model", "data"), Mesh(), (3, 4)) == (
        Replicate(), Shard(1), Replicate())
    assert common.batch_spec(Mesh()) == (("pod", "data"),)
    assert common.activation_spec(["cpu", "cpu"]) == (("data",), None, None)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{path}/{k}")
        return out
    return [(path, tuple(tree.shape), str(tree.dtype).split(".")[-1])]


_CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
          if applicable(configs.get_config(a), SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", _CELLS)
def test_input_specs_match_reference(arch, shape):
    ref_cfg, cfg = ref_get_config(arch), configs.get_config(arch)
    want = ref_model.input_specs(ref_cfg, REF_SHAPES[shape])
    got = M.input_specs(cfg, SHAPES[shape])
    assert {k: v.device.type for k, v in _flat(got)} == \
        {k: "meta" for k, _ in _flat(got)}
    assert _leaves(got) == _leaves(want)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def test_data_parallel_mesh_counts_an_eighth_of_one_rank():
    """The dry-run counts each rank's local program: on a data-parallel
    (8, 1) mesh a rank runs 1/8 of the batch, so exactly 1/8 of one rank's
    FLOPs (FlopCounterMode on DTensors would count the global shapes)."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    cfg = configs.get_smoke_config("qwen3-0.6b")
    cell = ShapeCell("dp", "train", 16, 8)
    try:
        one = dryrun.run_cell(cfg, cell,
                              dryrun.build_mesh((1, 1), ("data", "model")))
        eight = dryrun.run_cell(cfg, cell,
                                dryrun.build_mesh((8, 1), ("data", "model")))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert one["flops"] > 0
    assert one["flops"] == 8 * eight["flops"]
    assert eight["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]
    assert eight["collectives"]["count"] > 0


@pytest.mark.parametrize("kind,passes", (("train", 3), ("prefill", 1)))
def test_model_split_mesh_flops_match_a_hand_count(kind, passes):
    """The dry-run's per-rank FLOPs against a count by hand, not by
    ``torch.utils.flop_counter``: qwen3-0.6b smoke (remat "none") on
    (data 1, model 1) runs every product of the pass, 2·M·K·N each (the
    projections, the two attention einsums over all S x S positions, the
    tied logits), times 3 for a train step (each product's two grads);
    on (1, 2) every product is split over "model" (heads, kv heads, d_ff
    and the vocab all divide 2), so a rank runs exactly half."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    cfg = configs.get_smoke_config("qwen3-0.6b").with_(remat="none")
    b, s = 8, 16
    t = b * s
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    layer = (2 * t * d * h * hd + 2 * 2 * t * d * hk * hd     # q; k, v
             + 2 * 2 * b * h * s * s * hd                     # qk, pv
             + 2 * t * h * hd * d + 3 * 2 * t * d * cfg.d_ff)  # wo; mlp
    hand = passes * (cfg.n_layers * layer + 2 * t * d * cfg.vocab)
    cell = ShapeCell("tp", kind, s, b)
    flops = {}
    try:
        for shape in ((1, 1), (1, 2)):
            flops[shape] = dryrun.run_cell(
                cfg, cell, dryrun.build_mesh(shape, ("data", "model")))["flops"]
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert flops[(1, 1)] == hand
    assert flops[(1, 2)] == hand / 2


def test_meshes_named_and_listed():
    """make_production_mesh raises without enough ranks (naming the fake
    backend) and builds the reference's axes over a fake group;
    make_elastic_mesh is (dp, tp = gcd(world, 16)) inside a group; a list
    of devices keeps one "data" axis."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as launch_mesh
    assert launch_mesh.data_axes(["cpu", "cpu"]) == ("data",)
    assert [str(d) for d in launch_mesh.make_smoke_mesh("cpu")] == ["cpu"]
    try:
        with pytest.raises(RuntimeError, match="fake"):
            launch_mesh.make_production_mesh()
        dryrun.init_fake(512)
        pod = launch_mesh.make_production_mesh()
        multi = launch_mesh.make_production_mesh(multi_pod=True)
        assert (tuple(pod.shape), pod.mesh_dim_names) == (
            (16, 16), ("data", "model"))
        assert (tuple(multi.shape), multi.mesh_dim_names) == (
            (2, 16, 16), ("pod", "data", "model"))
        assert launch_mesh.data_axes(multi) == ("pod", "data")
        dryrun.init_fake(48)
        elastic = launch_mesh.make_elastic_mesh()
        assert tuple(elastic.shape) == (3, 16)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
