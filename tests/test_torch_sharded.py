"""The port on named meshes of several ranks, on the CPU: the mirror of
``tests/test_sharded.py``.

Each multi-rank test writes a script under ``tmp_path`` and runs it in a
subprocess that spawns one process per rank on the ``gloo`` backend, each
joining through a ``FileStore`` in ``tmp_path`` (no fixed port, so tests
in parallel workers never collide); rank 0 writes its readings as JSON.
The reference's MoE runs in its own subprocess on 8 placeholder devices,
as ``tests/test_sharded.py::run_sub`` runs it.

Tolerances: the sharded train step (fp32) against one rank within 1e-4
(loss, grad_norm, every param after the step); MoE TP against EP, and both
against the reference's outputs on its mesh, within 1e-4.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
TIMEOUT = 300
TOL = 1e-4

_RUNNER = '''
import json, os, sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

{body}


def worker(rank, world, store, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world))
    try:
        res = body(rank, world)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(worker, args=({world}, {store!r}, {out!r}),
                       nprocs={world}, start_method="spawn")
'''


def run_ranks(tmp_path, world: int, body: str) -> dict:
    """``body`` (defining ``body(rank, world) -> dict``) on ``world``
    gloo ranks; rank 0's dict."""
    script = tmp_path / "ranks.py"
    out = tmp_path / "out.json"
    script.write_text(_RUNNER.format(
        src=SRC, body=textwrap.dedent(body), world=world,
        store=str(tmp_path / "store"), out=str(out)))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


GRAD_CASES = (("qwen3-0.6b", (1, 2, 4)),       # q heads split, kv gathered
              ("jamba-v0.1-52b", (2, 2, 2)),   # mamba whole, MoE TP
              ("qwen3-moe-30b-a3b", (1, 2, 4)))  # MoE EP
# (arch, mesh, overrides of the smoke config): the routes of the per-rank
# body that GRAD_CASES leave out
MORE_GRAD_CASES = (
    ("yi-34b", (1, 1, 8), {}),            # heads divide no "model": whole
    ("qwen2-72b", (2, 2, 2), {}),         # qkv bias
    ("phi-3-vision-4.2b", (2, 2, 2), {}),  # frontend embeds
    ("seamless-m4t-medium", (2, 2, 2), {}),  # encoder, cross-attention
    ("qwen3-0.6b", (1, 2, 4), {"attn_batch_split": True}),
    ("qwen3-0.6b", (1, 2, 4), {"ternary": {"qat": True}}),   # QAT, w2 whole
)
# (arch, mesh, batch): decode against the cache shardings of the reference
DECODE_CASES = (("qwen3-0.6b", (1, 2, 4), 4),   # positions over model
                ("qwen3-0.6b", (2, 2, 2), 1),   # positions over pod x data
                ("jamba-v0.1-52b", (2, 2, 2), 4),  # SSM state over model
                ("seamless-m4t-medium", (2, 2, 2), 4),  # cross-attention
                ("gemma3-27b", (1, 2, 4), 4))   # window ring caches

_EIGHT = """
    def train_step_case():
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_smoke_config
        from repro_torch.train import optimizer as opt
        from repro_torch.train import train_step as ts
        cfg = get_smoke_config("qwen3-0.6b").with_(
            compute_dtype="float32", remat="none")
        batch = {
            "tokens": torch.from_numpy(np.random.default_rng(0)
                .integers(0, cfg.vocab, (4, 16))).int(),
            "targets": torch.from_numpy(np.random.default_rng(1)
                .integers(0, cfg.vocab, (4, 16))).int()}
        state = ts.init_train_state(cfg, seed=0, device="cpu")
        one, m1 = ts.make_train_step(cfg, opt.AdamWCfg(lr=1e-3))(
            state, batch)
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        step = ts.make_train_step(cfg, opt.AdamWCfg(lr=1e-3), mesh=mesh)
        many, m8 = step(state, batch)
        leaves = zip(opt.tree_leaves(many["params"]),
                     opt.tree_leaves(one["params"]))
        placed = opt.tree_leaves(many["params"])[0].placements
        return {"loss": [float(m1["loss"]),
                         float(m8["loss"].full_tensor())],
                "grad_norm": [float(m1["grad_norm"]),
                              float(m8["grad_norm"].full_tensor())],
                "param_err": max(float((a.full_tensor() - w).abs().max())
                                 for a, w in leaves),
                "placements": str(placed)}

    def smoke_cfg(arch, overrides):
        from repro_torch.configs import get_smoke_config
        from repro_torch.configs.base import TernaryCfg
        cfg = get_smoke_config(arch)
        over = dict(overrides)
        if "ternary" in over:
            over["ternary"] = TernaryCfg(**over["ternary"])
        return cfg.with_(**over)

    def smoke_batch(cfg, b=8, s=16):
        # tokens and targets (and the frontend's embeds, the encoder's
        # enc_embeds) from a seed
        rng = np.random.default_rng(0)
        n_front = cfg.n_frontend_tokens if cfg.frontend else 0
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab,
                                                  (b, s - n_front))).int()
                 for k in ("tokens", "targets")}
        if n_front:
            batch["embeds"] = torch.from_numpy(rng.standard_normal(
                (b, n_front, cfg.d_model)).astype(np.float32))
        if cfg.enc_layers:
            batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
                (b, s, cfg.d_model)).astype(np.float32))
        return batch

    def grads_case(arch, shape, overrides=()):
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.train import optimizer as opt
        from repro_torch.train import train_step as ts
        cfg = smoke_cfg(arch, overrides).with_(compute_dtype="float32",
                                               remat="dots")
        if cfg.moe:
            cfg = cfg.with_(moe=cfg.moe.__class__(**{
                **cfg.moe.__dict__, "capacity_factor": 8.0,
                "parallelism": "ep"}))
        batch = smoke_batch(cfg)
        state = ts.init_train_state(cfg, seed=0, device="cpu")
        l1, g1 = ts.value_and_grad(ts.make_loss_fn(cfg), state["params"],
                                   batch)
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("pod", "data", "model"))
        st = ts.shard_train_state(state, mesh)
        l8, g8 = ts.value_and_grad(ts.make_loss_fn(cfg, mesh), st["params"],
                                   ts.shard_batch(batch, mesh))
        worst = max(float((a.full_tensor() - w).abs().max())
                    / float(w.abs().max().clamp_min(1e-12))
                    for a, w in zip(opt.tree_leaves(g8),
                                    opt.tree_leaves(g1)))
        return {"loss": [float(l1), float(l8.full_tensor())],
                "worst": worst}

    def decode_case(arch, shape, batch):
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import model as M
        from repro_torch.models.common import partition_spec_tree, shard_tree
        from repro_torch.models.sharded import cache_specs
        cfg = get_smoke_config(arch).with_(compute_dtype="float32")
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("pod", "data", "model"))
        params = M.cast_params(cfg, M.init_params(cfg, seed=0,
                                                  device="cpu"))
        sharded = shard_tree(params, partition_spec_tree(params, mesh=mesh),
                             mesh)
        def cache():
            return M.init_cache(cfg, batch, 8, 8, torch.float32, "cpu")
        plain, placed = cache(), cache()
        placed = shard_tree(placed, cache_specs(cfg, placed, mesh), mesh)
        rng = np.random.default_rng(3)
        worst = 0.0
        with torch.no_grad():
            for pos in range(6):
                tok = torch.from_numpy(rng.integers(0, cfg.vocab, (batch,)))
                want, _ = M.decode_step(cfg, params, plain, tok, pos)
                got, _ = M.decode_step(cfg, sharded, placed, tok, pos,
                                       mesh=mesh)
                worst = max(worst, float((got.full_tensor() - want).abs()
                                         .max()))
        return {"worst": worst}

    def microbatch_case():
        # two microbatches a step on (2, 2, 2) against one rank's
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.train import optimizer as opt
        from repro_torch.train import train_step as ts
        cfg = smoke_cfg("qwen3-0.6b", {}).with_(compute_dtype="float32",
                                                remat="none")
        batch = smoke_batch(cfg)
        state = ts.init_train_state(cfg, seed=0, device="cpu")
        one, m1 = ts.make_train_step(cfg, opt.AdamWCfg(lr=1e-3),
                                     microbatches=2)(state, batch)
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        many, m8 = ts.make_train_step(cfg, opt.AdamWCfg(lr=1e-3),
                                      microbatches=2, mesh=mesh)(state, batch)
        return {"loss": [float(m1["loss"]),
                         float(m8["loss"].full_tensor())],
                "param_err": max(
                    float((a.full_tensor() - w).abs().max()) for a, w in zip(
                        opt.tree_leaves(many["params"]),
                        opt.tree_leaves(one["params"])))}

    def ternary_forward_case():
        # fake-quantized ternary MLPs (d_ff over "model" = 4): the logits
        # against one rank's
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.models import model as M
        from repro_torch.models.common import partition_spec_tree, shard_tree
        cfg = smoke_cfg("qwen3-0.6b", {"ternary": {"enabled": True}}).with_(
            compute_dtype="float32")
        params = M.cast_params(cfg, M.init_params(cfg, seed=0, device="cpu"))
        mesh = init_device_mesh("cpu", (1, 2, 4),
                                mesh_dim_names=("pod", "data", "model"))
        placed = shard_tree(params, partition_spec_tree(params, mesh=mesh),
                            mesh)
        batch = {"tokens": smoke_batch(cfg)["tokens"]}
        with torch.no_grad():
            want = M.forward(cfg, params, batch)
            got = M.forward(cfg, placed, batch, mesh=mesh).full_tensor()
        return {"worst": float((got - want).abs().max()),
                "scale": float(want.abs().max())}

    def body(rank, world):
        out = {"train_step": train_step_case(),
               "microbatches": microbatch_case(),
               "ternary_forward": ternary_forward_case()}
        for arch, shape in CASES:
            out[arch] = grads_case(arch, tuple(shape))
        for arch, shape, over in MORE:
            out[f"{arch} {shape} {over}"] = grads_case(arch, tuple(shape),
                                                       over)
        for arch, shape, batch in DECODES:
            out[f"decode {arch} {shape} {batch}"] = decode_case(
                arch, tuple(shape), batch)
        return out
"""


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """One run of 8 gloo ranks for the train step and the grad cases."""
    return run_ranks(tmp_path_factory.mktemp("eight"), 8,
                     f"CASES = {GRAD_CASES!r}\nDECODES = {DECODE_CASES!r}\n"
                     f"MORE = {MORE_GRAD_CASES!r}\n"
                     + textwrap.dedent(_EIGHT))


def test_sharded_train_step_matches_one_rank(eight_ranks):
    """FSDP x TP on a (2, 2, 2) (pod, data, model) mesh of 8 gloo ranks
    equals the same step on one rank: qwen3-0.6b smoke, fp32, remat
    "none", batch 4 x 16."""
    res = eight_ranks["train_step"]
    (l1, l8), (g1, g8) = res["loss"], res["grad_norm"]
    assert np.isfinite(l1) and abs(l1 - l8) < TOL, res
    assert abs(g1 - g8) < TOL * g1, res
    assert res["param_err"] < TOL, res
    assert "Shard" in res["placements"], res


@pytest.mark.parametrize("arch,shape", GRAD_CASES)
def test_sharded_grads_match_one_rank(eight_ranks, arch, shape):
    """Every grad of the sharded loss (remat "dots", fp32, MoE as "ep")
    against one rank's, within 1e-4 of the leaf's largest |g|."""
    res = eight_ranks[arch]
    assert abs(res["loss"][0] - res["loss"][1]) < TOL, res
    assert res["worst"] < TOL, res


@pytest.mark.parametrize("arch,shape,overrides", MORE_GRAD_CASES)
def test_sharded_grads_more_routes(eight_ranks, arch, shape, overrides):
    """The routes of the per-rank body the cases above leave out, grads
    (remat "dots", fp32) against one rank's within 1e-4 of each leaf's
    largest |g|: attention weights gathered whole where the heads divide
    no "model" rank, qkv bias, the frontend's embeds, the encoder and
    cross-attention, ``attn_batch_split``, and QAT (ternary w2 whole over
    "model" for its absmean, straight-through grads)."""
    res = eight_ranks[f"{arch} {tuple(shape)} {overrides}"]
    assert abs(res["loss"][0] - res["loss"][1]) < TOL, res
    assert res["worst"] < TOL, res


def test_sharded_train_step_microbatches(eight_ranks):
    """A step of two microbatches on (2, 2, 2) (the batch a DTensor split
    in two) equals the same step on one rank: loss and params within
    1e-4."""
    res = eight_ranks["microbatches"]
    assert np.isfinite(res["loss"][0]), res
    assert abs(res["loss"][0] - res["loss"][1]) < TOL, res
    assert res["param_err"] < TOL, res


def test_sharded_ternary_forward_matches_one_rank(eight_ranks):
    """The fake-quantized ternary MLP with d_ff split over "model" = 4:
    each column's absmean scale covers all of d_ff, so the logits equal
    one rank's within 1e-4 of their largest |value|."""
    res = eight_ranks["ternary_forward"]
    assert res["worst"] < TOL * max(1.0, res["scale"]), res


@pytest.mark.parametrize("arch,shape,batch", DECODE_CASES)
def test_sharded_decode_matches_one_rank(eight_ranks, arch, shape, batch):
    """Six decode steps (fp32) on the mesh, the cache placed as the
    reference's dry-run places it (batch or positions over the data axes,
    kv heads or positions over "model", the SSM state over "model"),
    against the same steps on one rank: logits within 1e-4."""
    res = eight_ranks[f"decode {arch} {tuple(shape)} {batch}"]
    assert res["worst"] < TOL, res


_REF_MOE = '''
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import MoECfg
from repro.models import moe as moe_mod

devs = np.array(jax.devices())
mesh = Mesh(devs[:4].reshape(1, 2, 2), ("pod", "data", "model"))
d, e = 32, 8
cfg_tp = MoECfg(n_experts=e, top_k=2, d_ff=64, parallelism="tp",
                capacity_factor=8.0)
cfg_ep = MoECfg(n_experts=e, top_k=2, d_ff=64, parallelism="ep",
                capacity_factor=8.0)
p = moe_mod.init_moe(jax.random.PRNGKey(0), d, cfg_tp)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, d), jnp.float32)
with mesh:
    y_tp = moe_mod.moe_ffn(p, x, cfg_tp, "silu", mesh)
    y_ep = moe_mod.moe_ffn(p, x, cfg_ep, "silu", mesh)
np.savez(OUT, x=np.asarray(x), y_tp=np.asarray(y_tp), y_ep=np.asarray(y_ep),
         **{k: np.asarray(v) for k, v in p.items()})
'''


def test_moe_tp_ep_parity_and_reference(tmp_path):
    """MoE TP against EP on a (1, 2, 2) mesh of 4 gloo ranks at capacity
    factor 8 (no drops, so the two are equal), both against the
    reference's ``moe_ffn`` on its own 8-device mesh on the same params
    (carried across with ``convert``) and input."""
    ref = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run(
        [sys.executable, "-c", f"OUT = {str(ref)!r}\n" + _REF_MOE],
        capture_output=True, text=True, env=env, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = run_ranks(tmp_path, 4, f'''
        def body(rank, world):
            from torch.distributed.device_mesh import init_device_mesh
            from repro_torch.configs.base import MoECfg
            from repro_torch.convert import params_from_arrays
            from repro_torch.models import moe as moe_mod
            arrays = dict(np.load({str(ref)!r}))
            p = params_from_arrays({{k: arrays[k] for k in
                                    ("router", "w1", "w3", "w2")}},
                                   device="cpu")
            x = torch.from_numpy(arrays["x"])
            mesh = init_device_mesh("cpu", (1, 2, 2),
                                    mesh_dim_names=("pod", "data", "model"))
            out = {{}}
            for mode in ("tp", "ep"):
                cfg = MoECfg(n_experts=8, top_k=2, d_ff=64,
                             parallelism=mode, capacity_factor=8.0)
                y = moe_mod.moe_ffn(p, x, cfg, "silu", mesh=mesh)
                out[mode] = y.full_tensor().numpy().tolist()
                out[mode + "_ep_taken"] = moe_mod.use_ep(cfg, mesh, 64)
            out["plain"] = moe_mod.moe_ffn(p, x, MoECfg(
                n_experts=8, top_k=2, d_ff=64, capacity_factor=8.0),
                "silu").numpy().tolist()
            return out
    ''')
    want = np.load(ref)
    y_tp, y_ep = np.asarray(res["tp"]), np.asarray(res["ep"])
    assert res["ep_ep_taken"] and not res["tp_ep_taken"]
    assert np.max(np.abs(y_tp - y_ep)) < TOL
    assert np.max(np.abs(y_tp - want["y_tp"])) < TOL
    assert np.max(np.abs(y_ep - want["y_ep"])) < TOL
    assert np.max(np.abs(y_tp - np.asarray(res["plain"]))) < TOL


def test_compressed_dp_step_on_four_replicas():
    """The TernGrad step on a list mesh of 4 replicas: loss finite, the
    replicas' params bit-identical after the step."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import compression as comp
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    cfg = get_smoke_config("mamba2-2.7b").with_(remat="none")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16))).int()
             for k in ("tokens", "targets")}
    mesh = ["cpu"] * 4
    replicas = comp.replicate(ts.init_train_state(cfg, seed=0, device="cpu"),
                              mesh)
    step = comp.make_compressed_dp_step(cfg, mesh, opt.AdamWCfg(lr=1e-3))
    replicas, metrics = step(replicas, batch)
    assert np.isfinite(float(metrics["loss"]))
    first = opt.tree_leaves(replicas[0]["params"])
    for r in replicas[1:]:
        for a, w in zip(opt.tree_leaves(r["params"]), first):
            assert torch.equal(a, w)


def test_dryrun_tiny_cell_multipod_axes():
    """The dry-run's machinery on a small fake multi-pod mesh: jamba smoke
    (mamba, attention, MoE) on (2, 2, 2) (pod, data, model), one rank's
    step counted."""
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun
    cfg = get_smoke_config("jamba-v0.1-52b")
    try:
        rec = dryrun.run_cell(cfg, ShapeCell("tiny", "train", 16, 8),
                              dryrun.build_mesh((2, 2, 2),
                                                ("pod", "data", "model")))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["flops"] > 0
    assert rec["bytes_accessed"] > 0
    assert rec["collectives"]["count"] > 0
    assert rec["collectives"]["count"] == rec["collectives"]["comm_debug_count"]
    assert rec["collectives"]["all-gather"] > 0
    assert 0 < rec["memory"]["argument_bytes"] < rec["memory"]["peak_bytes"]
