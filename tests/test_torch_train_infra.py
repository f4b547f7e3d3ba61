"""The port's training infrastructure against the reference's, on the CPU:
the data pipeline, checkpoints (both ways between the packages), the
runtime's resume, the ternary gradient compression and the launcher.

Data batches, ``ternarize`` on the same draws, the one-device ternary
all-reduce and checkpoints are held bit for bit; a resumed run equals an
uninterrupted one bit for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.configs import get_smoke_config
from repro.data import DataCfg as RefDataCfg
from repro.data import TokenSource as RefTokenSource
from repro.train import checkpoint as ref_ck
from repro.train import compression as ref_comp
from repro.train import train_step as ref_ts
from repro_torch import configs
from repro_torch.convert import params_from_arrays
from repro_torch.data import DataCfg, Prefetcher, TokenSource
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.train import checkpoint as ck
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts
from repro_torch.train.runtime import RunCfg, Watchdog, train_loop

ROOT = Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal_trees(a: dict, b: dict):
    la, lb = opt.tree_leaves(a), opt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("proc", [(0, 1), (0, 2), (1, 2)])
def test_synthetic_batches_match_reference(proc):
    cfg = dict(vocab=1000, global_batch=8, seq_len=16, seed=3)
    mine = TokenSource(DataCfg(**cfg), *proc)
    ref = RefTokenSource(RefDataCfg(**cfg), *proc)
    for step in (0, 1, 42):
        got, want = mine.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(mine.batch_at(0)["tokens"][:, 1:],
                                  mine.batch_at(0)["targets"][:, :-1])


def test_file_batches_match_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 65535, 5000, dtype=np.uint16) \
        .tofile(path)
    cfg = dict(vocab=65536, global_batch=4, seq_len=32, path=str(path))
    for proc in ((0, 1), (1, 2)):
        mine = TokenSource(DataCfg(**cfg), *proc)
        ref = RefTokenSource(RefDataCfg(**cfg), *proc)
        for step in (0, 3, 50):             # 50 wraps around the file
            for k in ("tokens", "targets"):
                np.testing.assert_array_equal(mine.batch_at(step)[k],
                                              ref.batch_at(step)[k])


def test_sharding_needs_an_even_split():
    with pytest.raises(ValueError, match="divide"):
        TokenSource(DataCfg(vocab=10, global_batch=3, seq_len=4),
                    process_index=0, process_count=2)


def test_prefetcher_orders_batches():
    src = TokenSource(DataCfg(vocab=50, global_batch=2, seq_len=8))
    pf = Prefetcher(src, start_step=3, depth=2)
    try:
        got = [pf.next() for _ in range(3)]
    finally:
        pf.stop()
    assert not pf._thread.is_alive()
    assert [s for s, _ in got] == [3, 4, 5]
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], src.batch_at(s)["tokens"])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _state():
    return {"params": {"a": torch.arange(12.0).reshape(3, 4),
                       "nested": {"b": torch.tensor(
                           [1.5, -2.25, 3e-3, 7.0, 0.0],
                           dtype=torch.bfloat16)}},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    path = ck.save(str(tmp_path), 7, state)
    assert os.path.isdir(path) and path.endswith("step_000000007")
    back = ck.restore(str(tmp_path), 7, device="cpu")
    _equal_trees(back, state)
    assert back["opt"]["step"].shape == ()


def test_checkpoint_port_to_reference(tmp_path):
    """The port saves, the reference restores: same layout, same bits
    (bf16 through the 2-byte payload)."""
    state = _state()
    ck.save(str(tmp_path), 3, state)
    back = ref_ck.restore(str(tmp_path), 3)
    np.testing.assert_array_equal(np.asarray(back["params"]["a"]),
                                  state["params"]["a"].numpy())
    b = np.asarray(back["params"]["nested"]["b"])
    assert b.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        b.view(np.int16), state["params"]["nested"]["b"].view(
            torch.int16).numpy())
    assert np.asarray(back["opt"]["step"]).dtype == np.int32
    assert int(back["opt"]["step"]) == 7


def test_checkpoint_reference_to_port(tmp_path):
    """The reference saves (jax arrays and a numpy leaf), the port
    restores bit for bit; both managers agree on the latest step."""
    rng = np.random.default_rng(1)
    state = {"params": {"w": jnp.asarray(rng.normal(size=(4, 6)),
                                         jnp.float32),
                        "b16": jnp.asarray(rng.normal(size=(5,)),
                                           jnp.bfloat16),
                        "host": rng.normal(size=(2, 3)).astype(np.float32)},
             "opt": {"step": jnp.int32(11)}}
    ref_ck.save(str(tmp_path), 11, state)
    assert ck.latest_step(str(tmp_path)) == 11
    back = ck.restore(str(tmp_path), 11, device="cpu")
    np.testing.assert_array_equal(back["params"]["w"].numpy(),
                                  np.asarray(state["params"]["w"]))
    np.testing.assert_array_equal(back["params"]["host"].numpy(),
                                  state["params"]["host"])
    assert back["params"]["b16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        back["params"]["b16"].view(torch.int16).numpy(),
        np.asarray(state["params"]["b16"]).view(np.int16))
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 11


def test_checkpoint_train_state_crosses_both_ways(tmp_path):
    """A whole smoke train state: reference -> port -> reference."""
    cfg = get_smoke_config("qwen3-0.6b")
    state = ref_ts.init_train_state(cfg, jax.random.PRNGKey(0))
    ref_ck.save(str(tmp_path / "a"), 1, state)
    mine = ck.restore(str(tmp_path / "a"), 1, device="cpu")
    ck.save(str(tmp_path / "b"), 1, mine)
    back = ref_ck.restore(str(tmp_path / "b"), 1)
    for x, y in zip(jax.tree.leaves(state), jax.tree.leaves(back),
                    strict=True):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_keep_last_gc(tmp_path):
    state = {"x": torch.zeros(2)}
    for step in (1, 2, 3, 4, 5):
        ck.save(str(tmp_path), step, state, keep_last=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000004", "step_000000005"]
    assert ck.latest_step(str(tmp_path)) == 5
    assert ck.latest_step(str(tmp_path / "missing")) is None


def test_checkpoint_emergency_not_collected(tmp_path):
    """An emergency save runs no GC: the steps before it stay, past
    keep_last; the next regular save's GC counts it like any step."""
    state = {"x": torch.zeros(2)}
    for step in (1, 2):
        ck.save(str(tmp_path), step, state, keep_last=1 if step == 2 else 3)
    ck.save(str(tmp_path), 3, state, emergency=True)
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                            "step_000000003"]
    with open(tmp_path / "step_000000003" / "manifest.json") as f:
        assert '"emergency": true' in f.read()
    ck.save(str(tmp_path), 4, state, keep_last=1)
    assert ck.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_000000004"]


# ---------------------------------------------------------------------------
# Runtime
# ---------------------------------------------------------------------------

def test_watchdog_flags_stragglers():
    w = Watchdog(factor=2.0)
    for _ in range(8):
        assert w.observe(0.1) is False
    assert w.observe(0.5) is True
    assert w.stragglers == 1


def test_train_loop_resume_exact(tmp_path):
    """Restart mid-run is bit-exact with an uninterrupted run (the
    reference's yi-34b smoke test, every leaf of params and AdamW state)."""
    cfg = configs.get_smoke_config("yi-34b")
    opt_cfg = opt.AdamWCfg(lr=1e-3, warmup_steps=2, total_steps=20)
    src = TokenSource(DataCfg(vocab=cfg.vocab, global_batch=2, seq_len=16))
    step = ts.make_train_step(cfg, opt_cfg)
    full, m_full = train_loop(
        RunCfg(total_steps=8, ckpt_dir=str(tmp_path / "a"), ckpt_every=100,
               log_every=100), ts.init_train_state(cfg, 1, "cpu"), step, src)
    half, _ = train_loop(
        RunCfg(total_steps=4, ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
               log_every=100), ts.init_train_state(cfg, 1, "cpu"), step, src)
    resumed, m_res = train_loop(
        RunCfg(total_steps=8, ckpt_dir=str(tmp_path / "b"), ckpt_every=100,
               log_every=100), None, step, src, device="cpu")
    _equal_trees(resumed, full)
    assert m_res["final_step"] == 8 and len(m_res["losses"]) == 4
    assert m_res["losses"] == m_full["losses"][4:]
    assert len(m_full["step_seconds"]) == 8 and m_full["stragglers"] >= 0


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def _ref_grads(arch="qwen3-0.6b"):
    cfg = get_smoke_config(arch).with_(compute_dtype="float32")
    params = ref_ts.init_train_state(cfg, jax.random.PRNGKey(2))["params"]
    src = RefTokenSource(RefDataCfg(vocab=cfg.vocab, global_batch=2,
                                    seq_len=16))
    batch = {k: jnp.asarray(v) for k, v in src.batch_at(0).items()}
    return jax.jit(jax.grad(ref_ts.make_loss_fn(cfg, None)))(params, batch)


def _ref_draws(grads, step):
    """The reference's per-leaf uniform draws of ``ternary_allreduce``."""
    leaves = jax.tree.leaves(grads)
    key = jax.random.fold_in(jax.random.PRNGKey(17), step)
    keys = jax.random.split(key, len(leaves))
    return [np.asarray(jax.random.uniform(k, x.shape))
            for k, x in zip(keys, leaves)]


def test_ternarize_matches_reference_on_the_same_draws():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(64, 33)).astype(np.float32)
    scale = np.float32(np.abs(g).max() * 1.25)
    key = jax.random.PRNGKey(9)
    want = np.asarray(ref_comp.ternarize(jnp.asarray(g), jnp.asarray(scale),
                                         key))
    u = np.asarray(jax.random.uniform(key, g.shape))
    got = comp.ternarize(torch.from_numpy(g), torch.tensor(scale),
                         torch.from_numpy(u.copy()))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_ternarize_unbiased():
    g = torch.linspace(-1, 1, 1001)
    gen = torch.Generator().manual_seed(0)
    samples = [comp.ternarize(g, torch.tensor(1.0),
                              torch.rand(g.shape, generator=gen)).float()
               for _ in range(200)]
    est = torch.stack(samples).mean(0)
    np.testing.assert_allclose(est.numpy(), g.numpy(), atol=0.12)
    assert comp.wire_bytes({"g": g}) == 1001.0          # int8 wire format


def test_ternary_allreduce_matches_reference_one_device(smoke_mesh):
    """The reference's all-reduce inside its one-device shard_map and the
    port's over one replica, on the reference's grads and draws: bit for
    bit."""
    grads = _ref_grads()
    step = 5
    with smoke_mesh:
        spec = jax.tree.map(lambda _: P(), grads)
        want = jax.jit(shard_map(lambda g: ref_comp.ternary_allreduce(
            g, jax.random.fold_in(jax.random.PRNGKey(17), step)),
            mesh=smoke_mesh, in_specs=(spec,), out_specs=spec))(grads)
    mine = params_from_arrays(_np(grads), device="cpu")
    draws = [torch.from_numpy(u.copy()) for u in _ref_draws(grads, step)]
    got = comp.ternary_allreduce([mine], draws)
    for a, b in zip(opt.tree_leaves(got), jax.tree.leaves(want),
                    strict=True):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compressed_dp_step_on_four_cpu_replicas():
    """Four "cpu" replicas, one sequence each: the averaged grads are
    the same arithmetic done in numpy, every replica applies it, and the
    replicas stay bit-identical."""
    cfg = configs.get_smoke_config("qwen3-0.6b").with_(
        compute_dtype="float32")
    opt_cfg = opt.AdamWCfg(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = make_smoke_mesh("cpu") * 4
    src = TokenSource(DataCfg(vocab=cfg.vocab, global_batch=4, seq_len=16))
    state = ts.init_train_state(cfg, seed=4, device="cpu")
    step = comp.make_compressed_dp_step(cfg, mesh, opt_cfg)
    replicas = comp.replicate(state, mesh)
    for s in range(2):
        batch = {k: torch.from_numpy(v) for k, v in src.batch_at(s).items()}
        base = replicas[0]
        loss_fn = ts.make_loss_fn(cfg)
        per = [ts.value_and_grad(loss_fn, base["params"],
                                 {k: v[r:r + 1] for k, v in batch.items()})
               for r in range(4)]
        draws = comp.uniform_draws(per[0][1], s)
        want = []
        for i, u in enumerate(draws):
            gs = [opt.tree_leaves(g)[i].numpy() for _, g in per]
            scale = np.max([np.abs(g).max() for g in gs]).astype(np.float32)
            total = sum((np.sign(g / scale) * (u.numpy() < np.abs(g / scale))
                         ).astype(np.int8).astype(np.int32) for g in gs)
            want.append(scale * total.astype(np.float32) / np.float32(4))
        want_p, _, _ = opt.adamw_update(
            opt_cfg, opt.tree_unflatten(base["params"], [
                torch.from_numpy(w) for w in want]), base["opt"],
            base["params"])
        replicas, metrics = step(replicas, batch)
        np.testing.assert_allclose(
            float(metrics["loss"]), np.mean([float(l) for l, _ in per]),
            rtol=1e-6)
        for r in replicas:
            _equal_trees(r["params"], want_p)
            assert int(r["opt"]["step"]) == s + 1


def test_compressed_dp_refuses_moe():
    cfg = configs.get_smoke_config("qwen3-moe-30b-a3b")
    with pytest.raises(ValueError, match="dense/SSM"):
        comp.make_compressed_dp_step(cfg, ["cpu"], opt.AdamWCfg())


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--compressed-dp"]],
                         ids=["plain", "compressed-dp"])
def test_launcher_smoke_on_cpu(tmp_path, extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen3-0.6b", "--smoke", "--steps", "3", "--batch", "2",
           "--seq", "16", "--device", "cpu", "--ckpt-every", "2",
           "--ckpt-dir", str(tmp_path)] + extra
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "done: steps=3 loss " in res.stdout
    assert "stragglers=0" in res.stdout
    assert ck.latest_step(str(tmp_path)) == 2
