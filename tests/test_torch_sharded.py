"""The port on named meshes of several ranks, on the CPU: the mirror of
``tests/test_sharded.py``.

Each multi-rank test writes a script under ``tmp_path`` and runs it in a
subprocess that spawns one process per rank on the ``gloo`` backend, each
joining through a ``FileStore`` in ``tmp_path`` (no fixed port, so tests
in parallel workers never collide); rank 0 writes its readings as JSON.
The reference's MoE runs in its own subprocess on 8 placeholder devices,
as ``tests/test_sharded.py::run_sub`` runs it, and so does the reference's
serving ``Engine`` on its (1, 2, 4) mesh, just before the 8-rank serving
run, whose last case holds the port's engine on (1, 2, 4) against it.

The 8-rank cases run in two runs of their own, one after the other:
training (the train step, grads, decode) and serving, so that a failure
in one family leaves the other's readings standing; a failure of the
reference's engine fails its one case.  The reference's engine runs
before the ranks, not beside them, so that its 8 device threads have
the host to themselves (beside them, pinned to two cores, it did not
end in 600 s; alone it takes 50-90 s).  Each of these processes has a
budget of its own: the reference's engine (``REF_TIMEOUT`` a run, and
``REF_STUCK`` for XLA's wait in one collective, which is 40 s by
default and a loaded host can exceed; ``_reference_engine`` says when
it runs again), the serving run (``SERVE_TIMEOUT``) and the training
run (``TRAIN_TIMEOUT``); each run's process group times out with its
run.

Tolerances: the sharded train step (fp32) against one rank within 1e-4
(loss, grad_norm, every param after the step); MoE TP against EP, and both
against the reference's outputs on its mesh, within 1e-4; the engine's
logits against the reference's engine on its mesh by
``tests/test_torch_models.py``'s fp32 rule (allclose, atol = rtol = 1e-4)
or within what the bf16 KV cache moves the reference's own logits.

Serving on a named mesh (the 8-rank serving run): packed-MLP decode, the
engine's greedy tokens and per-step logits (within 1e-4), the AP route
(tokens, the quantized projection inputs and every ``ap_report`` field
equal to one device's, with no tolerance) and ``BatchServer`` waves (equal
to sequential serving).  The one-device references of the AP cases run
first, each on a rank of its own at the same time, and are shared with
``all_gather_object``.  A wave case's requests are all queued before rank
0's dispatcher takes the first, so that they share the first wave however
the threads are scheduled.

On 2 ranks: a ``BatchServer`` on a mesh whose "model" axis is the whole
world (so its process group is the default group) while the caller's
thread runs the same engine and rank 0 heartbeats every millisecond, a
merged AP wave whose first slot one rank holds past ``wave_timeout``,
a step that fails on one rank only (in a float wave and in a merged AP
wave), and two servers in a row.
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
TRAIN_TIMEOUT = 720     # the 8-rank training run: train step, grads, decode
SERVE_TIMEOUT = 900     # the 8-rank serving run
REF_TIMEOUT = 300       # a run of the reference's engine before it
REF_STUCK = 60          # XLA's limit on one collective's wait in that run
REF_ATTEMPTS = 5        # runs of the reference's engine (see below)
TWO_TIMEOUT = 240       # a 2-rank serving case
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
    import datetime
    torch.set_num_threads(1)
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            store=dist.FileStore(store, world),
                            timeout=datetime.timedelta(seconds={timeout}))
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


def run_ranks(tmp_path, world: int, body: str,
              timeout: float = TIMEOUT) -> dict:
    """``body`` (defining ``body(rank, world) -> dict``) on ``world``
    gloo ranks; rank 0's dict."""
    script = tmp_path / "ranks.py"
    out = tmp_path / "out.json"
    script.write_text(_RUNNER.format(
        src=SRC, body=textwrap.dedent(body), world=world,
        store=str(tmp_path / "store"), out=str(out), timeout=timeout))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, timeout=timeout)
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
# (mesh, overrides): packed serving weights (w1_packed ...), d_ff split over
# "model" = 4, 2, 8; with d_ff 96 w1's d_ff splits over 4 but w2_packed's
# 6 words do not, so the MLP runs whole on every model rank
PACKED_DECODE_CASES = (((1, 2, 4), {}), ((2, 2, 2), {}), ((1, 1, 8), {}),
                       ((1, 2, 4), {"d_ff": 96}))
ENGINE_MESHES = ((1, 2, 4), (2, 2, 2))
# (arch, mesh, batch): the AP route at 1 layer, data only and model split
AP_CASES = (("qwen3-0.6b", (1, 8, 1), 8), ("qwen3-0.6b", (1, 2, 4), 8),
            ("qwen3-moe-30b-a3b", (1, 8, 1), 8),
            ("qwen3-moe-30b-a3b", (1, 2, 4), 8))
# (prompt tokens, new tokens) of an AP request: every step of a smoke
# model on the AP is thousands of plain program replays on the CPU
AP_REQUEST = {"qwen3-0.6b": (1, 2), "qwen3-moe-30b-a3b": (1, 1)}
# every ap_report field that does not read a clock
AP_FIELDS = ("write_cycles", "compare_cycles", "sets", "resets",
             "energy_write_j", "energy_compare_j", "energy_total_j",
             "makespan_cycles", "sequential_cycles", "makespan_ns",
             "sequential_ns", "n_graphs", "n_programs",
             "pruned_write_cycles", "pruned_compare_cycles",
             "emitted_passes", "pruned_passes", "resident_hits",
             "resident_misses", "weight_sparsity", "power",
             "n_arrays_total")

# a wave case's requests, all queued before rank 0's dispatcher takes the
# first: until the last submit the server's queue hands out nothing, so a
# gap between the submissions (``gap`` seconds, which the dispatcher could
# otherwise use to start a wave of the first alone) changes no wave
_SUBMIT = """
    def submit_together(srv, reqs, gap=0.1):
        import threading
        import time
        queued = threading.Event()
        get = srv.queue.get

        def get_after_all(timeout=None):
            queued.wait()
            return get(timeout=timeout)
        srv.queue.get = get_after_all
        handles = []
        for p, n in reqs:
            handles.append(srv.submit(p, n))
            time.sleep(gap)
        queued.set()
        return handles
"""

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

    def packed_params(cfg):
        from repro_torch.models import model as M
        from repro_torch.models.quant import quantize_model_params
        return M.cast_params(cfg, quantize_model_params(
            M.init_params(cfg, seed=0, device="cpu")))

    def packed_decode_case(shape, overrides):
        # six decode steps on packed MLPs (fp32) against one rank's
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.models import model as M
        from repro_torch.models.common import partition_spec_tree, shard_tree
        from repro_torch.models.sharded import cache_specs
        cfg = smoke_cfg("qwen3-0.6b", overrides).with_(
            compute_dtype="float32")
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("pod", "data", "model"))
        params = packed_params(cfg)
        placed_p = shard_tree(params, partition_spec_tree(params, mesh=mesh),
                              mesh)
        plain = M.init_cache(cfg, 4, 8, 0, torch.float32, "cpu")
        placed = M.init_cache(cfg, 4, 8, 0, torch.float32, "cpu")
        placed = shard_tree(placed, cache_specs(cfg, placed, mesh), mesh)
        rng = np.random.default_rng(3)
        worst = scale = 0.0
        with torch.no_grad():
            for pos in range(6):
                tok = torch.from_numpy(rng.integers(0, cfg.vocab, (4,)))
                want, _ = M.decode_step(cfg, params, plain, tok, pos)
                got, _ = M.decode_step(cfg, placed_p, placed, tok, pos,
                                       mesh=mesh)
                worst = max(worst, float((got.full_tensor() - want).abs()
                                         .max()))
                scale = max(scale, float(want.abs().max()))
        return {"worst": worst, "scale": scale}

    def serve_cfg(arch, n_layers=None):
        from repro_torch.configs import get_smoke_config
        cfg = get_smoke_config(arch).with_(compute_dtype="float32")
        return cfg if n_layers is None else cfg.with_(n_layers=n_layers)

    def engine_case(shape):
        # the engine's greedy decoding on the mesh against one device:
        # per-step logits and the tokens of generate()
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.serve import Engine, ServeCfg
        cfg = serve_cfg("qwen3-0.6b")
        params = packed_params(cfg)
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("pod", "data", "model"))
        prompts = np.random.default_rng(4).integers(
            1, cfg.vocab, (4, 5)).astype(np.int32)
        one = Engine(cfg, params, ServeCfg(max_len=16), device="cpu")
        many = Engine(cfg, params, ServeCfg(max_len=16), mesh=mesh)
        r1, r8 = one.new_request(prompts, 4), many.new_request(prompts, 4)
        worst = 0.0
        while not r1.done:
            r1.step()
            r8.step()
            worst = max(worst, float((r8.logits - r1.logits).abs().max()))
        got = many.generate(prompts, 4)
        lat = many.last_latency
        lat_ok = abs(lat["prefill_ms"] + lat["decode_ms"] + lat["other_ms"]
                     - lat["request_ms"]) < 1e-6 * max(1.0, lat["request_ms"])
        return {"worst": worst, "tokens": one.generate(prompts, 4).tolist(),
                "stepped": r8.tokens().tolist(), "got": got.tolist(),
                "n_model_steps": lat["n_model_steps"], "latency_ok": lat_ok,
                "cache_placed": str(r8.cache["stack"]["pos_0"]["kv"]["k"]
                                    .placements)}

    def ap_ctx(record=None):
        # the AP serving context of tests/test_torch_serve.py; ``record``
        # collects every quantized projection input (x_int, scale)
        from repro_torch import apc
        ctx = apc.APServeContext(apc.Runtime(apc.ArrayPool(
            4, 64, 64, device="cpu")), x_levels=7)
        if record is not None:
            quantize = ctx.quantize

            def recording(x):
                xi, s = quantize(x)
                record.append((xi.clone(), float(s)))
                return xi, s
            ctx.quantize = recording
        return ctx

    def ap_prompts(arch, batch):
        s, n_new = AP_REQUEST[arch]
        return np.random.default_rng(6).integers(
            1, 256, (batch, s)).astype(np.int32), n_new

    def ap_run(arch, batch, mesh=None):
        # (tokens, quantized inputs, ap_report fields, histogram)
        from repro_torch.serve import Engine, ServeCfg
        cfg = serve_cfg(arch, n_layers=1)
        rec = []
        eng = Engine(cfg, packed_params(cfg), ServeCfg(max_len=8),
                     ap_ctx=ap_ctx(rec), device=None if mesh else "cpu",
                     mesh=mesh)
        prompts, n_new = ap_prompts(arch, batch)
        toks = eng.generate(prompts, n_new)
        rep = eng.ap_report()
        return {"tokens": toks.tolist(), "quantized": rec,
                "report": {k: rep[k] for k in AP_FIELDS},
                "hist": eng.ap_ctx.stats.mismatch_hist.tolist()}

    def ap_case(arch, shape, batch, refs):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("pod", "data", "model"))
        got = ap_run(arch, batch, mesh)
        want = refs[f"ap {arch} {batch}"]
        pairs = list(zip(got["quantized"], want["quantized"]))
        return {"tokens": [got["tokens"], want["tokens"]],
                "n_quantized": [len(got["quantized"]),
                                len(want["quantized"])],
                "x_int_equal": all(torch.equal(a[0], b[0])
                                   for a, b in pairs),
                "scale_rel": max(abs(a[1] - b[1]) / b[1] for a, b in pairs),
                "report": [got["report"], want["report"]],
                "hist": [got["hist"], want["hist"]]}

    WAVE_REQUESTS = ((np.array([[3, 9], [17, 5]], np.int32), 3),
                     (np.array([[11, 2, 8], [4, 4, 30]], np.int32), 2))
    AP_WAVE_REQUESTS = ((np.array([[3], [9]], np.int32), 2),
                        (np.array([[17], [5]], np.int32), 2))

    def sequential(cfg, requests, ap):
        # one device, one request at a time: (tokens, ap_report fields)
        from repro_torch.serve import Engine, ServeCfg
        eng = Engine(cfg, packed_params(cfg), ServeCfg(max_len=8),
                     ap_ctx=ap_ctx() if ap else None, device="cpu")
        out = []
        for p, n in requests:
            toks = eng.generate(p, n)
            rep = eng.ap_report() if ap else None
            out.append((toks.tolist(), rep and {k: rep[k]
                                                for k in AP_FIELDS}))
        return out

    def wave_case(ap, refs):
        # two requests through a BatchServer on (1, 2, 4): one wave a step
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.serve import BatchServer, Engine, ServeCfg
        cfg = serve_cfg("qwen3-0.6b", n_layers=1 if ap else None)
        mesh = init_device_mesh("cpu", (1, 2, 4),
                                mesh_dim_names=("pod", "data", "model"))
        eng = Engine(cfg, packed_params(cfg), ServeCfg(max_len=8),
                     ap_ctx=ap_ctx() if ap else None, mesh=mesh)
        reqs = AP_WAVE_REQUESTS if ap else WAVE_REQUESTS
        with BatchServer(eng) as srv:
            handles = submit_together(srv, reqs)
            got = []
            for h in handles:
                rep = h.ap_report(timeout=300)
                got.append((h.result().tolist(),
                            rep and {k: rep[k] for k in AP_FIELDS}))
        return {"got": got, "want": refs["wave ap" if ap else "wave"],
                "n_waves": srv.n_waves}

    def launcher_case():
        # launch.serve in the process group: the elastic (1, 8) mesh
        from repro_torch.launch import serve as launch_serve
        argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                "--new-tokens", "3"]
        got = launch_serve.main(argv)
        import torch.distributed as dist
        group = dist.group.WORLD
        return {"got": got.tolist(), "world": dist.get_world_size(group)}

    def references(rank):
        # the one-device references of the AP and wave cases, each on a
        # rank of its own, then on every rank
        import torch.distributed as dist
        jobs = {1: lambda: {"ap qwen3-0.6b 8": ap_run("qwen3-0.6b", 8)},
                2: lambda: {"ap qwen3-moe-30b-a3b 8":
                            ap_run("qwen3-moe-30b-a3b", 8)},
                4: lambda: {"wave ap": sequential(
                    serve_cfg("qwen3-0.6b", 1), AP_WAVE_REQUESTS, True)},
                5: lambda: {"wave": sequential(serve_cfg("qwen3-0.6b"),
                                               WAVE_REQUESTS, False)}}
        mine = jobs[rank]() if rank in jobs else {}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        return {k: v for d in every for k, v in d.items()}

    def body(rank, world):
        if FAMILY == "train":
            return train_cases()
        refs = references(rank)
        out = {f"packed {shape} {over}": packed_decode_case(tuple(shape),
                                                           over)
               for shape, over in PACKED}
        for shape in ENGINES:
            out[f"engine {shape}"] = engine_case(tuple(shape))
        for arch, shape, batch in APS:
            out[f"ap {arch} {shape} {batch}"] = ap_case(arch, tuple(shape),
                                                        batch, refs)
        out["wave"] = wave_case(False, refs)
        out["wave ap"] = wave_case(True, refs)
        out["launcher"] = launcher_case()
        out["reference"] = reference_case(REF_PATH)
        return out

    def reference_case(path):
        # the reference's Engine on its (1, 2, 4) mesh of 8 devices against
        # the port's Engine(mesh=) on (1, 2, 4), on its packed weights
        # carried across: per-step logits and greedy tokens on the float
        # route; at 1 layer the AP route's tokens and ap_report.  Its
        # readings were written before the ranks started (or the error
        # its process ended with)
        import pickle
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.convert import params_from_arrays
        from repro_torch.models import model as M
        from repro_torch.serve import Engine, ServeCfg
        if not os.path.exists(path):
            return {"error": open(path + ".err").read()}
        with open(path, "rb") as f:
            ref = pickle.load(f)
        mesh = init_device_mesh("cpu", (1, 2, 4),
                                mesh_dim_names=("pod", "data", "model"))
        cfg = serve_cfg("qwen3-0.6b")
        eng = Engine(cfg, M.cast_params(cfg, params_from_arrays(
            ref["params"], device="cpu")), ServeCfg(max_len=16), mesh=mesh)
        req = eng.new_request(ref["prompts"], ref["n_new"])
        steps = []
        for want, want32 in zip(ref["logits"], ref["logits32"]):
            req.step()
            got = req.logits.numpy()
            steps.append({
                "close": bool(np.allclose(got, want, atol=TOL, rtol=TOL)),
                "gap": float(np.abs(got - want).max()),
                "noise": float(np.abs(want32 - want).max())})
        cfg1 = serve_cfg("qwen3-0.6b", n_layers=1)
        ap = Engine(cfg1, M.cast_params(cfg1, params_from_arrays(
            ref["params_ap"], device="cpu")), ServeCfg(max_len=8),
            ap_ctx=ap_ctx(), mesh=mesh)
        ap_toks = ap.generate(ref["ap_prompts"], ref["ap_new"])
        rep = ap.ap_report()
        return {"steps": steps, "n_steps": [req.n_model_steps,
                                            len(ref["logits"])],
                "tokens": [req.tokens().tolist(), ref["stepped"]],
                "generated": [eng.generate(ref["prompts"], ref["n_new"])
                              .tolist(), ref["tokens"]],
                "ap_tokens": [ap_toks.tolist(), ref["ap_tokens"]],
                "report": [{k: rep[k] for k in AP_FIELDS}, ref["report"]]}

    def train_cases():
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


# the reference's Engine on its own (1, 2, 4) mesh of 8 placeholder
# devices: qwen3-0.6b smoke, fp32, packed MLPs; greedy, every step's
# logits; then the AP route at 1 layer (ArrayPool(4, 64, 64), x_levels 7)
_REF_ENGINE = '''
import os, pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import apc
from repro.configs import get_smoke_config
from repro.models import model as M
from repro.models.quant import quantize_model_params
from repro.serve.engine import Engine, ServeCfg


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(
        a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating)
        else a), tree)


mesh = Mesh(np.array(jax.devices()).reshape(1, 2, 4),
            ("pod", "data", "model"))
cfg = get_smoke_config("qwen3-0.6b").with_(compute_dtype="float32")
params = quantize_model_params(M.init_params(cfg, jax.random.PRNGKey(0)))
prompts = np.random.default_rng(4).integers(1, cfg.vocab, (4, 5)
                                            ).astype(np.int32)
eng = Engine(cfg, params, mesh, ServeCfg(max_len=16))
with mesh:
    req = eng.new_request(prompts, 4)
    logits = []
    while not req.done:
        req.step()
        logits.append(np.asarray(req.logits))
    # the same steps on an fp32 cache: how far the bf16 cache moves them
    req32 = eng.new_request(prompts, 4)
    req32.cache = M.init_cache(cfg, 4, 16, dtype=jnp.float32)
    logits32 = []
    while not req32.done:
        req32.step()
        logits32.append(np.asarray(req32.logits))
tokens = np.asarray(eng.generate(prompts, 4))
cfg1 = cfg.with_(n_layers=1)
params_ap = quantize_model_params(M.init_params(cfg1, jax.random.PRNGKey(1)))
ctx = apc.APServeContext(apc.Runtime(apc.ArrayPool(4, 64, 64)), x_levels=7)
ap = Engine(cfg1, params_ap, mesh, ServeCfg(max_len=8), ap_ctx=ctx)
ap_prompts = np.random.default_rng(6).integers(1, 256, (2, 1)
                                               ).astype(np.int32)
ap_tokens = np.asarray(ap.generate(ap_prompts, 2))
rep = ap.ap_report()
out = {"params": np_tree(params), "prompts": prompts, "n_new": 4,
       "logits": logits, "logits32": logits32,
       "stepped": req.tokens().tolist(),
       "tokens": tokens.tolist(), "params_ap": np_tree(params_ap),
       "ap_prompts": ap_prompts, "ap_new": 2,
       "ap_tokens": ap_tokens.tolist(),
       "report": {k: rep[k] for k in AP_FIELDS}}
with open(OUT + ".part", "wb") as f:
    pickle.dump(out, f)
os.replace(OUT + ".part", OUT)
'''


# XLA's words when it ends a process whose CPU collective waited past
# --xla_cpu_collective_call_terminate_timeout_seconds
_XLA_STUCK = "Termination timeout for"


def _reference_engine(out: str) -> None:
    """``_REF_ENGINE`` in its own process; its error beside ``out``.  On
    a host with few free cores the reference's eager AP route sometimes
    stalls in an all-gather of its 8 placeholder devices whose partner
    never arrives (10 of 27 runs pinned to one or two cores, none of 3 on
    eight idle ones), and XLA ends the process once the wait
    passes ``REF_STUCK``; the same deterministic program then runs
    again, up to ``REF_ATTEMPTS`` times.  Any other failure is reported
    at once."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_cpu_collective_call_terminate_timeout_seconds="
               f"{REF_STUCK}")
    for _ in range(REF_ATTEMPTS):
        try:
            proc = subprocess.run(
                [sys.executable, "-c", f"OUT = {out!r}\n"
                 f"AP_FIELDS = {AP_FIELDS!r}\n" + _REF_ENGINE],
                capture_output=True, text=True, env=env,
                timeout=REF_TIMEOUT)
        except subprocess.TimeoutExpired:
            err = "the reference's engine timed out"
            break
        if proc.returncode == 0:
            return
        err = proc.stderr[-3000:]
        if _XLA_STUCK not in proc.stderr:
            break
    with open(out + ".err", "w") as f:
        f.write(err)


def _eight(tmp, family: str, ref: str, timeout: float) -> dict:
    """One run of 8 gloo ranks of ``_EIGHT``'s ``family`` of cases."""
    return run_ranks(
        tmp, 8, f"FAMILY = {family!r}\n"
        f"CASES = {GRAD_CASES!r}\nDECODES = {DECODE_CASES!r}\n"
        f"MORE = {MORE_GRAD_CASES!r}\n"
        f"PACKED = {PACKED_DECODE_CASES!r}\n"
        f"ENGINES = {ENGINE_MESHES!r}\nAPS = {AP_CASES!r}\n"
        f"AP_REQUEST = {AP_REQUEST!r}\nAP_FIELDS = {AP_FIELDS!r}\n"
        f"REF_PATH = {ref!r}\n"
        f"TOL = {TOL!r}\n"
        + textwrap.dedent(_SUBMIT) + textwrap.dedent(_EIGHT),
        timeout=timeout)


@pytest.fixture(scope="module")
def eight_train(tmp_path_factory):
    """One run of 8 gloo ranks for the train step, the grad and decode
    cases."""
    return _eight(tmp_path_factory.mktemp("eight_train"), "train", "",
                  TRAIN_TIMEOUT)


@pytest.fixture(scope="module")
def eight_serve(tmp_path_factory):
    """The reference's engine on its mesh, then one run of 8 gloo ranks
    for the serving cases, whose last case reads the reference's."""
    tmp = tmp_path_factory.mktemp("eight_serve")
    ref = str(tmp / "reference.pkl")
    _reference_engine(ref)
    return _eight(tmp, "serve", ref, SERVE_TIMEOUT)


def test_sharded_train_step_matches_one_rank(eight_train):
    """FSDP x TP on a (2, 2, 2) (pod, data, model) mesh of 8 gloo ranks
    equals the same step on one rank: qwen3-0.6b smoke, fp32, remat
    "none", batch 4 x 16."""
    res = eight_train["train_step"]
    (l1, l8), (g1, g8) = res["loss"], res["grad_norm"]
    assert np.isfinite(l1) and abs(l1 - l8) < TOL, res
    assert abs(g1 - g8) < TOL * g1, res
    assert res["param_err"] < TOL, res
    assert "Shard" in res["placements"], res


@pytest.mark.parametrize("arch,shape", GRAD_CASES)
def test_sharded_grads_match_one_rank(eight_train, arch, shape):
    """Every grad of the sharded loss (remat "dots", fp32, MoE as "ep")
    against one rank's, within 1e-4 of the leaf's largest |g|."""
    res = eight_train[arch]
    assert abs(res["loss"][0] - res["loss"][1]) < TOL, res
    assert res["worst"] < TOL, res


@pytest.mark.parametrize("arch,shape,overrides", MORE_GRAD_CASES)
def test_sharded_grads_more_routes(eight_train, arch, shape, overrides):
    """The routes of the per-rank body the cases above leave out, grads
    (remat "dots", fp32) against one rank's within 1e-4 of each leaf's
    largest |g|: attention weights gathered whole where the heads divide
    no "model" rank, qkv bias, the frontend's embeds, the encoder and
    cross-attention, ``attn_batch_split``, and QAT (ternary w2 whole over
    "model" for its absmean, straight-through grads)."""
    res = eight_train[f"{arch} {tuple(shape)} {overrides}"]
    assert abs(res["loss"][0] - res["loss"][1]) < TOL, res
    assert res["worst"] < TOL, res


def test_sharded_train_step_microbatches(eight_train):
    """A step of two microbatches on (2, 2, 2) (the batch a DTensor split
    in two) equals the same step on one rank: loss and params within
    1e-4."""
    res = eight_train["microbatches"]
    assert np.isfinite(res["loss"][0]), res
    assert abs(res["loss"][0] - res["loss"][1]) < TOL, res
    assert res["param_err"] < TOL, res


def test_sharded_ternary_forward_matches_one_rank(eight_train):
    """The fake-quantized ternary MLP with d_ff split over "model" = 4:
    each column's absmean scale covers all of d_ff, so the logits equal
    one rank's within 1e-4 of their largest |value|."""
    res = eight_train["ternary_forward"]
    assert res["worst"] < TOL * max(1.0, res["scale"]), res


@pytest.mark.parametrize("arch,shape,batch", DECODE_CASES)
def test_sharded_decode_matches_one_rank(eight_train, arch, shape, batch):
    """Six decode steps (fp32) on the mesh, the cache placed as the
    reference's dry-run places it (batch or positions over the data axes,
    kv heads or positions over "model", the SSM state over "model"),
    against the same steps on one rank: logits within 1e-4."""
    res = eight_train[f"decode {arch} {tuple(shape)} {batch}"]
    assert res["worst"] < TOL, res


@pytest.mark.parametrize("shape,overrides", PACKED_DECODE_CASES)
def test_sharded_packed_decode_matches_one_rank(eight_serve, shape,
                                                overrides):
    """Packed serving weights (``quantize_model_params``, fp32 compute),
    d_ff split over "model" = 4, 2 and 8 (and at d_ff 96 split in w1 but
    not in w2's packed words): six decode steps' logits within 1e-4 of one
    rank's.  Each rank's down projection is a partial sum; without its sum
    over "model" the logits are off by a tenth of their largest value."""
    res = eight_serve[f"packed {tuple(shape)} {overrides}"]
    assert res["worst"] < TOL, res
    assert res["scale"] > 0.1, res


@pytest.mark.parametrize("shape", ENGINE_MESHES)
def test_engine_on_mesh_matches_one_device(eight_serve, shape):
    """``Engine(mesh=)`` (packed qwen3-0.6b smoke, fp32, batch 4, prompt
    5, 4 new tokens): every step's logits within 1e-4 of the one-device
    engine's, the greedy tokens of ``generate`` and of the stepped request
    equal to its, the cache placed as DTensors, ``last_latency``'s buckets
    summing to the request."""
    res = eight_serve[f"engine {tuple(shape)}"]
    assert res["worst"] < TOL, res
    assert res["got"] == res["tokens"] == res["stepped"], res
    assert res["n_model_steps"] == 5 + 4 - 1 and res["latency_ok"], res
    assert "Shard" in res["cache_placed"], res


@pytest.mark.parametrize("arch,shape,batch", AP_CASES)
def test_ap_route_on_mesh_matches_one_device(eight_serve, arch, shape,
                                             batch):
    """The AP route on a mesh (1 layer, ``ArrayPool(4, 64, 64)``,
    ``x_levels=7``): every rank runs each projection on the whole input
    and the whole weights, so the integers it hands the AP (x_int of every
    projection) equal one device's, and with them the tokens, the
    histogram and every ``ap_report`` field, with no tolerance: on (1, 8,
    1) and on (1, 2, 4).  The x_int are asserted first, so a difference
    shows where it arose.  Each activation scale (max|x| / x_levels, a
    float beside the integers, which the counters never see) may differ
    in its last bit: the mesh's products run on each rank's rows, and the
    CPU's matmul rounds a product of fewer rows differently (in the
    attention's sums over "model" too), so it is held to 1e-6."""
    res = eight_serve[f"ap {arch} {tuple(shape)} {batch}"]
    assert res["n_quantized"][0] == res["n_quantized"][1] > 0, res
    assert res["x_int_equal"], res
    assert res["scale_rel"] < 1e-6, res
    assert res["tokens"][0] == res["tokens"][1], res
    assert res["hist"][0] == res["hist"][1], res
    got, want = res["report"]
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("route", ["wave", "wave ap"])
def test_batch_server_on_mesh_matches_sequential(eight_serve, route):
    """A ``BatchServer`` on (1, 2, 4), two requests in one wave a step
    (the float route on packed weights, 4 steps each, or a merged AP wave
    at 1 layer, 2 steps each):
    tokens, and on the AP every ``ap_report`` field, equal to sequential
    serving on one device."""
    res = eight_serve[route]
    assert res["got"] == res["want"], res
    assert res["n_waves"] == (4 if route == "wave" else 2), res


def test_engine_on_mesh_matches_reference_on_its_mesh(eight_serve):
    """The reference's ``Engine`` on its (1, 2, 4) mesh of 8 placeholder
    devices and the port's ``Engine(mesh=)`` on (1, 2, 4) gloo ranks, on
    the reference's packed weights carried across by ``convert``
    (qwen3-0.6b smoke, fp32): the greedy tokens equal, and every step's
    logits close to the reference's as ``tests/test_torch_models.py``
    holds the port's fp32 decode to it (``allclose``, atol = rtol = 1e-4)
    or, where not, no further from them than the reference's own logits
    move when its KV cache is fp32 instead of bf16.  Both engines keep
    the cache in bf16 (the reference's default); the mesh's K and V, which
    equal one device's to fp32 rounding (the sums over "model" run in
    another order), round to bf16 differently in a few entries, and later
    logits move by about 1e-4, a tenth of what the bf16 cache itself
    moves them.  At 1 layer on the AP (``ArrayPool(4, 64, 64)``,
    ``x_levels=7``, batch 2, 2 new tokens) the tokens and every
    ``ap_report`` field equal, with no tolerance."""
    res = eight_serve["reference"]
    assert "error" not in res, res.get("error")
    assert res["n_steps"][0] == res["n_steps"][1] == 5 + 4 - 1, res
    for step in res["steps"]:
        assert step["close"] or step["gap"] <= step["noise"], res["steps"]
    assert res["steps"][0]["close"], res["steps"]
    assert res["tokens"][0] == res["tokens"][1], res
    assert res["generated"][0] == res["generated"][1] == res["tokens"][1]
    assert res["ap_tokens"][0] == res["ap_tokens"][1], res
    got, want = res["report"]
    assert want["n_graphs"] > 0
    for key in want:
        assert got[key] == want[key], key


def test_launch_serve_in_process_group(eight_serve):
    """``launch.serve`` inside the 8-rank group serves on the elastic
    (data, model) = (1, 8) mesh and returns the one-device launcher's
    tokens (``tests/test_torch_serve.py`` runs that one)."""
    from repro_torch.launch import serve as launch_serve
    res = eight_serve["launcher"]
    want = launch_serve.main(["--arch", "qwen3-0.6b", "--smoke",
                              "--device", "cpu", "--new-tokens", "3"])
    assert res["world"] == 8
    assert res["got"] == want.tolist()


# the 2-rank serving cases (after ``_EIGHT``'s helpers): the tiny packed
# qwen3-0.6b of tests/test_torch_serve.py at 1 layer, fp32, on a (1, 1, 2)
# mesh, whose "model" axis is the whole world, so its group is the
# default group
_TWO = """
    TINY = {"d_model": 16, "d_ff": 24, "n_heads": 2, "n_kv_heads": 2,
            "head_dim": 8, "vocab": 32, "ternary": {"enabled": True},
            "compute_dtype": "float32", "n_layers": 1}

    def tiny():
        from torch.distributed.device_mesh import init_device_mesh
        cfg = smoke_cfg("qwen3-0.6b", TINY)
        mesh = init_device_mesh("cpu", (1, 1, 2),
                                mesh_dim_names=("pod", "data", "model"))
        return cfg, packed_params(cfg), mesh

    def heartbeat_case(rank):
        # the engine's tokens with no server open; then, the server idling
        # with rank 0 heartbeating every millisecond, this thread runs the
        # engine's collectives on the default group, and one request goes
        # through the server
        from repro_torch.serve import BatchServer, Engine, ServeCfg, batcher
        cfg, params, mesh = tiny()
        prompts = np.random.default_rng(0).integers(
            1, cfg.vocab, (2, 4)).astype(np.int32)
        eng = Engine(cfg, params, ServeCfg(max_len=16), mesh=mesh)
        want = eng.generate(prompts, 6)
        batcher._MeshOrder.heartbeat = 1e-3
        with BatchServer(eng) as srv:
            got = [eng.generate(prompts, 6).tolist() for _ in range(3)]
            served = srv.submit(prompts, 6).result(timeout=60)
        return {"want": want.tolist(), "got": got,
                "served": served.tolist(), "n_waves": srv.n_waves}

    def abort_case(rank):
        # a merged AP wave of two requests with wave_timeout 1 s, rank 1's
        # first slot held 3 s before its first graph call
        import time
        from repro_torch.serve import BatchServer, Engine, ServeCfg
        cfg, params, mesh = tiny()
        reqs = ((np.array([[3], [9]], np.int32), 2),
                (np.array([[17], [5]], np.int32), 2))
        one = Engine(cfg, params, ServeCfg(max_len=8), ap_ctx=ap_ctx(),
                     device="cpu")
        want = []
        for p, n in reqs:
            toks = one.generate(p, n)
            rep = one.ap_report()
            want.append([toks.tolist(), {k: rep[k] for k in AP_FIELDS}])
        ctx = ap_ctx()
        if rank == 1:
            quantize, held = ctx.quantize, []

            def slow(x):
                if not held:
                    held.append(True)
                    time.sleep(3.0)
                return quantize(x)
            ctx.quantize = slow
        eng = Engine(cfg, params, ServeCfg(max_len=8), ap_ctx=ctx,
                     mesh=mesh)
        with BatchServer(eng, wave_timeout=1.0) as srv:
            handles = submit_together(srv, reqs)
            got = []
            for h in handles:
                rep = h.ap_report(timeout=120)
                got.append([h.result().tolist(),
                            {k: rep[k] for k in AP_FIELDS}])
        return {"want": want, "got": got, "n_waves": srv.n_waves}

    def diverge_case(rank):
        # two float requests in one wave; on rank 1 alone the first
        # request's first sample raises, after its step's collectives
        from repro_torch.serve import BatchServer, Engine, ServeCfg
        cfg, params, mesh = tiny()
        reqs = ((np.array([[3], [9]], np.int32), 3),
                (np.array([[17], [5]], np.int32), 3))
        eng = Engine(cfg, params, ServeCfg(max_len=8), mesh=mesh)
        want = eng.generate(*reqs[1])
        if rank == 1:
            sample, failed = eng._sample, []

            def failing(logits, index):
                if not failed:
                    failed.append(True)
                    raise RuntimeError("rank 1's own failure")
                return sample(logits, index)
            eng._sample = failing
        with BatchServer(eng) as srv:
            first, second = submit_together(srv, reqs)
            try:
                first.result(timeout=120)
                error = None
            except RuntimeError as e:
                error = type(e).__name__
            got = second.result(timeout=120)
        return {"error": error, "got": got.tolist(), "want": want.tolist(),
                "n_waves": srv.n_waves}

    def diverge_ap_case(rank):
        # three requests in a merged AP wave; on rank 1 alone the first
        # request's first sample raises, after its step's last graph call
        # and collectives, while the other two slots have the rest of their
        # steps, and their collectives, still to run
        from repro_torch.serve import BatchServer, Engine, ServeCfg
        cfg, params, mesh = tiny()
        reqs = ((np.array([[3], [9]], np.int32), 3),
                (np.array([[17], [5]], np.int32), 3),
                (np.array([[12], [2]], np.int32), 3))
        eng = Engine(cfg, params, ServeCfg(max_len=8), ap_ctx=ap_ctx(),
                     mesh=mesh)
        want = [eng.generate(*r).tolist() for r in reqs[1:]]
        if rank == 1:
            sample, failed = eng._sample, []

            def failing(logits, index):
                if not failed:
                    failed.append(True)
                    raise RuntimeError("rank 1's own failure")
                return sample(logits, index)
            eng._sample = failing
        with BatchServer(eng) as srv:
            first, *rest = submit_together(srv, reqs)
            try:
                first.result(timeout=120)
                error = None
            except RuntimeError as e:
                error = type(e).__name__
            got = [h.result(timeout=120).tolist() for h in rest]
        return {"error": error, "got": got, "want": want,
                "n_waves": srv.n_waves}

    def servers_case(rank):
        # two servers in a row, one request each; each server's process
        # group is freed when it closes
        import torch.distributed as dist
        from repro_torch.serve import BatchServer, Engine, ServeCfg
        cfg, params, mesh = tiny()
        prompts = np.random.default_rng(1).integers(
            1, cfg.vocab, (2, 4)).astype(np.int32)
        eng = Engine(cfg, params, ServeCfg(max_len=16), mesh=mesh)
        want = eng.generate(prompts, 3)
        got, freed = [], []
        for _ in range(2):
            with BatchServer(eng) as srv:
                group = srv._order.group
                got.append(srv.submit(prompts, 3).result(timeout=60).tolist())
            try:
                dist.get_process_group_ranks(group)
                freed.append(False)
            except (KeyError, ValueError, RuntimeError):
                freed.append(True)
        return {"want": want.tolist(), "got": got, "freed": freed}
"""


@pytest.mark.parametrize("case", ["heartbeat_case", "abort_case",
                                  "diverge_case", "diverge_ap_case",
                                  "servers_case"])
def test_batch_server_on_mesh_keeps_collectives_in_step(tmp_path, case):
    """Two ways a rank's collectives could fall out of step with the other
    rank's while a ``BatchServer`` serves on a 2-rank mesh, neither of
    which may change an answer.  ``heartbeat_case``: rank 0's idle
    heartbeat (every millisecond here) shares no process group with the
    engine's collectives, which run on the default group ("model" spans
    the world) from the caller's thread meanwhile: the tokens of three
    ``generate`` calls and of a served request equal the engine's with no
    server open (one device's may differ where the bf16 cache rounds a
    near-tie the other way).
    ``abort_case``: a merged AP wave on the mesh decides nothing by its
    clock: with ``wave_timeout`` 1 s (which the server accepts as the
    reference's does, and reads nowhere) and rank 1's first slot held 3 s, no
    rank aborts the wave alone and replays its steps solo, so both
    requests keep one wave a step (2) and their tokens and every
    ``ap_report`` field equal sequential serving on one device.
    ``diverge_case``: a step that fails on rank 1 alone (after its
    collectives) fails its request on both ranks (``WaveDiverged``, rank
    0's reading), and the other request of the wave goes on to the
    engine's tokens in one wave a step (3).  ``diverge_ap_case``: the
    same in a merged AP wave of three, where rank 1's failing slot must
    not stop its peers from running the rest of their steps, whose
    collectives rank 0 waits in.  ``servers_case``: two servers in a row serve the engine's
    tokens, and each frees its process group when it closes."""
    res = run_ranks(tmp_path, 2, f"AP_FIELDS = {AP_FIELDS!r}\n"
                    + textwrap.dedent(_SUBMIT) + textwrap.dedent(_EIGHT)
                    + textwrap.dedent(_TWO)
                    + f"def body(rank, world):\n    return {case}(rank)\n",
                    timeout=TWO_TIMEOUT)
    if case == "heartbeat_case":
        assert res["got"] == [res["want"]] * 3, res
        assert res["served"] == res["want"], res
        assert res["n_waves"] == 4 + 6 - 1, res
    elif case == "abort_case":
        assert res["got"] == res["want"], res
        assert res["n_waves"] == 2, res
    elif case == "servers_case":
        assert res["got"] == [res["want"]] * 2, res
        assert res["freed"] == [True, True], res
    else:
        assert res["error"] == "WaveDiverged", res
        assert res["got"] == res["want"], res
        assert res["n_waves"] == 3, res


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
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_cpu_collective_call_terminate_timeout_seconds="
               f"{TIMEOUT}")
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
