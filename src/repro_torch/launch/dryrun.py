"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step for ONE
rank of a 256- or 512-rank mesh, on ``meta`` tensors, in one process.

``python -m repro_torch.launch.dryrun [--arch A] [--shape S] [--mesh
pod|multipod|both]`` writes one JSON record per cell under
``experiments/dryrun_torch/`` (``--out-dir``); ``launch.report`` turns
them into the dry-run and roofline tables.

How: ``init_process_group("fake", rank=0, world_size=256 or 512,
store=HashStore())`` (the fake backend completes every collective at
once; importing ``torch.testing._internal.distributed.fake_pg`` registers
it), the production mesh over it, the cell's state or cache built on
``meta`` (shapes only) and placed as the partition rules place it, then
the train step, the prefill forward or one decode step, under
:class:`LocalCost`, which counts per rank, on the local program (the ops
each rank runs on its shards; DTensor's own shape propagation is not
counted):

  * FLOPs: ``FlopCounterMode``'s formulas (``torch.utils.flop_counter``)
    on each local op — the count the reference's SPMD ``cost_analysis``
    gives for one device;
  * bytes accessed: operands plus results of every local op that moves
    data (views and metadata ops excluded), the reference's over-count
    convention (``launch/roofline.py``);
  * collectives: the count and the result bytes of each all-gather,
    all-reduce, reduce-scatter and all-to-all (the reference's
    convention, ``src/repro/launch/dryrun.py``), the count also from
    ``CommDebugMode`` (``comm_debug_count``, per op ``comm_debug``);
  * state bytes: the local shards of the step's inputs, exactly (the
    counterpart of ``argument_size_in_bytes``);
  * peak live bytes: the state plus the most bytes held at once by the
    storages the step allocated (each freed when its last tensor dies),
    against the card's 80 GB.

A cell that fails is recorded with ``status: "error"`` and its reason.
The reference needs probe compiles at 0 and 1 super-blocks because XLA
counts a ``while`` body once; this dry-run runs every layer of the
Python loop, so the counts are the full depth's and nothing is
extrapolated.
"""
from __future__ import annotations

import argparse
import json
from contextlib import nullcontext
import os
import time
import traceback
import weakref

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode

RESULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")
CARD_BYTES = 80e9                           # H100 80GB HBM3
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STORE = "HashStore"

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# c10d / functional-collective op name -> (kind, index of the result arg;
# None: the op's return value)
_COLL_OPS = {
    "allreduce_": ("all-reduce", 0),
    "all_reduce": ("all-reduce", None),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "all_gather_into_tensor": ("all-gather", None),
    "all_gather_into_tensor_out": ("all-gather", None),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor": ("reduce-scatter", None),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "all_to_all_single": ("all-to-all", None),
}
_NO_BYTES = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute",
             "expand", "slice", "select", "unsqueeze", "squeeze", "alias",
             "as_strided", "detach", "unbind", "split", "split_with_sizes",
             "narrow", "view_as", "lift_fresh", "empty", "empty_strided",
             "empty_like", "new_empty", "new_empty_strided", "_to_copy_meta"}


def _tensors(tree) -> list[torch.Tensor]:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class LocalCost(TorchDispatchMode):
    """Counts one rank's local program (see the module docstring).  Ops
    on DTensors are passed on (``NotImplemented``) so that DTensor runs
    them as local ops, which come back here; ops on FakeTensors (DTensor's
    shape propagation) are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.coll = {k: 0.0 for k in _COLLECTIVES}
        self.coll_count = 0
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented            # back here as local ops
        if any(t is not torch.Tensor for t in types):
            return func(*args, **kwargs)     # shape propagation: uncounted
        out = func(*args, **kwargs)
        name = func.__name__.split(".")[0]
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional") and name in _COLL_OPS:
            kind, idx = _COLL_OPS[name]
            res = _tensors(out if idx is None else args[idx])
            self.coll[kind] += float(sum(t.nbytes for t in res))
            self.coll_count += 1
        elif name not in _NO_BYTES:
            self.bytes_accessed += sum(t.nbytes for t in
                                       _tensors((args, kwargs, out)))
        for t in _tensors(out):
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def record(self) -> dict:
        coll = dict(self.coll)
        coll["count"] = self.coll_count
        coll["total"] = sum(self.coll[k] for k in _COLLECTIVES)
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "collectives": coll, "step_peak_bytes": self.peak}


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree``."""
    total = 0
    for t in _tensors(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.nbytes
    return total


def init_fake(world: int) -> None:
    """(Re)initialise the default process group: the "fake" backend at
    ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=dist.HashStore())


def build_mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    init_fake(int(torch.tensor(shape).prod()))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def run_cell(cfg, cell, mesh) -> dict:
    """One cell's step for rank 0 of ``mesh`` on meta tensors, counted:
    the record's numbers (without arch/shape/mesh labels)."""
    from ..models import model as M
    from ..models.common import partition_spec_tree, shard_tree
    from ..models.sharded import cache_specs
    from ..train.optimizer import AdamWCfg
    from ..train.train_step import (init_train_state, make_train_step,
                                    shard_batch, shard_train_state)
    specs = M.input_specs(cfg, cell)
    t0 = time.perf_counter()
    if cell.kind == "train":
        state = shard_train_state(init_train_state(cfg, device="meta"), mesh)
        batch = shard_batch(specs, mesh)
        step = make_train_step(cfg, AdamWCfg(), mesh=mesh)
        args = (state, batch)
        run = lambda: step(state, batch)                     # noqa: E731
    else:
        params = M.cast_params(cfg, M.init_params(cfg, device="meta"))
        params = shard_tree(params, partition_spec_tree(params, mesh=mesh),
                            mesh)
        if cell.kind == "prefill":
            batch = shard_batch(specs, mesh)
            args = (params, batch)
            run = lambda: M.forward(cfg, params, batch,      # noqa: E731
                                    mesh=mesh)
        else:
            cache = shard_tree(specs["cache"],
                               cache_specs(cfg, specs["cache"], mesh), mesh)
            tokens = shard_batch({"tokens": specs["tokens"]}, mesh)["tokens"]
            args = (params, cache, tokens)
            run = lambda: M.decode_step(cfg, params, cache,  # noqa: E731
                                        tokens, cell.seq_len - 1, mesh=mesh)
    state_bytes = local_bytes(args)
    cost = LocalCost()
    with torch.no_grad() if cell.kind != "train" else nullcontext():
        with CommDebugMode() as comm, cost:
            out = run()
    rec = cost.record()
    rec["collectives"]["comm_debug"] = {
        str(k): v for k, v in comm.get_comm_counts().items()}
    rec["collectives"]["comm_debug_count"] = comm.get_total_counts()
    del out
    rec.update({
        "run_s": time.perf_counter() - t0,
        "memory": {"argument_bytes": state_bytes,
                   "temp_bytes": rec.pop("step_peak_bytes"),
                   "method": "state shards + LocalCost's live-storage tally"},
    })
    rec["memory"]["peak_bytes"] = (rec["memory"]["argument_bytes"]
                                   + rec["memory"]["temp_bytes"])
    rec["memory"]["fits_80gb"] = rec["memory"]["peak_bytes"] <= CARD_BYTES
    return rec


def lower_cell(arch: str, shape_name: str, mesh_name: str,
               remat: str | None = None, tag: str = "") -> dict:
    """The record of one (arch, shape, mesh) cell."""
    from ..configs import SHAPES, applicable, get_config
    cell = SHAPES[shape_name]
    cfg = get_config(arch)
    if remat:
        cfg = cfg.with_(remat=remat)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "remat": cfg.remat, "tag": tag, "params_total": cfg.n_params,
           "params_active": cfg.n_active_params, "store": STORE}
    runs, reason = applicable(cfg, cell)
    if not runs:
        rec.update(status="skipped", reason=reason)
        return rec
    shape, axes = MESHES[mesh_name]
    mesh = build_mesh(shape, axes)
    rec.update(run_cell(cfg, cell, mesh))
    rec["status"] = "ok"
    return rec


def main(argv=None) -> None:
    from ..configs import SHAPES
    from ..configs.registry import ARCH_IDS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=("pod", "multipod", "both"))
    ap.add_argument("--remat", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=RESULT_DIR)
    ap.add_argument("--force", action="store_true",
                    help="rerun cells whose record exists")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    archs = (args.arch,) if args.arch else ARCH_IDS
    shapes = (args.shape,) if args.shape else tuple(SHAPES)
    meshes = {"pod": ("16x16",), "multipod": ("2x16x16",),
              "both": ("16x16", "2x16x16")}[args.mesh]
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                tagpart = f"_{args.tag}" if args.tag else ""
                fname = os.path.join(args.out_dir,
                                     f"{arch}_{shape}_{mesh_name}"
                                     f"{tagpart}.json")
                if os.path.exists(fname) and not args.force:
                    print(f"[skip] {fname} exists")
                    continue
                print(f"[dryrun] {arch} x {shape} x {mesh_name} ...",
                      flush=True)
                try:
                    rec = lower_cell(arch, shape, mesh_name,
                                     remat=args.remat, tag=args.tag)
                except Exception as e:                 # noqa: BLE001
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "tag": args.tag, "status": "error",
                           "error": f"{type(e).__name__}: {e}"[:2000],
                           "traceback": traceback.format_exc()[-4000:]}
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
                extra = ""
                if rec.get("status") == "ok":
                    extra = (f" flops={rec['flops']:.3e}"
                             f" coll={rec['collectives']['total']:.3e}B"
                             f" peak={rec['memory']['peak_bytes'] / 1e9:.2f}"
                             f"GB run={rec['run_s']:.1f}s")
                print(f"[done] {arch} x {shape} x {mesh_name}: "
                      f"{rec.get('status')}{extra}", flush=True)


if __name__ == "__main__":
    main()
