"""Meshes.  A named mesh is a :class:`~torch.distributed.device_mesh.
DeviceMesh` over the initialised process group, one rank per process,
with the reference's axis names; a list of devices stays the data-only
mesh of the runtime (:mod:`repro_torch.apc.runtime`,
:mod:`repro_torch.train.compression`).

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") — the
"pod" axis composes with "data" for batch/DP sharding.  The dry-run
(:mod:`.dryrun`) builds them in one process over the "fake" backend.

Elastic scaling: inside a process group ``make_elastic_mesh`` builds the
largest (data, model) mesh of its ranks, the model dim capped at MAX_TP;
without one it is the list of visible cards.
"""
from __future__ import annotations

import math

import torch

from ..device import resolve_device

MAX_TP = 16


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _named(shape: tuple, axes: tuple):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    if dist.get_world_size() == math.prod(shape):
        return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)
    return DeviceMesh(_device_type(), torch.arange(math.prod(shape))
                      .reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``, over the first ranks of the initialised process
    group; raises when it has fewer."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for {shape}, have {have} — the dry-run "
            f"initialises the 'fake' backend at world size {n} "
            f"(python -m repro_torch.launch.dryrun)")
    return _named(shape, axes)


def make_smoke_mesh(device=None) -> list:
    """One replica on ``device`` (default ``cuda:0``, raising without a
    card; the CPU tests pass ``"cpu"``)."""
    return [resolve_device(device)]


def make_elastic_mesh(devices=None):
    """Inside a process group: the largest (data, model) mesh of its ranks
    (model = gcd(world, MAX_TP)).  Otherwise every visible CUDA device (or
    ``devices``) as a data-parallel list; raises when there is none."""
    import torch.distributed as dist
    if devices is None and dist.is_available() and dist.is_initialized():
        n = dist.get_world_size()
        tp = math.gcd(n, MAX_TP)
        return _named((n // tp, tp), ("data", "model"))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu (or a "
                               "smoke mesh) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def data_axes(mesh) -> tuple[str, ...]:
    """Batch/DP axes present in this mesh ("pod" folds in when it exists);
    ("data",) for a list of devices."""
    from ..models.common import mesh_data_axes
    return mesh_data_axes(mesh)
