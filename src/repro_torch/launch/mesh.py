"""Meshes for one host: a mesh is a list of devices, one data-parallel
replica each (the port's runtime, since :mod:`repro_torch.apc.runtime`).

The one-card analogues of :mod:`repro.launch.mesh`: ``make_smoke_mesh`` for
CPU tests, ``make_elastic_mesh`` for whatever cards exist at boot.  Tensor
parallelism and the pod meshes (``make_production_mesh``) come with the
partition rules (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import torch


def make_smoke_mesh() -> list[str]:
    """One CPU replica (CPU tests)."""
    return ["cpu"]


def make_elastic_mesh(devices=None) -> list[torch.device]:
    """Every visible CUDA device (or ``devices``) as a data-parallel mesh;
    raises when there is none."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu (or a "
                               "smoke mesh) to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]
