"""repro_torch — the MvAP/TAP framework in PyTorch, for NVIDIA Hopper.

The port of the JAX package :mod:`repro`, module for module; it imports
neither JAX nor anything of ``repro``.

Layers:
  core/     the paper's contribution (LUT compiler + MvAP functional
            simulator, Table XI energy model)
  apc/      AP program compiler (microcode IR -> flat schedule -> fused
            executor with kernel-side counters)
  kernels/  hand-written CUDA kernels for sm_90a (fused LUT passes +
            whole-program kernel), each with its plain PyTorch version
  convert   rebuild programs and stats from the reference's plain arrays

Entry points take ``device=None``, which means ``cuda:0``; without a card
they raise unless given ``device="cpu"`` (see :mod:`repro_torch.device`).
"""

__version__ = "0.1.0"
