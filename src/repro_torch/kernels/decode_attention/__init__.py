"""GQA decode attention read straight from a bf16 or fp16 KV cache: one
hand-written CUDA kernel (:mod:`.kernel`, ``csrc/decode_attention.cu``)
and its plain PyTorch version (:mod:`.ref`).  ``models.attention.
attend_decode`` routes the calls the kernel takes (:func:`.kernel.
supports`) to it."""
from . import kernel, ref
from .kernel import decode_attention, supports

__all__ = ["kernel", "ref", "decode_attention", "supports"]
