"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend
[hf:microsoft/Phi-3-vision-128k-instruct]: 32L, d_model=3072, 32H (kv=32,
i.e. MHA), d_ff=8192, vocab=32064.  The vision frontend is a STUB per the
assignment: input_specs() supplies 576 precomputed patch embeddings that are
prepended to the token embeddings."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192, vocab=32064,
        frontend="vision", n_frontend_tokens=576,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-vision-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        frontend="vision", n_frontend_tokens=8,
        remat="none",
    )
