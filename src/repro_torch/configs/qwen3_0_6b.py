"""qwen3-0.6b [dense] — qk_norm + GQA [hf:Qwen/Qwen3-0.6B family]:
28L, d_model=1024, 16H (GQA kv=8, head_dim=128), d_ff=3072, vocab=151936,
tied embeddings."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=3072, vocab=151936,
        qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        qk_norm=True, tie_embeddings=True,
        remat="none",
    )
