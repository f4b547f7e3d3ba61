"""gemma3-27b [dense] — 5:1 local:global attention, 128k context
[gemma-3 family]: 62L, d_model=5376, 32H (GQA kv=16, head_dim=128),
d_ff=21504, vocab=262144; sliding window 1024 on local layers; global layers
use the long-context rope base; embeddings scaled by sqrt(d)."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=21504, vocab=262144,
        layer_pattern=("local", "local", "local", "local", "local", "attn"),
        sliding_window=1024,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        embed_scale=True, tie_embeddings=True, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        layer_pattern=("local", "local", "local", "local", "local", "attn"),
        sliding_window=32,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
        embed_scale=True, tie_embeddings=True, act="gelu",
        remat="none",
    )
