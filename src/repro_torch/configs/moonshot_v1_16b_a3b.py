"""moonshot-v1-16b-a3b [moe] — kimi/moonlight 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]: 48L, d_model=2048, 16H (GQA kv=16),
expert d_ff=1408, vocab=163840; every layer is MoE."""
from .base import ModelConfig, MoECfg


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab=163840,
        rope_theta=50_000.0,
        ffn_pattern=("moe",),
        moe=MoECfg(n_experts=64, top_k=6, d_ff=1408),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab=256,
        ffn_pattern=("moe",),
        moe=MoECfg(n_experts=4, top_k=2, d_ff=64),
        remat="none",
    )
