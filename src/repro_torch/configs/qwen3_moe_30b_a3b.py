"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]:
48L, d_model=2048, 32H (GQA kv=4, head_dim=128), expert d_ff=768,
vocab=151936, qk_norm; every layer is MoE."""
from .base import ModelConfig, MoECfg


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936,
        qk_norm=True, rope_theta=1_000_000.0,
        ffn_pattern=("moe",),
        moe=MoECfg(n_experts=128, top_k=8, d_ff=768),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=256,
        qk_norm=True,
        ffn_pattern=("moe",),
        moe=MoECfg(n_experts=8, top_k=2, d_ff=64),
        remat="none",
    )
