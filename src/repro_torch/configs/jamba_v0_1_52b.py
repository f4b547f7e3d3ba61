"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887]: 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336,
vocab=65536, MoE 16 experts top-2 on every other layer; the attention layer
sits 4 layers into each 8-layer block; attention carries no RoPE (position
comes from the Mamba layers)."""
from .base import ModelConfig, MoECfg, SSMCfg


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=65536,
        use_rope=False,
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        ffn_pattern=("mlp", "moe"),
        moe=MoECfg(n_experts=16, top_k=2, d_ff=14336),
        ssm=SSMCfg(d_state=16, expand=2, head_dim=64, n_groups=1,
                   chunk=256, conv_width=4),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        use_rope=False,
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        ffn_pattern=("mlp", "moe"),
        moe=MoECfg(n_experts=4, top_k=2, d_ff=128),
        ssm=SSMCfg(d_state=16, expand=2, head_dim=16, n_groups=1,
                   chunk=16, conv_width=4),
        remat="none",
    )
