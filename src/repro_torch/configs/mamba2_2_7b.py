"""mamba2-2.7b [ssm] — SSD, attention-free [arXiv:2405.21060]:
64L, d_model=2560, ssm_state=128, vocab=50280; mixer-only blocks (no FFN),
d_inner = 2*d_model, head_dim=64."""
from .base import ModelConfig, SSMCfg


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, head_dim=64,
        d_ff=0, vocab=50280,
        layer_pattern=("mamba",), ffn_pattern=("none",),
        ssm=SSMCfg(d_state=128, expand=2, head_dim=64, n_groups=1,
                   chunk=256, conv_width=4),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=1, n_kv_heads=1, head_dim=16,
        d_ff=0, vocab=256,
        layer_pattern=("mamba",), ffn_pattern=("none",),
        ssm=SSMCfg(d_state=16, expand=2, head_dim=16, n_groups=1,
                   chunk=16, conv_width=4),
        tie_embeddings=True,
        remat="none",
    )
