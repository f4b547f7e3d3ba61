"""seamless-m4t-medium [audio] — encoder-decoder multimodal backbone
[arXiv:2308.11596]: 12L encoder + 12L decoder, d_model=1024, 16H (kv=16),
d_ff=4096, vocab=256206.  The speech frontend is a STUB per the assignment:
input_specs() supplies precomputed frame embeddings as encoder input
(enc_embeds); the text decoder runs the assigned shape cells.

Interpretation note (DESIGN.md): the assignment lists "12L" for this
enc-dec arch; we instantiate 12 encoder + 12 decoder layers (the published
medium model's symmetric text stack)."""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, enc_layers=12,
        d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab=256206,
        frontend="audio", act="gelu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-smoke", family="audio",
        n_layers=2, enc_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256,
        frontend="audio", act="gelu",
        remat="none",
    )
