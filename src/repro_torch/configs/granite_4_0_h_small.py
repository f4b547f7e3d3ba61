"""granite-4.0-h-small [hybrid] — Granite 4.0-H Small, 32B-A9B
(https://huggingface.co/ibm-granite/granite-4.0-h-small, config.json):
40L, d_model=4096, tied vocab=100352, rms_norm_eps=1e-5; a period of 10
layers (five Mamba-2 mixers, one attention, four Mamba-2): 36 Mamba-2
layers of 128 heads x 64, d_state 128, one group, conv 4 with a bias,
chunk 256, and 4 GQA 32:8 attention layers of head 128 with no position
embedding (NoPE); an MoE FFN in every layer, 72 experts top-10 of width
768 (read from ``intermediate_size``) beside a shared SwiGLU expert of
1536; embeddings x12, each sub-block's output x0.22 before the residual
add, attention scores x1/128, logits /16.

The router takes the top 10 of its logits and a softmax over those ten:
the port's softmax, top-k and renormalization (``norm_topk=True``) give
the same gates.  The routed experts drop no pair (``dropless``: the
capacity is the token count; a token's experts are distinct).

Not in the registry (:mod:`.registry`): its knobs are fields of the
subclasses below, which the reference package has not, and the registry
is held to the reference's field for field."""
from __future__ import annotations

from dataclasses import dataclass

from .base import ModelConfig, MoECfg, SSMCfg

PERIOD = ("mamba",) * 5 + ("attn",) + ("mamba",) * 4


@dataclass(frozen=True)
class GraniteMoECfg(MoECfg):
    shared_d_ff: int = 0           # the shared SwiGLU expert's width
    dropless: bool = False         # capacity = tokens


@dataclass(frozen=True)
class GraniteSSMCfg(SSMCfg):
    conv_bias: bool = False        # the depthwise conv's bias


@dataclass(frozen=True)
class GraniteConfig(ModelConfig):
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0     # 0: hd ** -0.5
    logits_scaling: float = 1.0

    def param_counts(self) -> dict[str, int]:
        """The base counts, with each MoE layer's shared expert (total and
        active) and each Mamba layer's conv bias."""
        counts = dict(super().param_counts())
        d, s = self.d_model, self.ssm
        shared = sum(3 * d * self.moe.shared_d_ff for i in range(
            self.n_layers) if self.ffn_at(i) == "moe")
        conv = 0
        if s is not None and s.conv_bias:
            conv = sum(s.expand * d + 2 * s.n_groups * s.d_state
                       for i in range(self.n_layers)
                       if self.mixer_at(i) == "mamba")
        counts["mixers"] += conv
        for key in ("ffn_total", "ffn_active"):
            counts[key] += shared
        for key in ("total", "active"):
            counts[key] += conv + shared
        return counts


def config(n_layers: int = 40) -> GraniteConfig:
    """The published configuration (``n_layers`` whole periods of 10 cut
    it by depth only)."""
    return GraniteConfig(
        name="granite-4.0-h-small", family="hybrid",
        n_layers=n_layers, d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=0, vocab=100352,
        use_rope=False, norm_eps=1e-5, tie_embeddings=True,
        layer_pattern=PERIOD, ffn_pattern=("moe",),
        moe=GraniteMoECfg(n_experts=72, top_k=10, d_ff=768,
                          shared_d_ff=1536, dropless=True),
        ssm=GraniteSSMCfg(d_state=128, expand=2, head_dim=64, n_groups=1,
                          chunk=256, conv_width=4, conv_bias=True),
        embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=0.0078125, logits_scaling=16.0,
    )


def smoke_config() -> GraniteConfig:
    """A CPU size with the same period of 10 and every knob."""
    return GraniteConfig(
        name="granite-smoke", family="hybrid",
        n_layers=10, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=0, vocab=256,
        use_rope=False, norm_eps=1e-5, tie_embeddings=True,
        layer_pattern=PERIOD, ffn_pattern=("moe",),
        moe=GraniteMoECfg(n_experts=8, top_k=3, d_ff=32, shared_d_ff=48,
                          dropless=True),
        ssm=GraniteSSMCfg(d_state=16, expand=2, head_dim=16, n_groups=1,
                          chunk=16, conv_width=4, conv_bias=True),
        embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=1 / 16, logits_scaling=16.0,
        remat="none",
    )
