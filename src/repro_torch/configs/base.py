"""Config system: one frozen dataclass tree per architecture.

Every assigned architecture provides a module in this package exposing
``config()`` (the exact published configuration), ``smoke_config()`` (a
reduced same-family configuration for CPU tests) and the registry maps
``--arch <id>`` to them.  Input shapes (the 4 assigned shape cells) are
defined in :mod:`.shapes`.  The package is a copy of the reference's
``configs`` (plain dataclasses, no framework), held equal to it field for
field by ``tests/test_torch_configs.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    capacity_factor: float = 1.25
    norm_topk: bool = True         # renormalize top-k gate values
    parallelism: str = "tp"        # "tp" (baseline) | "ep" (hillclimb)
    # knobs of a configuration outside the registry, whose subclass makes
    # them fields (granite_4_0_h_small.GraniteMoECfg): class attributes
    # here, not fields, so every registered configuration stays the
    # reference's field for field
    shared_d_ff = 0                # width of a shared SwiGLU expert (0: none)
    dropless = False               # capacity = the tokens: no pair dropped


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256               # SSD chunk length
    conv_width: int = 4
    conv_bias = False              # the conv's bias (class attribute, as
    #                                MoECfg.shared_d_ff; GraniteSSMCfg's field)


@dataclass(frozen=True)
class TernaryCfg:
    """Paper-technique integration: balanced-ternary weight quantization."""
    enabled: bool = False          # serve-path packed ternary projections
    quantize_embed: bool = False
    qat: bool = False              # straight-through-estimator training


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    use_rope: bool = True          # jamba: attention layers carry no rope
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3: different theta on global layers
    embed_scale: bool = False       # gemma: scale embeddings by sqrt(d)
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    # layer pattern: mixer per position within a repeating super-block.
    # entries: "attn" | "local" | "mamba".  ("local" = sliding-window attn)
    layer_pattern: tuple[str, ...] = ("attn",)
    ffn_pattern: tuple[str, ...] = ("mlp",)   # "mlp" | "moe"
    sliding_window: int = 0        # for "local" layers
    moe: MoECfg | None = None
    ssm: SSMCfg | None = None
    enc_layers: int = 0            # >0 -> encoder-decoder
    frontend: str | None = None    # None | "vision" | "audio" (stub embeds)
    n_frontend_tokens: int = 0
    ternary: TernaryCfg = field(default_factory=TernaryCfg)
    # training-time knobs (overridable per run)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "dots"            # "none" | "dots" | "full"
    # heads-indivisible TP fix: inside attention, reshard activations so the
    # batch dim spans (data x model) — every chip works on batch shards and
    # no head-dim sharding is needed (yi-34b: 56 heads vs model=16)
    attn_batch_split: bool = False
    # dry-run cost probes: force scan-free lowering (dense attention,
    # unrolled SSD chunk loop, unrolled layer stack) so XLA cost analysis
    # counts every iteration (while-loop bodies are otherwise counted once)
    probe_unroll: bool = False
    # scalings of a configuration outside the registry, the identity here
    # (class attributes, as MoECfg.shared_d_ff; granite_4_0_h_small's
    # GraniteConfig makes them fields)
    embedding_multiplier = 1.0     # embeddings times this
    residual_multiplier = 1.0      # each sub-block's output times this
    attention_multiplier = 0.0     # attention's score scale (0: hd ** -0.5)
    logits_scaling = 1.0           # logits divided by this

    # -- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_period(self) -> int:
        return int(math.lcm(len(self.layer_pattern), len(self.ffn_pattern)))

    def mixer_at(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def ffn_at(self, layer: int) -> str:
        return self.ffn_pattern[layer % len(self.ffn_pattern)]

    @property
    def is_sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell: not pure full attention."""
        kinds = set(self.layer_pattern)
        return kinds != {"attn"}

    @property
    def has_decoder(self) -> bool:
        return True                # every assigned arch has a decoder stack

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # -- parameter counting (for 6ND model flops) ---------------------------
    def param_counts(self) -> dict[str, int]:
        d, hd = self.d_model, self.head_dim_
        h, hk = self.n_heads, self.n_kv_heads
        counts: dict[str, int] = {}
        embed = self.vocab * d
        counts["embed"] = embed if self.tie_embeddings else 2 * embed

        def attn_params() -> int:
            p = d * (h * hd) + 2 * d * (hk * hd) + (h * hd) * d
            if self.qkv_bias:
                p += h * hd + 2 * hk * hd
            if self.qk_norm:
                p += 2 * hd
            return p

        def mamba_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            n_h = d_in // s.head_dim
            proj_in = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)
            conv = (d_in + 2 * s.n_groups * s.d_state) * s.conv_width
            other = n_h * 2 + d_in               # A, D, norm-ish
            proj_out = d_in * d
            return proj_in + conv + other + proj_out

        def mlp_params() -> int:
            return 3 * d * self.d_ff              # swiglu w1,w3,w2

        def moe_params() -> tuple[int, int]:      # (total, active)
            m = self.moe
            per = 3 * d * m.d_ff
            router = d * m.n_experts
            return (m.n_experts * per + router, m.top_k * per + router)

        total_layers = self.n_layers + self.enc_layers
        mixer_total = 0
        for i in range(self.n_layers):
            kind = self.mixer_at(i)
            mixer_total += mamba_params() if kind == "mamba" else attn_params()
        for _ in range(self.enc_layers):
            mixer_total += attn_params()
        if self.enc_layers:                       # decoder cross-attention
            mixer_total += self.n_layers * attn_params()
        counts["mixers"] = mixer_total

        ffn_total, ffn_active = 0, 0
        for i in range(self.n_layers):
            kind = self.ffn_at(i)
            if kind == "moe" and self.moe is not None:
                t, a = moe_params()
                ffn_total += t
                ffn_active += a
            elif kind == "mlp":
                ffn_total += mlp_params()
                ffn_active += mlp_params()
        for _ in range(self.enc_layers):
            ffn_total += mlp_params()
            ffn_active += mlp_params()
        counts["ffn_total"] = ffn_total
        counts["ffn_active"] = ffn_active
        counts["norms"] = 2 * total_layers * d + d
        counts["total"] = (counts["embed"] + mixer_total + ffn_total
                           + counts["norms"])
        counts["active"] = (counts["embed"] + mixer_total + ffn_active
                            + counts["norms"])
        return counts

    @property
    def n_params(self) -> int:
        return self.param_counts()["total"]

    @property
    def n_active_params(self) -> int:
        return self.param_counts()["active"]
