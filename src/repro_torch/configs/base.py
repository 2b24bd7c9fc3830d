"""Architecture configuration schema (the port's copy of ``repro.configs.base``).

Every architecture is described by an :class:`ArchConfig`. The config is purely
declarative: ``repro_torch.models.transformer`` assembles the network from it
and ``repro_torch.core.plan`` reads the same fields to resolve dispatch.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Layer kinds usable in ``attn_pattern`` (the repeating period of block types).
LAYER_KINDS = ("global", "local", "chunked", "ssm", "rglru")


def pad_to_multiple(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Declarative model description (field-for-field the reference schema)."""

    name: str
    family: str                       # dense | ssm | hybrid | vlm | audio | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention structure -------------------------------------------------
    attn_pattern: Tuple[str, ...] = ("global",)
    window_size: int = 0
    chunk_size: int = 0
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    local_rope_theta: float = 0.0
    pos_embed: str = "rope"           # rope | sinusoidal

    # --- MLP ------------------------------------------------------------------
    mlp_act: str = "silu"             # silu | gelu
    mlp_gated: bool = True

    # --- MoE -------------------------------------------------------------------
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1
    shared_expert: bool = False
    dense_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- SSM (mamba2) ------------------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_kernel: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # --- RG-LRU (recurrentgemma) ---------------------------------------------
    lru_width: int = 0

    # --- embeddings / head -----------------------------------------------------
    tie_embeddings: bool = True
    embed_scale: bool = False
    norm_eps: float = 1e-6
    use_post_norm: bool = False

    # --- modality frontends ----------------------------------------------------
    frontend: str = "none"
    num_patches: int = 0
    num_codebooks: int = 1
    cross_attn_cond: int = 0

    max_seq_len: int = 131_072

    # ---------------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        return pad_to_multiple(self.vocab_size, 256)

    @property
    def pattern_period(self) -> int:
        return len(self.attn_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.pattern_period

    @property
    def remainder_layers(self) -> int:
        return self.num_layers % self.pattern_period

    def layer_kind(self, idx: int) -> str:
        return self.attn_pattern[idx % self.pattern_period]

    def is_moe_layer(self, idx: int) -> bool:
        return self.moe and (idx % self.moe_every == self.moe_every - 1)

    def validate(self) -> None:
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads must divide by kv heads")
        for k in self.attn_pattern:
            if k not in LAYER_KINDS:
                raise ValueError(f"{self.name}: unknown layer kind {k!r}")
        if "local" in self.attn_pattern and self.window_size <= 0:
            raise ValueError(f"{self.name}: local layers need window_size")

    def param_count(self) -> int:
        """Analytic parameter count of an attention-only dense config
        (embedding counted once when tied), counted as the reference counts
        it: qk-norm scales are left out, post-norms are in."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        attn = d * self.num_heads * hd * 2 + 2 * d * self.num_kv_heads * hd
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        mlp = (3 if self.mlp_gated else 2) * d * (self.dense_d_ff or self.d_ff)
        norms = (4 if self.use_post_norm else 2) * d
        return total + self.num_layers * (attn + mlp + norms) + d

    # --- reduced config for CPU tests ------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config (the reference's ``reduced()`` rule)."""
        period = self.pattern_period
        n_layers = period * 2 + (1 if self.remainder_layers else 0)
        kv = min(self.num_kv_heads, 2)
        heads = max(kv * 2, 2)
        repl = {
            "name": self.name + "-reduced",
            "num_layers": n_layers,
            "d_model": 64,
            "num_heads": heads,
            "num_kv_heads": kv,
            "head_dim": 16,
            "d_ff": 128,
            "dense_d_ff": 128 if self.dense_d_ff else 0,
            "vocab_size": 503,
            "window_size": 32 if self.window_size else 0,
            "chunk_size": 32 if self.chunk_size else 0,
            "num_experts": min(self.num_experts, 4) if self.moe else 0,
            "experts_per_token": min(self.experts_per_token, 2) if self.moe
            else 0,
            "ssm_state": 16 if self.ssm_state else 0,
            "ssm_headdim": 16 if self.ssm_state else 64,
            "ssm_expand": 2,
            "ssm_chunk": 16,
            "lru_width": 64 if self.lru_width else 0,
            "num_patches": 8 if self.num_patches else 0,
            "cross_attn_cond": 8 if self.cross_attn_cond else 0,
            "max_seq_len": 512,
        }
        return dataclasses.replace(self, **repl)
