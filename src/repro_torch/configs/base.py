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
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

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
        if "chunked" in self.attn_pattern and self.chunk_size <= 0:
            raise ValueError(f"{self.name}: chunked layers need chunk_size")
        if "ssm" in self.attn_pattern and (
                self.ssm_state <= 0 or self.d_inner % self.ssm_headdim):
            raise ValueError(f"{self.name}: ssm layers need ssm_state and "
                             "a d_inner that ssm_headdim divides")
        if "rglru" in self.attn_pattern and self.lru_width <= 0:
            raise ValueError(f"{self.name}: rglru layers need lru_width")
        if self.moe and (self.num_experts <= 0
                         or self.experts_per_token <= 0):
            raise ValueError(f"{self.name}: MoE needs experts")

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (embedding counted once when tied), as
        the reference counts it: qk-norm scales and the recurrent blocks'
        biases are left out, post-norms are in, an ssm layer keeps its MLP
        pre-norm though it has no MLP; ``active_only`` counts the routed
        experts a token reaches instead of all of them."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_padded * d * self.num_codebooks
        if not self.tie_embeddings:
            total += self.vocab_padded * d * self.num_codebooks
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            total += d                                      # pre-norm
            if self.use_post_norm:
                total += d
            if kind in ("global", "local", "chunked"):
                attn = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
                if self.qkv_bias:
                    attn += (n_q + 2 * n_kv) * hd
                total += attn
                if self.cross_attn_cond:
                    total += attn + d
            elif kind == "ssm":
                di, g, n = self.d_inner, self.ssm_ngroups, self.ssm_state
                hs = self.ssm_nheads
                total += d * (2 * di + 2 * g * n + hs)      # in_proj
                total += (di + 2 * g * n) * self.ssm_conv_kernel
                total += hs * 3                             # A_log, D, dt_bias
                total += di * d                             # out_proj
            elif kind == "rglru":
                w = self.lru_width
                total += 2 * d * w + w * self.ssm_conv_kernel
                total += 2 * w * max(w // 8, 1)             # the two gates
                total += w + w * d                          # Lambda, out_proj
            if kind in ("global", "local", "chunked", "rglru"):
                nmats = 3 if self.mlp_gated else 2
                if self.is_moe_layer(i):
                    e_params = nmats * d * self.d_ff
                    total += (self.experts_per_token if active_only
                              else self.num_experts) * e_params
                    if self.shared_expert:
                        total += e_params
                    total += d * self.num_experts           # router
                else:
                    total += nmats * d * (self.dense_d_ff or self.d_ff)
            total += d                                      # MLP pre-norm
            if self.use_post_norm:
                total += d
        return total + d                                   # final norm

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


def train_flops_per_token(cfg: ArchConfig) -> int:
    """A trained token's model FLOPs: 6 x the active parameters (forward
    and backward of every dense product)."""
    return 6 * cfg.param_count(active_only=True)
