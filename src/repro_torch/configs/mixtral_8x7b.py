"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=32000
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    attn_pattern=("local",),
    window_size=4096,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    mlp_gated=True,
    moe=True,
    num_experts=8,
    experts_per_token=2,
    moe_every=1,
    tie_embeddings=False,
    max_seq_len=32_768,
)
