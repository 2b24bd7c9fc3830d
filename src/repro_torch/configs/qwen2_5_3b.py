"""qwen2.5-3b [dense]: GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2, head_dim=128) d_ff=11008 vocab=151936
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151_936,
    attn_pattern=("global",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_act="silu",
    mlp_gated=True,
    tie_embeddings=True,
    max_seq_len=32_768,
)
