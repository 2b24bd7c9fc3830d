"""gemma3-12b [dense] — 5:1 local:global attention, 128k, qk-norm, dual RoPE theta.

48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt family; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262_144,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window_size=1024,
    qk_norm=True,
    rope_theta=1_000_000.0,
    local_rope_theta=10_000.0,
    mlp_act="gelu",
    mlp_gated=True,
    tie_embeddings=True,
    embed_scale=True,
    use_post_norm=True,
    max_seq_len=131_072,
)
