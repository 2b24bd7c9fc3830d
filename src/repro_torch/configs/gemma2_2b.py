"""gemma2-2b [dense]: local (sliding-window) and global layers alternating,
attention and final logit softcaps, sandwich post-norms.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    attn_pattern=("local", "global"),
    window_size=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=10_000.0,
    mlp_act="gelu",
    mlp_gated=True,
    tie_embeddings=True,
    embed_scale=True,
    use_post_norm=True,
    max_seq_len=8192,
)
