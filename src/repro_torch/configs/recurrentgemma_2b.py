"""recurrentgemma-2b [hybrid]: RG-LRU recurrent blocks and local attention,
two recurrent layers to one local.

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000
[arXiv:2402.19427 (Griffin); hf]
Pattern period 3 (rglru, rglru, local); 26 = 8 periods + 2 remainder layers.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    attn_pattern=("rglru", "rglru", "local"),
    window_size=2048,
    lru_width=2560,
    rope_theta=10_000.0,
    mlp_act="gelu",
    mlp_gated=True,
    tie_embeddings=True,
    embed_scale=True,
    max_seq_len=1_048_576,
)
