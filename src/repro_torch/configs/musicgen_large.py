"""musicgen-large [audio] — decoder-only over EnCodec tokens (4 codebooks).

48L d_model=2048 32H (kv=32, head_dim=64) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per spec; tokens are (B, K=4, S) codebook ids with
a delay pattern applied upstream. Text conditioning is a stubbed sequence of 64
precomputed T5 embeddings consumed through cross-attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    attn_pattern=("global",),
    pos_embed="sinusoidal",
    mlp_act="gelu",
    mlp_gated=False,
    tie_embeddings=False,
    frontend="audio",
    num_codebooks=4,
    cross_attn_cond=64,
    max_seq_len=8192,
)
