"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
interleaved MoE (every 2nd layer), chunked attention (iRoPE: 3 chunked + 1 full).

48L d_model=5120 40H (GQA kv=8, head_dim=128) d_ff=8192(expert) vocab=202048
[hf:meta-llama/Llama-4-* family; unverified]

Parameter accounting: 24 MoE layers × (128 routed + 1 shared) experts of 3×5120×8192
≈ 390B routed + dense/attn ≈ 400B total, ~17B active (top-1 + shared) — matches the
assigned 400b-a17b.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    attn_pattern=("chunked", "chunked", "chunked", "global"),
    chunk_size=8192,
    rope_theta=500_000.0,
    mlp_act="silu",
    mlp_gated=True,
    moe=True,
    num_experts=128,
    experts_per_token=1,
    moe_every=2,
    shared_expert=True,
    dense_d_ff=16384,
    capacity_factor=1.25,
    tie_embeddings=False,
    max_seq_len=1_048_576,
)
