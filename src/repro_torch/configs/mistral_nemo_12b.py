"""mistral-nemo-12b [dense] — full attention, 128k context.

40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131_072,
    attn_pattern=("global",),
    rope_theta=1_000_000.0,
    mlp_act="silu",
    mlp_gated=True,
    tie_embeddings=False,
    max_seq_len=131_072,
)
