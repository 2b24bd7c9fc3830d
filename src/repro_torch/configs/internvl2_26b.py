"""internvl2-26b [vlm] — InternViT frontend (STUB) + InternLM2-20B backbone.

48L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]

Per spec the modality frontend is a stub: ``input_specs()`` provides 256
precomputed patch embeddings per sample, prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_553,
    attn_pattern=("global",),
    rope_theta=1_000_000.0,
    mlp_act="silu",
    mlp_gated=True,
    tie_embeddings=False,
    frontend="vision",
    num_patches=256,
    max_seq_len=32_768,
)
