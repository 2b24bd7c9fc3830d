"""mamba2-130m [ssm]: attention-free, Mamba-2 SSD (state-space duality)
blocks with no MLP.

24L d_model=768 d_ff=0 vocab=50280, ssm_state=128 [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50_280,
    attn_pattern=("ssm",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_conv_kernel=4,
    ssm_ngroups=1,
    ssm_chunk=256,
    mlp_gated=False,
    tie_embeddings=True,
    norm_eps=1e-5,
    max_seq_len=1_048_576,
)
