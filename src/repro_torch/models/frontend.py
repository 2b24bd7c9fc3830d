"""Stub modality frontends (counterpart of ``repro.models.frontend``): the
ViT and EnCodec encoders are not built. A caller hands the model
precomputed embeddings instead: internvl2's ``num_patches`` vision patches
per sample, prepended to the text by ``decoding.prefill(patch_embeds=)``,
and musicgen's ``cross_attn_cond`` conditioning embeddings, read by every
attention layer's cross-attention (``cond=``)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import COMPUTE_DTYPE


def patch_embed_spec(batch: int, cfg):
    """(shape, dtype) of a batch's patch embeddings."""
    return (batch, cfg.num_patches, cfg.d_model), COMPUTE_DTYPE


def cond_embed_spec(batch: int, cfg):
    """(shape, dtype) of a batch's conditioning embeddings."""
    return (batch, cfg.cross_attn_cond, cfg.d_model), COMPUTE_DTYPE


def _synth(generator: torch.Generator, spec, device) -> torch.Tensor:
    shape, dtype = spec
    dev = torch.device(device) if device is not None else generator.device
    return (torch.randn(shape, generator=generator, device=dev)
            .to(dtype) * 0.02)


def synth_patch_embeds(generator: torch.Generator, batch: int, cfg,
                       device=None) -> torch.Tensor:
    """Random bf16 patch embeddings, N(0, 1) x 0.02 from ``generator``."""
    return _synth(generator, patch_embed_spec(batch, cfg), device)


def synth_cond_embeds(generator: torch.Generator, batch: int, cfg,
                      device=None) -> torch.Tensor:
    """Random bf16 conditioning embeddings, N(0, 1) x 0.02 from
    ``generator``."""
    return _synth(generator, cond_embed_spec(batch, cfg), device)
