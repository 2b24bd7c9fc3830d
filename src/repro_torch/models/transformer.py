"""Decoder LM layout, embedding, head and init (counterpart of
``repro.models.transformer``).

Parameters keep the reference's stacked layout: ``params["blocks"]["slot{j}"]``
holds slot ``j`` of every pattern period on a leading period axis (gemma2:
``slot0`` its local layers, ``slot1`` its global ones), which the port walks
with a Python loop where the reference scans.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.models import layers

# weight matrices (as opposed to norm scales and biases); the port may keep
# bf16 copies of exactly these
MATRIX_KEYS = ("embed", "lm_head", "wq", "wk", "wv", "wo",
               "wg", "wu", "wd", "w1", "w2")


def scan_period(cfg) -> int:
    p = cfg.pattern_period
    if cfg.moe:
        p = math.lcm(p, cfg.moe_every)
    return p


def num_scan_periods(cfg) -> int:
    return cfg.num_layers // scan_period(cfg)


def slot_kinds(cfg):
    """Static (kind, is_moe) for each slot of a period."""
    return [(cfg.layer_kind(j), cfg.is_moe_layer(j))
            for j in range(scan_period(cfg))]


def check_supported(cfg) -> None:
    """The port serves dense decoders of global and sliding-window (local)
    attention layers, with rope and one codebook, so far."""
    kinds = {k for k, _ in slot_kinds(cfg)}
    if not kinds <= {"global", "local"} or cfg.moe \
            or cfg.num_codebooks != 1 or cfg.frontend != "none" \
            or cfg.cross_attn_cond or cfg.pos_embed != "rope" \
            or cfg.remainder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense decoders of global and local "
            "attention layers with rope and one codebook so far")


def slot_names(cfg):
    """``[(f"slot{j}", kind), ...]`` for the slots of a period."""
    return [(f"slot{j}", k) for j, (k, _) in enumerate(slot_kinds(cfg))]


def _rope_theta_for(cfg, kind: str) -> float:
    """Local layers take ``local_rope_theta`` when the config sets one."""
    if kind == "local" and cfg.local_rope_theta > 0:
        return cfg.local_rope_theta
    return cfg.rope_theta


def layer(tree, i: int):
    """Layer ``i`` of a stacked params or cache subtree (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------- init
def init_params(cfg, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Dict:
    """Random parameters with the reference's shapes and init scales:
    normal embeddings, dense weights ~ N(0, 1/fan_in) (``wo``'s fan-in is
    its head axis, as in the reference), zero norms and biases. The values
    differ from JAX's for the same seed."""
    check_supported(cfg)
    dev = torch.device(device) if device is not None else generator.device
    L, d, H, KV, D = (num_scan_periods(cfg), cfg.d_model, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    ff = cfg.d_ff

    def dense(shape, fan_in):
        return torch.randn((L,) + shape, generator=generator, device=dev) \
            / math.sqrt(fan_in)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def block():
        attn = {"wq": dense((d, H, D), d), "wk": dense((d, KV, D), d),
                "wv": dense((d, KV, D), d), "wo": dense((H, D, d), H)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(L, H, D), bk=zeros(L, KV, D),
                        bv=zeros(L, KV, D))
        if cfg.qk_norm:
            attn.update(q_norm=zeros(L, D), k_norm=zeros(L, D))
        if cfg.mlp_gated:
            mlp = {"wg": dense((d, ff), d), "wu": dense((d, ff), d),
                   "wd": dense((ff, d), ff)}
        else:
            mlp = {"w1": dense((d, ff), d), "w2": dense((ff, d), ff)}
        p = {"pre_norm": zeros(L, d), "pre_norm_mlp": zeros(L, d),
             "attn": attn, "mlp": mlp}
        if cfg.use_post_norm:
            p.update(post_norm=zeros(L, d), post_norm_mlp=zeros(L, d))
        return p

    blocks = {name: block() for name, _ in slot_names(cfg)}
    params = {
        "embed": torch.randn((cfg.vocab_padded, d), generator=generator,
                             device=dev),
        "final_norm": zeros(d),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn((d, cfg.vocab_padded),
                                        generator=generator,
                                        device=dev) / math.sqrt(d)
    return params


def compute_copy(params) -> Dict:
    """The params tree with every dense weight matrix stored once as its
    bf16 copy (the cast the reference repeats per call); norm scales,
    biases and packed weights are left as they are."""
    def conv(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = conv(v)
            elif k in MATRIX_KEYS and v.is_floating_point():
                out[k] = layers.cast_compute(v)
            else:
                out[k] = v
        return out
    return conv(params)


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ----------------------------------------------------------- embed / head
def embed_tokens(params, tokens, cfg):
    """tokens (B,S) -> (B,S,d) bf16."""
    x = params["embed"][tokens.long()].float()
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x.to(layers.COMPUTE_DTYPE)


def lm_logits(params, x, cfg):
    """x (B,S,d) -> fp32 logits (B,S,Vp), pad vocab masked to NEG_INF."""
    if cfg.tie_embeddings:
        logits = layers.matmul(x, layers.cast_compute(params["embed"]).t())
    else:
        logits = layers.matmul(x, params["lm_head"])
    logits = layers.softcap(logits, cfg.final_logit_softcap)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, layers.NEG_INF)
    return logits
