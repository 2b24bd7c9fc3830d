"""Decoder LM layout, embedding, head and init (counterpart of
``repro.models.transformer``).

Parameters keep the reference's stacked layout: ``params["blocks"]["slot{j}"]``
holds slot ``j`` of every pattern period on a leading period axis (gemma2:
``slot0`` its local layers, ``slot1`` its global ones), which the port walks
with a Python loop where the reference scans. Layers past the last whole
period (recurrentgemma's 26 = 8 x 3 + 2) sit unstacked in
``params["rem"]["rem{j}"]``, remainder layer ``j`` of kind ``slot{j}``'s.
A layer is attention (global, sliding-window ``local`` or ``chunked``), an
RG-LRU block or a Mamba-2 SSD block (``ssm``, which has no MLP after it);
in a config with ``cross_attn_cond`` every attention layer then
cross-attends to a conditioning sequence (``p["cross_attn"]``); its MLP is
dense (``p["mlp"]``) or a mixture of experts (``p["moe"]``, on the slots
``cfg.is_moe_layer`` names).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.models import layers, moe as moe_lib, rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib

# weight matrices (as opposed to norm scales and biases); the port may keep
# bf16 copies of exactly these. The recurrent blocks' convolutions, gates,
# Lambda, A_log, D and dt_bias run in fp32 in the reference and stay fp32.
# The MoE router is cast per call in the reference, so its copy is exact
MATRIX_KEYS = ("embed", "lm_head", "wq", "wk", "wv", "wo",
               "wg", "wu", "wd", "w1", "w2", "router",
               "in_x", "in_gate", "in_proj", "out_proj")
ATTN_KINDS = ("global", "local", "chunked")


def scan_period(cfg) -> int:
    p = cfg.pattern_period
    if cfg.moe:
        p = math.lcm(p, cfg.moe_every)
    return p


def num_scan_periods(cfg) -> int:
    return cfg.num_layers // scan_period(cfg)


def num_remainder(cfg) -> int:
    return cfg.num_layers % scan_period(cfg)


def slot_kinds(cfg):
    """Static (kind, is_moe) for each slot of a period."""
    return [(cfg.layer_kind(j), cfg.is_moe_layer(j))
            for j in range(scan_period(cfg))]


def slot_names(cfg):
    """``[(f"slot{j}", kind), ...]`` for the slots of a period."""
    return [(f"slot{j}", k) for j, (k, _) in enumerate(slot_kinds(cfg))]


def rem_names(cfg):
    """``[(f"rem{j}", kind), ...]`` for the remainder layers."""
    return [(f"rem{j}", k)
            for j, (k, _) in enumerate(slot_kinds(cfg)[:num_remainder(cfg)])]


def layers_in_order(params, cache, cfg):
    """``(layer params, layer cache entry, kind)`` of every layer in depth
    order: the stacked periods, then the remainder layers. ``cache`` may be
    None (entries None)."""
    for i in range(num_scan_periods(cfg)):
        for name, kind in slot_names(cfg):
            yield (layer(params["blocks"][name], i),
                   None if cache is None else layer(cache["blocks"][name], i),
                   kind)
    for name, kind in rem_names(cfg):
        yield (params["rem"][name],
               None if cache is None else cache["rem"][name], kind)


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
    differ from JAX's for the same seed. With ``cfg.cross_attn_cond`` every
    attention layer also holds ``cross_attn`` (``wk``/``wv`` at (d, H, D))
    and ``pre_norm_cross``; with K = ``cfg.num_codebooks`` > 1 the
    embedding is (K, Vp, d) and the head (K, d, Vp)."""
    dev = torch.device(device) if device is not None else generator.device
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # the dense MLPs of a model with MoE layers are dense_d_ff wide
    ff = cfg.dense_d_ff if (cfg.moe and cfg.dense_d_ff) else cfg.d_ff

    def block(kind, is_moe, lead):
        def dense(shape, fan_in):
            return layers.dense_init(generator, lead + shape, fan_in, dev)

        def zeros(*shape):
            return torch.zeros(lead + shape, device=dev)

        p = {"pre_norm": zeros(d), "pre_norm_mlp": zeros(d)}
        if cfg.use_post_norm:
            p.update(post_norm=zeros(d), post_norm_mlp=zeros(d))
        if kind in ATTN_KINDS:
            attn = {"wq": dense((d, H, D), d), "wk": dense((d, KV, D), d),
                    "wv": dense((d, KV, D), d), "wo": dense((H, D, d), H)}
            if cfg.qkv_bias:
                attn.update(bq=zeros(H, D), bk=zeros(KV, D), bv=zeros(KV, D))
            if cfg.qk_norm:
                attn.update(q_norm=zeros(D), k_norm=zeros(D))
            p["attn"] = attn
            if cfg.cross_attn_cond:
                p["cross_attn"] = {
                    "wq": dense((d, H, D), d), "wk": dense((d, H, D), d),
                    "wv": dense((d, H, D), d), "wo": dense((H, D, d), H)}
                p["pre_norm_cross"] = zeros(d)
        elif kind == "ssm":
            p["ssm"] = ssm_lib.init_ssm_params(cfg, generator, dev, lead)
        elif kind == "rglru":
            p["rglru"] = rglru_lib.init_rglru_params(cfg, generator, dev,
                                                     lead)
        if kind == "ssm":
            return p
        if is_moe:
            p["moe"] = moe_lib.init_moe_params(cfg, generator, dev, lead)
        elif cfg.mlp_gated:
            p["mlp"] = {"wg": dense((d, ff), d), "wu": dense((d, ff), d),
                        "wd": dense((ff, d), ff)}
        else:
            p["mlp"] = {"w1": dense((d, ff), d), "w2": dense((ff, d), ff)}
        return p

    kinds = slot_kinds(cfg)
    params = {}
    if num_scan_periods(cfg):
        params["blocks"] = {f"slot{j}": block(kind, is_moe,
                                              (num_scan_periods(cfg),))
                            for j, (kind, is_moe) in enumerate(kinds)}
    if num_remainder(cfg):
        params["rem"] = {f"rem{j}": block(kind, is_moe, ())
                         for j, (kind, is_moe)
                         in enumerate(kinds[:num_remainder(cfg)])}
    books = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    params["embed"] = torch.randn(books + (cfg.vocab_padded, d),
                                  generator=generator, device=dev)
    params["final_norm"] = torch.zeros(d, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(books + (d, cfg.vocab_padded),
                                        generator=generator,
                                        device=dev) / math.sqrt(d)
    return params


def compute_copy(params) -> Dict:
    """The params tree with every dense weight matrix stored once as its
    bf16 copy (the cast the reference repeats per call); norm scales,
    biases and packed weights are left as they are. A multi-codebook
    embedding (K, Vp, d) stays fp32: the reference sums the K gathered
    fp32 rows before its one rounding, which rows rounded first would
    not reproduce."""
    def conv(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = conv(v)
            elif k == "embed" and v.dim() == 3:
                out[k] = v
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
    """tokens (B,S), or (B,K,S) for K codebooks, -> (B,S,d) bf16. The K
    codebooks' rows are summed in fp32 (codebook 0 first, from zero) and
    rounded once, as the reference sums them."""
    if cfg.num_codebooks > 1:
        tok = tokens.long()
        x = torch.zeros(tok.shape[:1] + tok.shape[2:] + (cfg.d_model,),
                        device=tok.device)
        for k in range(cfg.num_codebooks):
            x = x + params["embed"][k].float()[tok[:, k]]
    else:
        x = params["embed"][tokens.long()].float()
    if cfg.embed_scale:
        x = x * math.sqrt(cfg.d_model)
    return x.to(layers.COMPUTE_DTYPE)


def lm_logits(params, x, cfg):
    """x (B,S,d) -> fp32 logits (B,S,Vp), or (B,S,K,Vp) for K codebooks,
    pad vocab masked to NEG_INF."""
    if cfg.num_codebooks > 1:
        w = params["lm_head"]                                  # (K,d,Vp)
        logits = torch.stack([layers.matmul(x, w[k])
                              for k in range(w.shape[0])], dim=-2)
    elif cfg.tie_embeddings:
        logits = layers.matmul(x, layers.cast_compute(params["embed"]).t())
    else:
        logits = layers.matmul(x, params["lm_head"])
    logits = layers.softcap(logits, cfg.final_logit_softcap)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, layers.NEG_INF)
    return logits
