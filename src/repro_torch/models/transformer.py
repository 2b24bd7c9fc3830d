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

The training forward lives here too: :func:`apply_block` (one layer in the
prefill form, whose pieces ``models.decoding`` shares), :func:`forward`
with the reference's remat policies, and the chunked cross-entropy
:func:`loss_from_hidden` behind :func:`loss_fn`. Autograd differentiates
it: the attention through ``models.flash`` (the sliding-window kernel
forward with its log-sum-exp, the flash backward kernel), the products
through ``layers.matmul``'s bf16 backward.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core import plan as plan_lib
from repro_torch.models import layers, moe as moe_lib, rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import COMPUTE_DTYPE, rms_norm

MOE_AUX_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4
LOSS_CHUNK = 512          # positions per chunk of the vocab-sized logits
REMAT_POLICIES = ("none", "full", "dots", "dots_no_batch")

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
def init_block(cfg, kind: str, is_moe: bool, generator: torch.Generator,
               device, lead=()) -> Dict:
    """One layer's random parameters of ``kind`` (``lead`` stacks them),
    drawn from ``generator`` in ``init_params``'s order: normal dense
    weights ~ N(0, 1/fan_in), zero norms and biases."""
    dev = torch.device(device)
    lead = tuple(lead)
    d, H, KV, D = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # the dense MLPs of a model with MoE layers are dense_d_ff wide
    ff = cfg.dense_d_ff if (cfg.moe and cfg.dense_d_ff) else cfg.d_ff

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
        p["rglru"] = rglru_lib.init_rglru_params(cfg, generator, dev, lead)
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


def init_head(cfg, generator: torch.Generator, device) -> Dict:
    """The embedding, final norm and (untied) head, drawn from
    ``generator`` in ``init_params``'s order."""
    dev = torch.device(device)
    d = cfg.d_model
    books = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    params = {"embed": torch.randn(books + (cfg.vocab_padded, d),
                                   generator=generator, device=dev),
              "final_norm": torch.zeros(d, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(books + (d, cfg.vocab_padded),
                                        generator=generator,
                                        device=dev) / math.sqrt(d)
    return params


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

    def block(kind, is_moe, lead):
        return init_block(cfg, kind, is_moe, generator, dev, lead)

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
    params.update(init_head(cfg, generator, dev))
    return params


def abstract_params(cfg) -> Dict:
    """The params tree with every leaf a ``meta`` tensor of its shape and
    dtype: the port's counterpart of the reference's ``jax.eval_shape``
    of ``init_params`` (no memory, no values)."""
    return init_params(cfg, torch.Generator(), "meta")


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


# --------------------------------------------------------- block pieces
def attn_project(p, x, kind, positions, cfg):
    """q (B,S,H,D), k, v (B,S,KV,D) bf16 of an attention layer: the
    projections, then qk-norm and RoPE (at ``positions`` (B,S)) where the
    config has them. Shared by prefill, decode and training."""
    q, k, v = layers.attn_qkv(p, x, cfg)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_embed == "rope":
        theta = _rope_theta_for(cfg, kind)
        q = layers.rope(q, positions, theta)
        k = layers.rope(k, positions, theta)
    return q, k, v


def attend(q, k, v, kind, cfg, impl: Optional[str] = None):
    """Prefill-form attention of a layer of ``kind`` (B,S,H,D) bf16."""
    if kind == "local":
        return layers.local_attention(q, k, v, cfg, impl)
    if kind == "chunked":
        return layers.chunked_attention(q, k, v, cfg, impl)
    return layers.full_causal_attention(q, k, v, cfg, impl)


def residual(x, y, p, post: str, cfg):
    """x + y, y first through gemma2's post-norm when the config has one."""
    if cfg.use_post_norm:
        y = rms_norm(y, p[post], cfg.norm_eps)
    return x + y


def cross_residual(p, x, kind, cond, cfg):
    """An attention layer's cross-attention residual when the config has
    one (musicgen): x + cross_attention(rms_norm(x), cond); else x."""
    if not cfg.cross_attn_cond or kind not in ATTN_KINDS:
        return x
    if cond is None:
        raise ValueError(
            f"{cfg.name} cross-attends to a conditioning sequence: pass "
            f"cond, (B, {cfg.cross_attn_cond}, {cfg.d_model}) embeddings "
            "(models.frontend.synth_cond_embeds makes random ones)")
    h = rms_norm(x, p["pre_norm_cross"], cfg.norm_eps)
    return x + layers.cross_attention(p["cross_attn"], h, cond, cfg)


def mlp_residual(p, x, cfg, plan=None, impl: Optional[str] = None):
    """The layer's MLP after its pre-norm, and its aux loss (fp32; None
    for a dense MLP): an MoE layer is one whose params hold ``moe``
    (``init_params`` puts it on the slots ``cfg.is_moe_layer`` names),
    which takes ``moe.moe_layer`` (over the plan's ep expert shards); a
    dense one ``layers.mlp``."""
    h = rms_norm(x, p["pre_norm_mlp"], cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_lib.moe_layer(p["moe"], h, cfg,
                                   ep=plan_lib.mesh_degrees(plan)[1])
    else:
        y, aux = layers.mlp(p["mlp"], h, cfg, plan, impl=impl), None
    return residual(x, y, p, "post_norm_mlp", cfg), aux


def embed_inputs(params, tokens, cfg, patch_embeds=None):
    """The first residual stream (B,S,d) bf16 and its positions (B,S): the
    tokens' embedding after a vision config's patches, plus the
    sinusoidal table where the config has one."""
    x = embed_tokens(params, tokens, cfg)
    if cfg.frontend == "vision" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(COMPUTE_DTYPE), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if cfg.pos_embed == "sinusoidal":
        x = x + layers.sinusoidal_pos(positions, cfg.d_model).to(
            COMPUTE_DTYPE)
    return x, positions


# ------------------------------------------------------------ training
def apply_block(p, x, cond, kind, is_moe, cfg, positions, *, plan=None,
                impl: Optional[str] = None):
    """One decoder block in the training / prefill form. x (B,S,d) ->
    (x, the MoE aux loss fp32, or None without one). ``is_moe`` is the reference's argument; the port reads
    the layer's kind of MLP from its params (``mlp_residual``)."""
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    if kind == "ssm":
        y = ssm_lib.ssm_block(p["ssm"], h, cfg)
    elif kind == "rglru":
        y = rglru_lib.rglru_block(p["rglru"], h, cfg)
    else:
        q, k, v = attn_project(p["attn"], h, kind, positions, cfg)
        y = layers.attn_out(p["attn"], attend(q, k, v, kind, cfg, impl))
    x = cross_residual(p, residual(x, y, p, "post_norm", cfg), kind, cond,
                       cfg)
    if kind == "ssm":
        return x, None
    return mlp_residual(p, x, cfg, plan, impl)


def _saved_ops(batched: bool):
    """The ops whose outputs a "dots" remat keeps: the matrix products
    (``aten.mm``, and with batch dimensions ``aten.bmm``), the reference's
    ``checkpoint_dots`` / ``checkpoint_dots_with_no_batch_dims``."""
    ops = {torch.ops.aten.mm, torch.ops.aten.addmm}
    if batched:
        ops.add(torch.ops.aten.bmm)
    return ops


def _remat(fn, policy: str):
    """``fn`` under the remat policy: recomputed in the backward in full
    ("full"), or all but its matrix products ("dots", "dots_no_batch")."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {policy!r}")
    saved = _saved_ops(policy == "dots")

    def decide(ctx, func, *args, **kwargs):
        return ckpt.CheckpointPolicy.MUST_SAVE \
            if func.overloadpacket in saved \
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(
        ckpt.checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(
            ckpt.create_selective_checkpoint_contexts, decide))


def forward(params, tokens, cfg, *, patch_embeds=None, cond=None,
            remat_policy: str = "none", hints=None, plan=None,
            impl: Optional[str] = None):
    """Training / prefill forward. Returns (final hidden states (B,S,d)
    bf16, the MoE aux losses summed, fp32). ``remat_policy`` recomputes
    each pattern period in the backward: "full" everything
    (``torch.utils.checkpoint``), "dots" / "dots_no_batch" all but the
    matrix products (a selective-checkpoint policy), the reference's
    ``jax.checkpoint`` policies. ``hints`` (``sharding.autoshard.
    ShardingHints``) are the active hints of every layer, a period's
    recomputation included: attention then runs sequence-sharded where
    the reference's does (``layers.seq_shards``); the activation
    constraints are applied where the reference applies them and, in one
    process, return their input."""
    x, positions = embed_inputs(params, tokens, cfg, patch_embeds)
    if hints is not None:
        x = hints.constrain_act(x)
    kinds = slot_kinds(cfg)

    def period_fn(x, i):
        with layers.hints_context(hints):       # its recomputation too
            aux = torch.zeros((), device=x.device)
            for j, (kind, is_moe) in enumerate(kinds):
                x, a = apply_block(layer(params["blocks"][f"slot{j}"], i), x,
                                   cond, kind, is_moe, cfg, positions,
                                   plan=plan, impl=impl)
                if hints is not None:
                    x = hints.constrain_act(x)
                if a is not None:
                    aux = aux + a
            return x, aux

    period = _remat(period_fn, remat_policy)
    aux_total = torch.zeros((), device=x.device)
    if "blocks" in params:
        auxs = []
        for i in range(num_scan_periods(cfg)):
            x, a = period(x, i)
            auxs.append(a)
        aux_total = aux_total + torch.stack(auxs).sum()
    with layers.hints_context(hints):
        for j, (kind, is_moe) in enumerate(kinds[:num_remainder(cfg)]):
            x, a = apply_block(params["rem"][f"rem{j}"], x, cond, kind,
                               is_moe, cfg, positions, plan=plan, impl=impl)
            if a is not None:
                aux_total = aux_total + a
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total


def _xent_chunk(params, x_chunk, labels_chunk, cfg, hints=None):
    """Summed nll, z-loss (lse squared), valid count and correct argmax
    count of one chunk of positions; labels < 0 are ignored."""
    logits = lm_logits(params, x_chunk, cfg)                  # fp32
    if hints is not None:
        logits = hints.constrain_logits(logits)
    lse = torch.logsumexp(logits, dim=-1)
    lbl = labels_chunk.transpose(1, 2) if cfg.num_codebooks > 1 \
        else labels_chunk                                     # (B,c[,K])
    valid = lbl >= 0
    lbl_safe = lbl.clamp_min(0).long()
    picked = torch.gather(logits, -1, lbl_safe[..., None])[..., 0]
    zero = torch.zeros((), device=logits.device)
    nll = torch.where(valid, lse - picked, zero)
    zloss = torch.where(valid, torch.square(lse), zero)
    hit = valid & (torch.argmax(logits, dim=-1) == lbl)
    return nll.sum(), zloss.sum(), valid.sum(), hit.sum()


def loss_from_hidden(params, x, labels, cfg, hints=None):
    """Chunked softmax cross-entropy over the vocabulary, never holding
    the whole (B,S,V) logits: ``LOSS_CHUNK`` positions at a time (halved
    until they divide S), each chunk recomputed in the backward so that
    its logits are not kept for it. Returns (mean nll, mean z-loss,
    accuracy) over the valid labels, fp32."""
    B, S = x.shape[:2]
    c = min(LOSS_CHUNK, S)
    while S % c:
        c //= 2
    xent = functools.partial(ckpt.checkpoint, _xent_chunk, use_reentrant=False)
    zero = torch.zeros((), device=x.device)
    nll, zl, cnt, acc = zero, zero, zero, zero
    for i in range(S // c):
        n, z, k, a = xent(params, x[:, i * c:(i + 1) * c],
                          labels[..., i * c:(i + 1) * c], cfg, hints)
        nll, zl, cnt, acc = nll + n, zl + z, cnt + k, acc + a
    cnt = torch.clamp_min(cnt, 1.0)
    return nll / cnt, zl / cnt, acc / cnt


def loss_fn(params, batch, cfg, *, remat_policy: str = "none", hints=None,
            plan=None, impl: Optional[str] = None):
    """The full training loss. ``batch``: ``tokens`` and ``labels`` (and
    ``patch_embeds`` / ``cond`` for the frontend configs). Returns (total,
    metrics): total = nll + ``Z_LOSS_WEIGHT`` z-loss + ``MOE_AUX_WEIGHT``
    aux; the loss is taken on the text positions only. ``hints`` as for
    ``forward``."""
    x, aux = forward(params, batch["tokens"], cfg,
                     patch_embeds=batch.get("patch_embeds"),
                     cond=batch.get("cond"), remat_policy=remat_policy,
                     hints=hints, plan=plan, impl=impl)
    if cfg.frontend == "vision":
        x = x[:, cfg.num_patches:]
    loss, zloss, acc = loss_from_hidden(params, x, batch["labels"], cfg,
                                        hints)
    total = loss + Z_LOSS_WEIGHT * zloss + MOE_AUX_WEIGHT * aux
    return total, {"loss": loss, "z_loss": zloss, "moe_aux": aux,
                   "accuracy": acc}
