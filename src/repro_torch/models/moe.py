"""Mixture-of-experts layer with sort-based dispatch (counterpart of
``repro.models.moe``).

Top-k routing over ``num_experts`` gated MLPs, an optional shared expert
added to every token. Two paths, as in the reference:

* ``moe_layer_decode`` (S <= 8: every decode step and the shortest prefill
  tiers): every expert runs densely on every token and the gates combine
  the outputs through a one-hot (B, S, E) in fp32. It reads every expert
  each step and makes no host read, so a decode step still captures as one
  CUDA graph;
* ``moe_layer`` (S > 8): each batch row's (token, choice) pairs are sorted
  by expert (a stable sort, so within an expert tokens keep their position
  order) into a (E, C, d) buffer of ``expert_capacity`` slots; pairs past C
  are dropped (their slot zeroed and clamped to C - 1, as in the
  reference), the experts run on their buffers, and the outputs come back
  by an index-add of output x gate in the expert output's dtype (bf16).

Precision is the reference's: router logits and softmax in fp32, expert
products with bf16 operands and fp32 sums, the decode path's down
projection fp32 and the sort path's bf16. The expert products are plain
``torch`` matrix products, one expert at a time (the reference's are
``jnp.einsum``, outside any Pallas kernel). Under a plan with ep > 1 the
decode path runs the experts in ep contiguous slices
(``sharding.tensor_parallel.sharded_expert_mlp``, one slice at ep=1) and
combines the gathered outputs in the same expert order, so the result is
the one-device result bit for bit.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import COMPUTE_DTYPE


def init_moe_params(cfg, generator: torch.Generator, device, lead=()) -> dict:
    """Router (d, E), experts ``wg`` / ``wu`` (E, d, f) and ``wd`` (E, f, d)
    scaled by the fan-in of their axis 1, and a shared gated MLP when the
    config has one (``lead`` stacks them); the reference's shapes and init
    scales, not its values."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts

    def dense(shape, fan_in):
        return layers.dense_init(generator, tuple(lead) + shape, fan_in,
                                 device)

    p = {"router": dense((d, E), d), "wg": dense((E, d, f), d),
         "wu": dense((E, d, f), d), "wd": dense((E, f, d), f)}
    if cfg.shared_expert:
        p["shared"] = {"wg": dense((d, f), d), "wu": dense((d, f), d),
                       "wd": dense((f, d), f)}
    return p


def expert_capacity(tokens_per_row: int, cfg) -> int:
    """Slots per expert and row: ceil(S k capacity_factor / E), padded to a
    multiple of 8, at least 8."""
    c = math.ceil(tokens_per_row * cfg.experts_per_token *
                  cfg.capacity_factor / cfg.num_experts)
    return max(8, ((c + 7) // 8) * 8)


def _act(cfg):
    if cfg.mlp_act == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def _route(params, x, cfg):
    """fp32 router probabilities (B,S,E), the top-k experts (B,S,K) and
    their gates renormalised to sum to 1."""
    probs = torch.softmax(layers.matmul(x, params["router"]), dim=-1)
    gates, eids = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gates, eids


def _one_hot(eids, E: int):
    """(..., K) expert ids -> (..., K, E) fp32 one-hot, by comparison (no
    range check that reads the ids back to the host)."""
    return (eids[..., None] == torch.arange(E, device=eids.device)).float()


def gated_mlp(x, wg, wu, wd, act, down_dtype):
    """A gated MLP on x (..., d): fp32 gate and up products, bf16 hidden,
    the down projection in ``down_dtype``."""
    h = (act(layers.matmul(x, wg)) * layers.matmul(x, wu)).to(COMPUTE_DTYPE)
    return layers.matmul(h, wd, out_dtype=down_dtype)


def _expert(p, e: int, x, act, down_dtype):
    return gated_mlp(x, p["wg"][e], p["wu"][e], p["wd"][e], act, down_dtype)


def _shared(params, x, y, cfg):
    """y + the shared expert's output (bf16), when the config has one."""
    if not cfg.shared_expert:
        return y
    sp = params["shared"]
    return y + gated_mlp(x, sp["wg"], sp["wu"], sp["wd"], _act(cfg),
                      COMPUTE_DTYPE)


def moe_layer_decode(params, x, cfg,
                     ep: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) bf16 -> (y (B,S,d) bf16, zero aux loss): all experts on
    every token, combined by the gates in fp32, expert by expert. The
    experts run in ``ep`` shards (``ep`` dividing them) first."""
    from repro_torch.sharding import tensor_parallel

    E = cfg.num_experts
    _, gates, eids = _route(params, x, cfg)
    gates_full = (_one_hot(eids, E) * gates[..., None]).sum(dim=-2)
    outs = tensor_parallel.sharded_expert_mlp(
        x, params["wg"], params["wu"], params["wd"], act=_act(cfg), ep=ep)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        y = y + outs[e] * gates_full[..., e:e + 1]
    y = _shared(params, x, y.to(COMPUTE_DTYPE), cfg)
    return y, torch.zeros((), device=x.device)


def _dispatch(x, eids, E: int, C: int):
    """Every row's (token, choice) pairs sorted by expert into a (B,E,C,d)
    buffer. Returns the buffer and what the combine needs: the sort order
    and each sorted pair's row of the flattened buffer (its slot clamped),
    keep flag and token."""
    B, S, K = eids.shape
    T = S * K
    flat_e = eids.reshape(B, T)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, device=x.device).expand(B, E).contiguous())
    pos = torch.arange(T, device=x.device) - torch.gather(starts, 1, sorted_e)
    keep = pos < C
    pos_c = pos.clamp(0, C - 1)
    tok = torch.div(order, K, rounding_mode="floor")   # repeat(arange(S), K)
    xs = torch.gather(x, 1, tok[..., None].expand(B, T, x.shape[-1]))
    xs = torch.where(keep[..., None], xs, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    rows = torch.arange(B, device=x.device)[:, None]
    slot = ((rows * E + sorted_e) * C + pos_c).reshape(-1)
    buf = torch.zeros((B * E * C, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    buf.index_add_(0, slot, xs.reshape(B * T, -1))
    return buf.reshape(B, E, C, -1), (order, slot, keep, tok)


def _combine(expert_out, meta, gates, S: int):
    """Each kept pair's expert output x its gate (both in the output's
    dtype), index-added into its token's row."""
    order, slot, keep, tok = meta
    B, E, C, d = expert_out.shape
    vals = expert_out.reshape(B * E * C, d)[slot].reshape(B, -1, d)
    g = torch.gather(gates.reshape(B, -1), 1, order).to(vals.dtype)
    vals = torch.where(keep[..., None], vals, torch.zeros(
        (), dtype=vals.dtype, device=vals.device)) * g[..., None]
    rows = torch.arange(B, device=vals.device)[:, None]
    out = torch.zeros((B * S, d), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, (rows * S + tok).reshape(-1), vals.reshape(-1, d))
    return out.reshape(B, S, d)


def moe_layer(params, x, cfg,
              ep: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) bf16 -> (y (B,S,d) bf16, aux load-balance loss fp32 (the
    Switch / Mixtral form, unused by serving)). S <= 8 takes
    ``moe_layer_decode``, with the plan's ``ep``."""
    B, S, d = x.shape
    if S <= 8:
        return moe_layer_decode(params, x, cfg, ep)
    E = cfg.num_experts
    C = expert_capacity(S, cfg)
    probs, gates, eids = _route(params, x, cfg)
    me = probs.mean(dim=(0, 1))
    ce = (_one_hot(eids, E).sum(dim=2) > 0).float().mean(dim=(0, 1))
    aux = (me * ce).sum() * E
    buf, meta = _dispatch(x, eids, E, C)
    act = _act(cfg)
    out = torch.stack([_expert(params, e, buf[:, e], act, COMPUTE_DTYPE)
                       for e in range(E)], dim=1)           # (B,E,C,d)
    y = _combine(out, meta, gates, S)
    return _shared(params, x, y, cfg), aux
