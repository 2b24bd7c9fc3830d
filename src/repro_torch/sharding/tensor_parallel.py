"""Tensor- and expert-parallel decode math, shard by shard.

The port's copy of ``repro.sharding.tensor_parallel``. A sharded step is
one program that loops over the mesh's shards, each computing exactly what
one device of the mesh would compute from its local slice: the
paged-attention kernel reads only the shard's KV heads of the pool, the
expert products only the shard's experts. The all-gather is a
concatenation in shard order, which is exact (no sum crosses shards), so a
sharded step equals the one-device step bit for bit:

* per-KV-head locality (tp): both attention paths treat the KV-head axis as
  a batch axis (scores reduce over D per head, the softmax normalizes per
  (KV head, query head) and q is laid out as contiguous (KV, H / KV)
  groups), so heads computed in tp contiguous chunks and concatenated
  equal heads computed at once; the output projection runs on the gathered
  contexts unchanged. On the card each shard is one launch of the paged
  kernel over the unsliced pool (``kv_offset``), which splits each row's
  pages as the one-device launch does;
* expert-as-batch (ep): the decode MoE runs each expert on every token, so
  per-shard expert slices gathered in shard order equal all experts at
  once, and the gate-weighted combine runs on the gathered outputs.

All shards run on the tensors' device, one after another, as the
reference's shard-explicit program does on one host.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch.kernels import ops


def shard_slice(x: torch.Tensor, axis: int, shard: int, n: int):
    """The ``shard``-of-``n`` contiguous slice of ``x`` along ``axis`` (a
    view; ``x.shape[axis]`` must divide by ``n``)."""
    size = x.shape[axis]
    if size % n:
        raise ValueError(f"axis {axis} of size {size} does not split into "
                         f"{n} shards")
    per = size // n
    return x.narrow(axis, shard * per, per)


def all_gather(parts: List[torch.Tensor], axis: int) -> torch.Tensor:
    """The activation all-gather as a concatenation in shard order: exact,
    which is the whole bit-identity argument."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=axis)


def sharded_paged_attention(q, pk, pv, block_table, lengths, tp: int, *,
                            softcap: float = 0.0, k_scale=None, v_scale=None,
                            split_rows: Optional[int] = None,
                            impl: Optional[str] = None):
    """Paged decode attention over tp KV-head shards, contexts gathered.

    q (B,1,H,D); pk/pv (P, page_size, KV, D); scales (P, KV). Shard s runs
    the paged kernel (``ops.paged_attention``) on its query-head group and
    pool heads ``[s KV/tp, (s + 1) KV/tp)`` of the unsliced pools (split as
    for all KV heads); the contexts are concatenated along the head axis.
    ``split_rows`` and ``impl`` pass through; tp=1 is one shard."""
    kw = dict(softcap=softcap, k_scale=k_scale, v_scale=v_scale,
              split_rows=split_rows, impl=impl)
    KV = pk.shape[2]
    per = KV // tp
    parts = [ops.paged_attention(shard_slice(q, 2, s, tp), pk, pv,
                                 block_table, lengths, kv_offset=s * per,
                                 kv_heads=per, **kw)
             for s in range(tp)]
    return all_gather(parts, axis=2)


def sharded_decode_attention(q, k_cache, v_cache, valid_mask, cfg, tp: int):
    """Contiguous-cache decode attention (``layers.decode_attention``: the
    rings of local and chunked layers, the drain engine's dense slots) over
    tp KV-head shards, so a tp plan shards every attention kind. q
    (B,1,H,D); k/v_cache (B,T,KV,D); valid_mask (B,T)."""
    from repro_torch.models import layers

    parts = [layers.decode_attention(
        shard_slice(q, 2, s, tp), shard_slice(k_cache, 2, s, tp),
        shard_slice(v_cache, 2, s, tp), valid_mask, cfg) for s in range(tp)]
    return all_gather(parts, axis=2)


def sharded_expert_mlp(x, wg, wu, wd, *, act: Callable,
                       ep: int) -> List[torch.Tensor]:
    """The decode MoE's all-experts MLP over ep expert shards (ep=1 is one
    shard).

    x (B,S,d) bf16; wg/wu (E,d,f); wd (E,f,d). Shard s runs the experts of
    its contiguous E/ep slice (the weights an ep device holds), each as
    ``moe.gated_mlp`` runs it; the outputs are gathered in shard order.
    Returns the E experts' (B,S,d) fp32 outputs (the decode path's down
    projection), for the caller's gate-weighted combine."""
    from repro_torch.models import moe

    E = wg.shape[0]
    if E % ep:
        raise ValueError(f"ep={ep} must divide the {E} experts")
    outs = []
    for s in range(ep):
        g, u, d = (shard_slice(w, 0, s, ep) for w in (wg, wu, wd))
        outs.extend(moe.gated_mlp(x, g[e], u[e], d[e], act, torch.float32)
                    for e in range(E // ep))
    return outs
