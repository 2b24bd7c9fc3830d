"""BCSC-pack MLP weights so the serving path runs the sparse kernels.

Counterpart of ``repro.serve.sparse``. Each MLP projection is block-pruned
(optionally) and BCSC-encoded at load time, on the params' own device, into a
dict of plain tensors inside the params tree: ``blocks`` (bf16), ``row_ids``,
``col_ids``, ``nnzb`` (the real block count) and ``col_ptr`` (segment starts,
read by the CUDA kernels). Stacked layers share one padded capacity; pads are
zero blocks that repeat the last real (row, col), and ``_bcsc_counts`` (L, 3)
holds each layer's real counts for the fused MLP.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import dataflow
from repro_torch.core import sparsity as sp
from repro_torch.kernels import bcsc_matmul as _bcsc
from repro_torch.kernels.ops import is_packed

MLP_WEIGHTS = ("wg", "wu", "wd", "w1", "w2")


def pack_weight(w: torch.Tensor, bk: int, bn: int,
                store_dtype=None, chunk: int = dataflow.BCSC_CHUNK
                ) -> Dict[str, torch.Tensor]:
    """Encode one (K, N) weight, every block-column non-empty, the payload
    padded to a multiple of ``chunk`` blocks."""
    m = _bcsc.ensure_nonempty_cols(sp.bcsc_encode(w, bk, bn))
    blocks = m.blocks if store_dtype is None else m.blocks.to(store_dtype)
    packed = {"blocks": blocks, "row_ids": m.row_ids,
              "col_ids": _bcsc.expand_col_ptr(m.col_ptr),
              "nnzb": torch.tensor(blocks.shape[0], dtype=torch.int32,
                                   device=w.device),
              "col_ptr": m.col_ptr}
    return pad_packed(packed, -(-blocks.shape[0] // chunk) * chunk)


def pad_packed(packed: Dict[str, torch.Tensor], nnzb: int
               ) -> Dict[str, torch.Tensor]:
    """Pad a pack to ``nnzb`` payload blocks with zero blocks that repeat
    the last real (row, col) pair; ``nnzb`` keeps the real count. The pads
    sit at the end of the last column's segment, which ``col_ptr`` widens
    to cover them."""
    have = packed["blocks"].shape[0]
    if have == nnzb:
        return packed
    if have > nnzb:
        raise ValueError(f"cannot pad {have} blocks down to {nnzb}")
    pad = nnzb - have
    blocks = packed["blocks"]
    out = dict(packed)
    out["blocks"] = torch.cat([blocks, blocks.new_zeros(
        (pad,) + tuple(blocks.shape[1:]))])
    for k in ("row_ids", "col_ids"):
        out[k] = torch.cat([packed[k], packed[k][-1:].expand(pad)])
    if "col_ptr" in packed:
        out["col_ptr"] = packed["col_ptr"].clone()
        out["col_ptr"][-1] = nnzb
    return out


def _packable(w, bk: int, bn: int) -> bool:
    return (isinstance(w, torch.Tensor) and w.dim() >= 2
            and w.shape[-2] % bk == 0 and w.shape[-1] % bn == 0)


def sparsify_mlp_params(params, cfg, sparsity: float = 0.0,
                        block: Tuple[int, int] = (16, 16),
                        store_dtype=torch.bfloat16):
    """Block-prune (when ``sparsity`` > 0) and BCSC-pack every dense MLP
    weight in ``params``, on the weights' device. Weights whose block
    density is too high for skipping to pay stay dense (the 'dense' arm of
    ``dataflow.mlp_path``). Returns (new_params, stats) with the
    reference's stats keys."""
    bk, bn = block
    stats: Dict = {"packed": 0, "kept_blocks": 0, "total_blocks": 0,
                   "padded_blocks": 0, "left_dense": [], "weights": {}}

    def pruned(w):
        w = w.float()
        return sp.block_magnitude_prune(w, sparsity, bk, bn) \
            if sparsity > 0 else w

    def convert_mlp(mlp: Dict, stacked: bool) -> Dict:
        out = dict(mlp)
        for name in MLP_WEIGHTS:
            w = mlp.get(name)
            if w is None or not _packable(w, bk, bn):
                continue
            nb_layer = (w.shape[-2] // bk) * (w.shape[-1] // bn)
            layers = [w[i] for i in range(w.shape[0])] if stacked else [w]
            per_layer = [pack_weight(pruned(wl), bk, bn, store_dtype)
                         for wl in layers]
            real = [int(p["nnzb"]) for p in per_layer]
            density = sum(real) / max(nb_layer * len(per_layer), 1)
            route = dataflow.mlp_path(1, w.shape[-1], w.shape[-2],
                                      gated=cfg.mlp_gated, density=density)
            if route == "dense":
                stats["left_dense"].append(name)
                continue
            padded = max(int(p["blocks"].shape[0]) for p in per_layer)
            if stacked:
                per_layer = [pad_packed(p, padded) for p in per_layer]
                out[name] = {k: torch.stack([p[k] for p in per_layer])
                             for k in per_layer[0]}
            else:
                out[name] = per_layer[0]
            stats["packed"] += 1
            stats["kept_blocks"] += sum(real)
            stats["total_blocks"] += nb_layer * len(per_layer)
            stats["padded_blocks"] += padded * len(per_layer)
            wstat = stats["weights"].setdefault(
                name, {"real": [], "padded": [], "dense_blocks": nb_layer})
            wstat["real"] += real
            wstat["padded"] += [padded] * len(per_layer)
        order = ("wg", "wu", "wd") if "wg" in out else ("w1", "w2")
        if all(is_packed(out.get(n)) for n in order):
            first = out[order[0]]["nnzb"]
            cols = [first,
                    out[order[1]]["nnzb"] if len(order) == 3
                    else torch.zeros_like(first),
                    out[order[-1]]["nnzb"]]
            out["_bcsc_counts"] = torch.stack(
                [c.to(torch.int32) for c in cols], dim=-1)
        return out

    def walk(tree, stacked: bool):
        if not isinstance(tree, dict):
            return tree
        return {k: convert_mlp(v, stacked) if k == "mlp" and isinstance(v, dict)
                else walk(v, stacked) for k, v in tree.items()}

    new_params = dict(params)
    if "blocks" in params:
        new_params["blocks"] = walk(params["blocks"], stacked=True)
    if "rem" in params:
        new_params["rem"] = walk(params["rem"], stacked=False)
    if stats["total_blocks"]:
        stats["block_density"] = stats["kept_blocks"] / stats["total_blocks"]
    for wstat in stats["weights"].values():
        wstat["packing_efficiency"] = (
            sum(wstat["real"]) / max(sum(wstat["padded"]), 1))
    if stats["padded_blocks"]:
        stats["packing_efficiency"] = (
            stats["kept_blocks"] / stats["padded_blocks"])
    return new_params, stats
