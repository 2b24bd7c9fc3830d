"""BCSC-pack MLP weights so the serving path runs the sparse kernels.

Counterpart of ``repro.serve.sparse``. Each MLP projection is block-pruned
(optionally) and BCSC-encoded at load time, on the params' own device, into a
dict of plain tensors inside the params tree: ``blocks`` (bf16), ``row_ids``,
``col_ids``, ``nnzb`` (the real block count) and ``col_ptr`` (segment starts,
read by the CUDA kernels). Stacked layers share one padded capacity; pads are
zero blocks that repeat the last real (row, col), and ``_bcsc_counts`` (L, 3)
holds each layer's real counts for the fused MLP.

``build_sparse_params`` gives the packed bf16 tree of a config's random
weights one layer at a time, so that a config whose fp32 tree is larger than
the card still loads on it (internvl2-26b: 79.4e9 B of fp32 against ~18e9 B
served).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dataflow
from repro_torch.core import plan as plan_lib
from repro_torch.core import sparsity as sp
from repro_torch.kernels import bcsc_matmul as _bcsc
from repro_torch.kernels.ops import is_packed
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import resolve_device

MLP_WEIGHTS = ("wg", "wu", "wd", "w1", "w2")


def packed_bytes(params) -> int:
    """Resident bytes of every BCSC-packed weight in a params tree: the
    payload blocks, ``row_ids``, ``col_ids``, ``nnzb`` and ``col_ptr``
    (0 for an unpacked tree). The reference's packs hold no ``col_ptr``, so
    this exceeds its count by exactly those segment starts."""
    if is_packed(params):
        return sum(v.numel() * v.element_size() for v in params.values())
    if isinstance(params, dict):
        return sum(packed_bytes(v) for v in params.values())
    return 0


def pack_weight(w: torch.Tensor, bk: int, bn: int,
                store_dtype=None, chunk: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Encode one (K, N) weight, every block-column non-empty, the payload
    padded to a multiple of ``chunk`` blocks (by default the active plan's
    ``bcsc_chunk``, else ``dataflow.BCSC_CHUNK``: ``core.plan.bcsc_chunk``,
    as the reference pads)."""
    chunk = plan_lib.bcsc_chunk() if chunk is None else chunk
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


def _pruned(w, sparsity: float, bk: int, bn: int):
    w = w.float()
    return sp.block_magnitude_prune(w, sparsity, bk, bn) \
        if sparsity > 0 else w


def _left_dense(cfg, shape, real, nb_layer: int) -> bool:
    """Whether a (..., K, N) weight's block density over its layers
    (``real`` blocks of ``nb_layer`` each) is too high for skipping to
    pay: the 'dense' arm of ``dataflow.mlp_path``."""
    density = sum(real) / max(nb_layer * len(real), 1)
    return dataflow.mlp_path(1, shape[-1], shape[-2], gated=cfg.mlp_gated,
                             density=density) == "dense"


def _new_stats() -> Dict:
    return {"packed": 0, "kept_blocks": 0, "total_blocks": 0,
            "padded_blocks": 0, "left_dense": [], "weights": {}}


def _count(stats, name: str, real, padded: int, nb_layer: int) -> None:
    """One packed weight of ``len(real)`` layers into ``stats``."""
    stats["packed"] += 1
    stats["kept_blocks"] += sum(real)
    stats["total_blocks"] += nb_layer * len(real)
    stats["padded_blocks"] += padded * len(real)
    wstat = stats["weights"].setdefault(
        name, {"real": [], "padded": [], "dense_blocks": nb_layer})
    wstat["real"] += real
    wstat["padded"] += [padded] * len(real)


def _finish_stats(stats) -> Dict:
    if stats["total_blocks"]:
        stats["block_density"] = stats["kept_blocks"] / stats["total_blocks"]
    for wstat in stats["weights"].values():
        wstat["packing_efficiency"] = (
            sum(wstat["real"]) / max(sum(wstat["padded"]), 1))
    if stats["padded_blocks"]:
        stats["packing_efficiency"] = (
            stats["kept_blocks"] / stats["padded_blocks"])
    return stats


def _add_counts(out: Dict) -> Dict:
    """``_bcsc_counts`` (..., 3) int32, the fused MLP's real counts, when
    every weight of the MLP ``out`` is packed."""
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


def sparsify_mlp_params(params, cfg, sparsity: float = 0.0,
                        block: Tuple[int, int] = (16, 16),
                        store_dtype=torch.bfloat16):
    """Block-prune (when ``sparsity`` > 0) and BCSC-pack every dense MLP
    weight in ``params``, on the weights' device. Weights whose block
    density is too high for skipping to pay stay dense (the 'dense' arm of
    ``dataflow.mlp_path``). Returns (new_params, stats) with the
    reference's stats keys."""
    bk, bn = block
    stats = _new_stats()

    def convert_mlp(mlp: Dict, stacked: bool) -> Dict:
        out = dict(mlp)
        for name in MLP_WEIGHTS:
            w = mlp.get(name)
            if w is None or not _packable(w, bk, bn):
                continue
            nb_layer = (w.shape[-2] // bk) * (w.shape[-1] // bn)
            layers = [w[i] for i in range(w.shape[0])] if stacked else [w]
            per_layer = [pack_weight(_pruned(wl, sparsity, bk, bn), bk, bn,
                                     store_dtype) for wl in layers]
            real = [int(p["nnzb"]) for p in per_layer]
            if _left_dense(cfg, w.shape, real, nb_layer):
                stats["left_dense"].append(name)
                continue
            padded = max(int(p["blocks"].shape[0]) for p in per_layer)
            if stacked:
                per_layer = [pad_packed(p, padded) for p in per_layer]
                out[name] = {k: torch.stack([p[k] for p in per_layer])
                             for k in per_layer[0]}
            else:
                out[name] = per_layer[0]
            _count(stats, name, real, padded, nb_layer)
        return _add_counts(out)

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
    return new_params, _finish_stats(stats)


# ------------------------------------------------- the layer-at-a-time build
def draw_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of draw ``index`` from ``seed``: layer ``index`` in
    depth order, or the embedding and head at ``index`` = num_layers.
    Seeded from ``numpy.random.SeedSequence([seed, index])``."""
    state = np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def layer_slots(cfg):
    """(part, slot name, period index or None, kind, is_moe) of every
    layer in depth order: the stacked periods' slots, then the remainder
    layers (``transformer.layers_in_order``'s order)."""
    kinds = tfm.slot_kinds(cfg)
    for i in range(tfm.num_scan_periods(cfg)):
        for j, (kind, is_moe) in enumerate(kinds):
            yield "blocks", f"slot{j}", i, kind, is_moe
    for j, (kind, is_moe) in enumerate(kinds[:tfm.num_remainder(cfg)]):
        yield "rem", f"rem{j}", None, kind, is_moe


def draw_layer(cfg, seed: int, index: int, device) -> Dict:
    """The fp32 parameters of layer ``index`` (depth order), unstacked,
    from its own generator (``draw_generator``)."""
    _, _, _, kind, is_moe = list(layer_slots(cfg))[index]
    return tfm.init_block(cfg, kind, is_moe,
                          draw_generator(seed, index, device), device)


def _put(dst: Dict, src: Dict, i: int, n: int) -> None:
    """Write the tree ``src`` at index ``i`` of ``dst``'s stacked leaves,
    allocating each as (n, ...) of ``src``'s leaf on first sight."""
    for k, v in src.items():
        if isinstance(v, dict):
            _put(dst.setdefault(k, {}), v, i, n)
        else:
            if k not in dst:
                dst[k] = v.new_empty((n,) + tuple(v.shape))
            dst[k][i] = v


def draw_params(cfg, seed: int, device) -> Dict:
    """The fp32 params tree of the per-layer draws (``draw_layer``; the
    embedding and head from draw ``cfg.num_layers``), stacked as
    ``transformer.init_params`` stacks its layers. ``build_sparse_params``
    builds ``compute_copy(sparsify_mlp_params(draw_params(...)))`` without
    ever holding this tree."""
    periods = tfm.num_scan_periods(cfg)
    params: Dict = {}
    for index, (part, name, i, _, _) in enumerate(layer_slots(cfg)):
        p = draw_layer(cfg, seed, index, device)
        if part == "blocks":
            _put(params.setdefault("blocks", {}).setdefault(name, {}), p, i,
                 periods)
        else:
            params.setdefault("rem", {})[name] = p
    params.update(tfm.init_head(
        cfg, draw_generator(seed, cfg.num_layers, device), device))
    return params


def build_sparse_params(cfg, seed: int, sparsity: float = 0.0,
                        block: Tuple[int, int] = (16, 16),
                        store_dtype=torch.bfloat16, device=None):
    """``compute_copy(sparsify_mlp_params(draw_params(cfg, seed, device),
    cfg, sparsity, block, store_dtype))``, bit for bit and leaf for leaf,
    built one layer at a time on ``device`` (the card unless the caller
    names another; ``engine.resolve_device``): only one layer's fp32 values
    are alive at once (a published config's whole fp32 tree may not fit
    the card that serves its packed bf16 tree). A stacked pack is padded
    to its largest layer's size, so a first pass draws and packs every
    layer to count its blocks, and a second draws each again from the same
    generator and writes its packs and bf16 matrices into the stacked
    tree. Returns (params, stats), the stats ``sparsify_mlp_params``
    gives."""
    bk, bn = block
    dev = resolve_device(device)
    slots = list(layer_slots(cfg))
    periods = tfm.num_scan_periods(cfg)

    def mlp_weights(p):
        mlp = p.get("mlp")
        for name in MLP_WEIGHTS if isinstance(mlp, dict) else ():
            w = mlp.get(name)
            if w is not None and _packable(w, bk, bn):
                yield mlp, name, w

    # pass 1: every packable MLP weight's real and chunk-padded block
    # counts, layer by layer (keys first seen in sparsify_mlp_params' walk
    # order: the periods' slots, then the remainder layers)
    real: Dict = {}
    sizes: Dict = {}
    shapes: Dict = {}
    for index, (part, slot, _, _, _) in enumerate(slots):
        p = draw_layer(cfg, seed, index, dev)
        for _, name, w in mlp_weights(p):
            pk = pack_weight(_pruned(w, sparsity, bk, bn), bk, bn,
                             store_dtype)
            key = (part, slot, name)
            real.setdefault(key, []).append(int(pk["nnzb"]))
            sizes.setdefault(key, []).append(int(pk["blocks"].shape[0]))
            shapes[key] = w.shape
            del pk
        del p
    stats = _new_stats()
    dense = set()
    for key, r in real.items():
        K, N = shapes[key]
        nb_layer = (K // bk) * (N // bn)
        if _left_dense(cfg, shapes[key], r, nb_layer):
            dense.add(key)
            stats["left_dense"].append(key[2])
        else:
            _count(stats, key[2], r, max(sizes[key]), nb_layer)

    # pass 2: the embedding and head, then each layer drawn again, packed,
    # padded, cast and written into the stacked tree
    head = tfm.compute_copy(tfm.init_head(
        cfg, draw_generator(seed, cfg.num_layers, dev), dev))
    params: Dict = {}
    for index, (part, slot, i, _, _) in enumerate(slots):
        p = draw_layer(cfg, seed, index, dev)
        for mlp, name, w in mlp_weights(p):
            if (part, slot, name) not in dense:
                mlp[name] = pad_packed(
                    pack_weight(_pruned(w, sparsity, bk, bn), bk, bn,
                                store_dtype),
                    max(sizes[(part, slot, name)]))
        p = tfm.compute_copy(p)
        if "mlp" in p:
            p["mlp"] = _add_counts(p["mlp"])
        if part == "blocks":
            _put(params.setdefault("blocks", {}).setdefault(slot, {}), p, i,
                 periods)
        else:
            params.setdefault("rem", {})[slot] = p
        del p
    params.update(head)
    return params, _finish_stats(stats)
