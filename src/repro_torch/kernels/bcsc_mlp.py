"""Fused block-CSC MLP: ``act(x·Wg) [* (x·Wu)] · Wd`` in one launch.

Counterpart of ``repro.kernels.bcsc_mlp``. The three projections are packed
BCSC weights (see ``bcsc_matmul``) padded to a shared capacity; ``counts``
(3,) int32 = [n_g, n_u, n_d] holds each layer's real block count, and blocks
at or past it are pads that are skipped. The hidden is rounded to bf16
before the down-projection, as the reference's two-call path rounds it.

``bcsc_mlp_plain`` takes the dense product over the decoded weights;
``bcsc_mlp_cuda`` launches ``csrc/bcsc_mlp.cu`` (one cooperative launch,
the hidden kept in an L2-resident device workspace between its two phases).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bcsc_matmul import _check, _dense_weight
from repro_torch.kernels.epilogue import act_code, fused_epilogue


def bcsc_mlp_plain(x, gate, up, down, counts, *, d_ff: int, n_out: int,
                   activation: Optional[str] = None):
    """x (M, K) bf16; gate/up/down are (blocks, row_ids, col_ids) triples
    (``up`` None for an ungated MLP); counts (3,). Returns (M, n_out) fp32."""
    K = x.shape[1]
    n = [int(c) for c in counts.tolist()]

    def dense(pack, count, k_in, n_cols):
        blocks, rows, cols = pack
        return _dense_weight(blocks[:count], rows[:count], cols[:count],
                             k_in, n_cols)

    xf = x.float()
    h = fused_epilogue(xf @ dense(gate, n[0], K, d_ff), None, activation)
    if up is not None:
        h = h * (xf @ dense(up, n[1], K, d_ff))
    h = h.to(torch.bfloat16).float()
    return h @ dense(down, n[2], d_ff, n_out)


def bcsc_mlp_cuda(x, gate, up, down, counts, *, d_ff: int, n_out: int,
                  activation: Optional[str] = None):
    """The same function on the card. gate/up/down are (blocks, row_ids,
    col_ptr) triples; x (Mp, K) bf16 with Mp % 8 == 0."""
    _check("x", x, torch.bfloat16)
    _check("counts", counts, torch.int32)
    Mp, K = x.shape
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if Mp % 8 or K % 16 or d_ff % 16 or n_out % 16:
        raise ValueError(f"x {tuple(x.shape)}, d_ff {d_ff}, n_out {n_out}: "
                         "rows must divide by 8, widths by 16")
    packs = [gate, up, down]
    for name, pack, n_cols in (("gate", gate, d_ff), ("up", up, d_ff),
                               ("down", down, n_out)):
        if pack is None:
            continue
        blocks, rows, col_ptr = pack
        _check(f"{name} blocks", blocks, torch.bfloat16)
        _check(f"{name} row_ids", rows, torch.int32)
        _check(f"{name} col_ptr", col_ptr, torch.int32)
        if tuple(blocks.shape[1:]) != (16, 16) \
                or col_ptr.numel() != n_cols // 16 + 1:
            raise ValueError(f"{name}: 16 x 16 blocks and {n_cols // 16 + 1}"
                             " segment starts expected")
    ptrs = []
    for pack in packs:
        ptrs += [None] * 3 if pack is None else [t.data_ptr() for t in pack]
    hidden = torch.empty((Mp, d_ff), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((Mp, n_out), dtype=torch.float32, device=x.device)
    barrier = torch.zeros((1,), dtype=torch.int32, device=x.device)
    code = _build.library().repro_bcsc_mlp(
        x.data_ptr(), Mp, K, *ptrs, counts.data_ptr(), act_code(activation),
        d_ff, n_out, hidden.data_ptr(), out.data_ptr(), barrier.data_ptr(),
        _build.stream_of(x))
    _build.check(code, "bcsc_mlp")
    bcsc_mlp_cuda.launches += 1
    return out


bcsc_mlp_cuda.launches = 0
