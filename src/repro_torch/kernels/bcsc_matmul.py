"""Block-CSC sparse matmuls: the GEMM (prefill) and GEMV (decode) arms.

Counterpart of ``repro.kernels.bcsc_matmul``. A packed weight is the BCSC
encoding of a (K, N) matrix in 16 x 16 blocks: ``blocks (nnzb, bk, bn)``,
``row_ids (nnzb,)`` and non-decreasing ``col_ids (nnzb,)``; pads at the end
repeat the last (row, col) with a zero payload. The kernels walk each output
block-column's segment, whose bounds ``col_ptr`` come from ``col_ids``.

The plain versions decode the weight to dense and take one fp32-accumulated
product; the CUDA wrappers launch ``csrc/bcsc_matmul.cu``. The GEMM's thread
block owns a tile of ``bm`` rows by ``GEMM_GROUP`` block-columns and walks
the k-tiles (``GEMM_TILE_ROWS`` block-rows, 128 columns of x) in which its
columns hold blocks; ``gemm_plan`` picks ``bm`` and how many ways K is split
from shapes alone, never from the pack's contents (reading them on the host
would sync every prefill layer). The GEMV cuts each output block-column's
segment into ``gemv_plan``'s split parts, one a warp, each streamed through
a cp.async ring onto ``mma.sync`` with the 8 rows as the MMA's N; a
column's parts are the warps of one thread block, whose first warp adds
their partials in split order, then bias and activation.
``gemv_schedule_model`` computes the same schedule in plain torch for the
CPU tests.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import sparsity as sp
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import act_code, fused_epilogue


def expand_col_ptr(col_ptr: torch.Tensor) -> torch.Tensor:
    """CSC address vector -> per-block column ids, int32."""
    counts = (col_ptr[1:] - col_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(counts.numel(), dtype=torch.int32,
                     device=col_ptr.device), counts)


def ensure_nonempty_cols(m: sp.BCSCMatrix) -> sp.BCSCMatrix:
    """Insert one explicit zero block (block-row 0) into every empty
    block-column, the paper's repeated-address convention, so that every
    output tile is visited at least once."""
    counts = (m.col_ptr[1:] - m.col_ptr[:-1]).long()
    if bool((counts > 0).all()):
        return m
    new_counts = counts.clamp_min(1)
    new_ptr = torch.zeros_like(m.col_ptr)
    new_ptr[1:] = torch.cumsum(new_counts, 0).to(m.col_ptr.dtype)
    cols = expand_col_ptr(m.col_ptr).long()
    # old block i of column c moves to new_ptr[c] + (i - col_ptr[c])
    dst = new_ptr[cols].long() + torch.arange(
        cols.numel(), device=cols.device) - m.col_ptr[cols].long()
    n = int(new_ptr[-1])
    blocks = m.blocks.new_zeros((n,) + tuple(m.blocks.shape[1:]))
    row_ids = m.row_ids.new_zeros((n,))
    blocks[dst] = m.blocks
    row_ids[dst] = m.row_ids
    return sp.BCSCMatrix(blocks, row_ids, new_ptr, m.shape, m.block)


def _dense_weight(blocks, row_ids, col_ids, K: int, n_out: int):
    """Dense (K, n_out) of a (possibly padded) pack. Accumulating makes the
    zero-payload pads, which repeat the last real position, add nothing."""
    _, bk, bn = blocks.shape
    tiles = torch.zeros(n_out // bn, K // bk, bk, bn, dtype=torch.float32,
                        device=blocks.device)
    tiles.index_put_((col_ids.long(), row_ids.long()), blocks.float(),
                     accumulate=True)
    return tiles.permute(1, 2, 0, 3).reshape(K, n_out)


def bcsc_matmul_plain(x, blocks, row_ids, col_ids, *, n_out: int):
    """x (M, K) · BCSC(K, n_out) -> (M, n_out) fp32."""
    w = _dense_weight(blocks, row_ids, col_ids, x.shape[1], n_out)
    return x.float() @ w


def bcsc_gemv_plain(x, blocks, row_ids, col_ids, *, n_out: int, bias=None,
                    activation: Optional[str] = None):
    """The GEMV arm: the product, then the fused epilogue, fp32."""
    return fused_epilogue(
        bcsc_matmul_plain(x, blocks, row_ids, col_ids, n_out=n_out), bias,
        activation)


def _check(name, t, dtype):
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")


def _check_pack(x, blocks, row_ids, col_ptr, n_out):
    _check("x", x, torch.bfloat16)
    _check("blocks", blocks, torch.bfloat16)
    _check("row_ids", row_ids, torch.int32)
    _check("col_ptr", col_ptr, torch.int32)
    if tuple(blocks.shape[1:]) != (16, 16):
        raise ValueError(f"kernels take 16 x 16 blocks, got "
                         f"{tuple(blocks.shape[1:])}")
    if x.shape[1] % 16 or n_out % 16 or col_ptr.numel() != n_out // 16 + 1:
        raise ValueError(f"x {tuple(x.shape)}, n_out {n_out}, col_ptr "
                         f"{tuple(col_ptr.shape)} do not tile by 16")
    if x.data_ptr() % 32 or blocks.data_ptr() % 32:
        raise ValueError("x and blocks must be 32-byte aligned")


GEMM_GROUP = 16          # block-columns of a GEMM thread block (kGemmGroup)
GEMM_TILE_ROWS = 8       # block-rows of a k-tile, 128 columns of x
GEMM_CHUNK = 256         # block-rows the kernel indexes at a time (kGemmChunk)
MIN_SPLIT_ROWS = 32      # fewest block-rows a K split walks


def split_rows(K: int, split: int) -> int:
    """Block-rows each of ``split`` K splits walks: whole k-tiles."""
    rows = -(-(K // 16) // split)
    return -(-rows // GEMM_TILE_ROWS) * GEMM_TILE_ROWS


def gemm_plan(M: int, K: int, N: int, n_sm: int) -> tuple:
    """(bm, split) of the GEMM for x (M, K) and N output columns on a card
    of ``n_sm`` SMs. bm is 128 rows (64 at M <= 64). The grid has
    ceil(M / bm) x ceil(N / 16 / GEMM_GROUP) tiles, one thread block per SM
    each; K is split (in powers of two, each split at least MIN_SPLIT_ROWS
    block-rows) while the tiles times the splits still fit in one wave, so
    that few tiles (qwen2.5-3b's down projection at M 512 makes 32) still
    fill the card. Shapes only."""
    bm = 64 if M <= 64 else 128
    tiles = -(-M // bm) * -(-(N // 16) // GEMM_GROUP)
    split = 1
    while (2 * split * tiles <= n_sm
           and (K // 16) // (2 * split) >= MIN_SPLIT_ROWS):
        split *= 2
    return bm, split


def bcsc_matmul_cuda(x, blocks, row_ids, col_ptr, *, n_out: int):
    """GEMM arm on the card: x (M, K) bf16 with M % 16 == 0 -> fp32."""
    _check_pack(x, blocks, row_ids, col_ptr, n_out)
    M, K = x.shape
    if M % 16:
        raise ValueError(f"GEMM rows must be a multiple of 16, got {M}")
    bm, split = gemm_plan(M, K, n_out, _build.sm_count(x.device.index or 0))
    out = gemm_launch(x, blocks, row_ids, col_ptr, n_out, bm, split)
    bcsc_matmul_cuda.launches += 1
    return out


def gemm_launch(x, blocks, row_ids, col_ptr, n_out: int, bm: int,
                split: int):
    """One GEMM on a plan of the caller's choice (``bcsc_matmul_cuda`` takes
    ``gemm_plan``'s; the tests walk others). Arguments as checked there."""
    M, K = x.shape
    out = torch.empty((M, n_out), dtype=torch.float32, device=x.device)
    # partials of splits 1.. (split 0 writes out); summed in split order
    ws = torch.empty((split - 1) * M * n_out, dtype=torch.float32,
                     device=x.device) if split > 1 else None
    code = _build.library().repro_bcsc_gemm(
        x.data_ptr(), M, K, blocks.data_ptr(), row_ids.data_ptr(),
        col_ptr.data_ptr(), out.data_ptr(), _build.ptr(ws), n_out, bm, split,
        _build.stream_of(x))
    _build.check(code, "bcsc_matmul")
    return out


GEMV_ROWS = 8            # rows of x, the MMA's N (kGemvRows)
GEMV_MAX_SPLIT = 16      # parts of a block-column, at most (kGemvMaxWarps)
GEMV_WARPS_PER_SM = 16   # warps an SM the split aims to fill
GEMV_STAGES = 4          # ring slots a warp (kGemvStages)
GEMV_SLOT = 512 + GEMV_ROWS * 32   # a block and its x slice, bytes
MIN_PART_ROWS = 8        # block-rows of K a GEMV part covers at least


def gemv_plan(K: int, N: int, n_sm: int) -> dict:
    """The GEMV's launch for x (8, K) and N output columns on a card of
    ``n_sm`` SMs, from shapes alone: ``split``, the most parts a block-column
    is cut into that still give every part its own warp among
    GEMV_WARPS_PER_SM an SM, at most GEMV_MAX_SPLIT, each part at least
    MIN_PART_ROWS block-rows of K on average. One thread block a column,
    one warp a part."""
    n_cols = N // 16
    split = max(1, min(n_sm * GEMV_WARPS_PER_SM // n_cols,
                       (K // 16) // MIN_PART_ROWS, GEMV_MAX_SPLIT))
    return {"split": split, "tasks": n_cols * split,
            "warps": n_sm * GEMV_WARPS_PER_SM, "grid": n_cols,
            "threads": 32 * split, "stages": GEMV_STAGES,
            "smem_bytes": split * GEMV_STAGES * GEMV_SLOT}


def gemv_schedule_model(x, blocks, row_ids, col_ptr, *, n_out: int,
                        bias=None, activation: Optional[str] = None,
                        n_sm: int = 132):
    """The GEMV's schedule in plain torch, fp32: x (8, K). Part s of
    block-column c (its segment cut into ``split`` parts of equal block
    counts) goes to warp s of thread block c and sums its blocks'
    products; at split > 1 the column's partials are added in split order;
    then bias and the activation. Returns (out, trace): ``trace`` holds how
    often each payload block was read, the parts of each column in the
    order they were added, and the (thread block, warp) of each part."""
    split = gemv_plan(x.shape[1], n_out, n_sm)["split"]
    cp, rid = col_ptr.tolist(), row_ids.long()
    xf, bf = x.float(), blocks.float()
    reads = [0] * blocks.shape[0]
    order, warp = {}, {}
    out = torch.zeros(x.shape[0], n_out, device=x.device)
    for c in range(n_out // 16):
        lo, n = cp[c], cp[c + 1] - cp[c]
        total = None
        for s in range(split):              # split order
            a, b = lo + n * s // split, lo + n * (s + 1) // split
            warp[(c, s)] = (c, s)
            for i in range(a, b):
                reads[i] += 1
            # x's slice of each block-row times its block, summed
            xs = xf.reshape(x.shape[0], -1, 16)[:, rid[a:b]]
            part = torch.einsum("mbk,bkn->mn", xs, bf[a:b])
            total = part if total is None else total + part
            order.setdefault(c, []).append(s)
        out[:, 16 * c:16 * (c + 1)] = total
    return fused_epilogue(out, bias, activation), {
        "reads": reads, "order": order, "warp": warp, "split": split}


def bcsc_gemv_cuda(x, blocks, row_ids, col_ptr, *, n_out: int, bias=None,
                   activation: Optional[str] = None):
    """GEMV arm on the card: x (8, K) bf16 -> (8, n_out) fp32, bias
    (n_out,) fp32 and the activation fused into the flush."""
    _check_pack(x, blocks, row_ids, col_ptr, n_out)
    M, K = x.shape
    if M != GEMV_ROWS:
        raise ValueError(f"the GEMV kernel takes {GEMV_ROWS} rows, got {M}")
    if bias is not None:
        _check("bias", bias, torch.float32)
        if bias.numel() != n_out:
            raise ValueError(f"bias must have {n_out} entries")
    split = gemv_plan(K, n_out, _build.sm_count(x.device.index or 0))[
        "split"]
    out = torch.empty((M, n_out), dtype=torch.float32, device=x.device)
    code = _build.library().repro_bcsc_gemv(
        x.data_ptr(), K, blocks.data_ptr(), row_ids.data_ptr(),
        col_ptr.data_ptr(), _build.ptr(bias), act_code(activation),
        out.data_ptr(), n_out, split, _build.stream_of(x))
    _build.check(code, "bcsc_gemv")
    bcsc_gemv_cuda.launches += 1
    return out


bcsc_matmul_cuda.launches = 0
bcsc_gemv_cuda.launches = 0
