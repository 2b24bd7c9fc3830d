"""Block-CSC sparse-weight format and block pruning (paper §IV, Fig. 16).

The port's counterpart of the block half of ``repro.core.sparsity``. A (K, N)
matrix is tiled into (bk, bn) blocks; all-zero blocks are skipped, non-zero
blocks are stored dense in column-major order, with ``row_ids`` (the block-row
of each payload block) and ``col_ptr`` (each block-column's segment start, the
CSC address vector). Encoding is vectorised with torch ops so that packing a
full-width model (about 9.5 M blocks) runs on the weights' own device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class BCSCMatrix:
    """blocks (nnzb, bk, bn); row_ids (nnzb,) int32; col_ptr (nbn+1,) int32."""
    blocks: torch.Tensor
    row_ids: torch.Tensor
    col_ptr: torch.Tensor
    shape: Tuple[int, int]
    block: Tuple[int, int]

    @property
    def nnzb(self) -> int:
        return int(self.blocks.shape[0])


def _tiles(mat: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """(K, N) -> (nbn, nbk, bk, bn): block (r, c) at [c, r]."""
    K, N = mat.shape
    if K % bk or N % bn:
        raise ValueError(f"{(K, N)} does not tile by {(bk, bn)}")
    return mat.reshape(K // bk, bk, N // bn, bn).permute(2, 0, 1, 3)


def bcsc_encode(mat: torch.Tensor, bk: int, bn: int) -> BCSCMatrix:
    """Encode ``mat`` column-major, skipping all-zero blocks (an all-zero
    matrix keeps one zero block)."""
    K, N = mat.shape
    tiles = _tiles(mat, bk, bn)
    keep = tiles.abs().sum(dim=(2, 3)) > 0                   # (nbn, nbk)
    if not bool(keep.any()):
        keep[0, 0] = True
    cols, rows = torch.nonzero(keep, as_tuple=True)          # column-major
    col_ptr = torch.zeros(N // bn + 1, dtype=torch.int32, device=mat.device)
    col_ptr[1:] = torch.cumsum(keep.sum(dim=1), 0).to(torch.int32)
    return BCSCMatrix(tiles[cols, rows].contiguous(), rows.to(torch.int32),
                      col_ptr, (K, N), (bk, bn))


def bcsc_decode(m: BCSCMatrix) -> torch.Tensor:
    """Dense (K, N) matrix of a BCSC encoding."""
    K, N = m.shape
    bk, bn = m.block
    counts = (m.col_ptr[1:] - m.col_ptr[:-1]).long()
    cols = torch.repeat_interleave(
        torch.arange(N // bn, device=counts.device), counts)
    tiles = torch.zeros(N // bn, K // bk, bk, bn, dtype=m.blocks.dtype,
                        device=m.blocks.device)
    tiles[cols, m.row_ids.long()] = m.blocks
    return tiles.permute(1, 2, 0, 3).reshape(K, N)


def col_ptr_from_ids(col_ids: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Segment starts (n_cols+1,) int32 of a non-decreasing ``col_ids``."""
    edges = torch.arange(n_cols + 1, dtype=col_ids.dtype,
                         device=col_ids.device)
    return torch.searchsorted(col_ids.contiguous(), edges).to(torch.int32)


def block_magnitude_prune(w: torch.Tensor, sparsity: float, bk: int,
                          bn: int) -> torch.Tensor:
    """Zero whole (bk, bn) blocks by L2 norm: the ``int(n·sparsity)``
    smallest-norm blocks and every block tied with the largest of them."""
    K, N = w.shape
    tiles = w.reshape(K // bk, bk, N // bn, bn)
    norms = torch.sqrt(torch.sum(torch.square(tiles.float()), dim=(1, 3)))
    k = int(norms.numel() * sparsity)
    if k == 0:
        return w
    thresh = torch.sort(norms.reshape(-1)).values[k - 1]
    mask = (norms > thresh)[:, None, :, None]
    return (tiles * mask).reshape(K, N)
