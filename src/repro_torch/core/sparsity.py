"""Compressed-sparse-column formats and pruning (paper §IV, Fig. 16,
Table III); the port's counterpart of ``repro.core.sparsity``.

Two granularities:

* ``csc_encode`` / ``csc_decode``: the paper's scalar CSC, per column a
  *count* (the zeros since the previous non-zero, in ``count_bits`` bits)
  and a data vector, plus an *address* vector of per-column segment starts.
  A run of zeros longer than the count can hold is cut by an explicit zero
  entry. Host-side numpy, for format round trips and compression ratios.
* ``bcsc_encode``: block-CSC, what the kernels consume. A (K, N) matrix is
  tiled into (bk, bn) blocks; all-zero blocks are skipped, non-zero blocks
  are stored dense in column-major order, with ``row_ids`` (the block-row of
  each payload block) and ``col_ptr`` (each block-column's segment start,
  the CSC address vector). Encoding is vectorised with torch ops so that
  packing a full-width model (about 9.5 M blocks) runs on the weights' own
  device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


# ------------------------------------------------------------------ scalar CSC
@dataclasses.dataclass
class CSCMatrix:
    """The paper's CSC of a (rows × cols) matrix, column-major segments."""
    data: np.ndarray      # non-zero values (and explicit zeros)
    count: np.ndarray     # zeros before each value, within its column
    address: np.ndarray   # per-column start offsets, len cols+1
    shape: Tuple[int, int]
    count_bits: int = 4

    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def storage_bits(self, data_bits: int = 8, addr_bits: int = 16) -> int:
        return (self.nnz * (data_bits + self.count_bits) +
                self.address.size * addr_bits)

    def compression_ratio(self, data_bits: int = 8) -> float:
        dense_bits = self.shape[0] * self.shape[1] * data_bits
        return dense_bits / max(self.storage_bits(data_bits), 1)


def csc_encode(mat: np.ndarray, count_bits: int = 4) -> CSCMatrix:
    """Encode column by column. A run of zeros longer than a count holds
    emits an explicit zero entry, as run-length coding does."""
    rows, cols = mat.shape
    max_count = (1 << count_bits) - 1
    data, count, address = [], [], [0]
    for c in range(cols):
        run = 0
        for r in range(rows):
            v = mat[r, c]
            if v == 0:
                run += 1
                if run > max_count:          # overflow: explicit zero
                    data.append(0)
                    count.append(max_count)
                    run = 0
            else:
                data.append(v)
                count.append(run)
                run = 0
        address.append(len(data))
    return CSCMatrix(np.asarray(data), np.asarray(count, np.int32),
                     np.asarray(address, np.int64), (rows, cols), count_bits)


def csc_decode(m: CSCMatrix) -> np.ndarray:
    rows, cols = m.shape
    out = np.zeros((rows, cols), dtype=np.asarray(m.data).dtype)
    for c in range(cols):
        r = 0
        for i in range(m.address[c], m.address[c + 1]):
            r += int(m.count[i])
            out[r, c] = m.data[i]
            r += 1
    return out


# ------------------------------------------------------------------- block CSC


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


# -------------------------------------------------------------------- pruning
def magnitude_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Zero the ``int(n·sparsity)`` smallest |w| entries and every entry
    tied with the largest of them."""
    flat = w.abs().reshape(-1)
    k = int(flat.numel() * sparsity)
    if k == 0:
        return w
    thresh = torch.sort(flat).values[k - 1]
    return torch.where(w.abs() > thresh, w, torch.zeros_like(w))


def prune_params(params, sparsity: float, min_size: int = 4096):
    """Magnitude-prune every weight of at least two axes and ``min_size``
    entries in a params tree, norms and the embedding excepted."""
    def walk(tree):
        out = {}
        for name, x in tree.items():
            if isinstance(x, dict):
                out[name] = walk(x)
            elif x.dim() >= 2 and x.numel() >= min_size \
                    and "norm" not in name.lower() and name != "embed":
                out[name] = magnitude_prune(x, sparsity)
            else:
                out[name] = x
        return out
    return walk(params)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


def sparsity_stats(params) -> Dict[str, float]:
    """Entries, non-zero entries and the zero share over a params tree."""
    total = nz = 0
    for x in _leaves(params):
        total += x.numel()
        nz += int(torch.count_nonzero(x))
    return {"total": float(total), "nonzero": float(nz),
            "sparsity": 1.0 - nz / max(total, 1)}
