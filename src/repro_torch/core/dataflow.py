"""Dispatch rules the serving path reads (the port's copy of the rules in
``repro.core.dataflow``).

The constants are still the TPU-derived ones (VMEM budget, GEMV crossover,
page size), kept on purpose so that every route the port takes is the route
the reference takes on the same shapes. Re-deriving them for Hopper is a
later planning item (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

import dataclasses

VMEM_BYTES = 16 * 1024 * 1024      # the reference's per-core scratch budget
LANE = 128                         # a TPU vector register's lanes
SUBLANE = 8                        # and its sublanes


def _round_down(x: int, m: int) -> int:
    return max((x // m) * m, m) if x >= m else x


# ------------------------------------------------ weight-stationary tiling
# The reference's row-stationary GEMM tiling for the TPU: a (bk x bn)
# weight tile stationary in VMEM, (bm x bk) activation tiles streamed past
# it, sizes multiples of the TPU's (8 sublanes x 128 lanes) that fit the
# VMEM budget double-buffered. Copied for the paper's Table III
# (``spad_fit_report``); no Hopper kernel of the port is tiled by it.
@dataclasses.dataclass(frozen=True)
class MatmulTiling:
    bm: int      # activation rows per tile
    bk: int      # reduction tile
    bn: int      # output columns per tile (the stationary weight's)
    dtype_bytes: int = 2

    @property
    def vmem_bytes(self) -> int:
        """x tile + w tile + the fp32 accumulator tile (the psum SPad)."""
        return (self.bm * self.bk + self.bk * self.bn) * self.dtype_bytes + \
            self.bm * self.bn * 4

    def fits(self, budget: int = VMEM_BYTES) -> bool:
        """The streamed operands double-buffered beside the accumulator."""
        return (2 * self.bm * self.bk * self.dtype_bytes +
                2 * self.bk * self.bn * self.dtype_bytes +
                self.bm * self.bn * 4) <= budget


def rs_matmul_tiling(M: int, K: int, N: int, dtype_bytes: int = 2,
                     budget: int = VMEM_BYTES) -> MatmulTiling:
    """(bm, bk, bn) for an (M x K) · (K x N) product, weight-stationary:
    the largest stationary weight tile, then bk, bn and bm halved in that
    order until the tiles fit ``budget``."""
    bn = _round_down(min(N, 512), LANE)
    bk = _round_down(min(K, 1024), LANE)
    bm = _round_down(min(M, 512), SUBLANE)
    t = MatmulTiling(bm, bk, bn, dtype_bytes)
    while not t.fits(budget) and t.bk > LANE:
        t = MatmulTiling(t.bm, t.bk // 2, t.bn, dtype_bytes)
    while not t.fits(budget) and t.bn > LANE:
        t = MatmulTiling(t.bm, t.bk, t.bn // 2, dtype_bytes)
    while not t.fits(budget) and t.bm > SUBLANE:
        t = MatmulTiling(t.bm // 2, t.bk, t.bn, dtype_bytes)
    if not t.fits(budget):
        raise ValueError(f"no tiling of {(M, K, N)} fits {budget} B: {t}")
    return t

# ---------------------------------------------------------- matmul route
GEMV_M_MAX = 8          # decode-shaped row counts at/below this take the GEMV
GEMV_BM = SUBLANE       # the GEMV kernel's single m-tile (rows padded to 8)


def matmul_path(M: int) -> str:
    """'gemv' for decode-shaped (skinny) M, else 'gemm'."""
    return "gemv" if M <= GEMV_M_MAX else "gemm"


def bcsc_tile_m(M: int) -> int:
    """m-tile of the BCSC kernels: next pow2 >= M clamped to [SUBLANE, 512]."""
    if matmul_path(M) == "gemv":
        return GEMV_BM
    return min(512, max(SUBLANE, 1 << (max(M, 1) - 1).bit_length()))


# ------------------------------------------------------------ MLP route
FUSED_MLP_VMEM_BUDGET = VMEM_BYTES // 2
DENSE_BLOCK_DENSITY = 0.85        # >= this block density a weight stays dense
BCSC_CHUNK = 8                    # packs are padded to a multiple of this


def fused_mlp_scratch_bytes(bm: int, d_ff: int, n_out: int,
                            gated: bool = True) -> int:
    """fp32 scratch the reference's fused MLP holds: hidden(s) + out accum."""
    n_hidden = 2 if gated else 1
    return 4 * bm * (n_hidden * d_ff + n_out)


def mlp_path(M: int, d_ff: int, n_out: int, *, gated: bool = True,
             density: float = None) -> str:
    """'fused' | 'two_call' | 'dense' for a BCSC-packed MLP at M rows."""
    if density is not None and density >= DENSE_BLOCK_DENSITY:
        return "dense"
    bm = bcsc_tile_m(M)
    if fused_mlp_scratch_bytes(bm, d_ff, n_out, gated) <= FUSED_MLP_VMEM_BUDGET:
        return "fused"
    return "two_call"


# ---------------------------------------------------- paged KV route
PAGE_SIZE = 64                    # tokens per KV page
PAGED_OCCUPANCY_MAX = 0.75


def pages_for(length: int, page_size: int = PAGE_SIZE) -> int:
    """Pages a sequence of ``length`` tokens occupies: ceil(len / page_size)."""
    return -(-max(int(length), 0) // page_size)


def paged_kv_tokens(lengths, page_size: int = PAGE_SIZE) -> int:
    """Token slots resident under paging: sum of ceil(len / ps) · ps."""
    return sum(pages_for(n, page_size) * page_size for n in lengths)


def dense_kv_tokens(rows: int, cache_len: int) -> int:
    """Token slots resident in the dense per-row cache: rows · cache_len."""
    return rows * cache_len


def attn_path(cache_len: int, mean_len: float,
              page_size: int = PAGE_SIZE) -> str:
    """'paged' when the expected resident tokens stay below
    PAGED_OCCUPANCY_MAX of the dense slot, else 'contiguous' (and always
    for caches shorter than two pages)."""
    if cache_len < 2 * page_size:
        return "contiguous"
    expected = pages_for(mean_len, page_size) * page_size
    if expected <= PAGED_OCCUPANCY_MAX * cache_len:
        return "paged"
    return "contiguous"


# -------------------------------------------------- KV store dtype
KV_QUANT_MIN_ROWS = 16
KV_QUANT_DTYPES = ("fp", "int8")


def kv_quant_path(rows: int, cache_len: int,
                  page_size: int = PAGE_SIZE) -> str:
    """'int8' at decode widths >= KV_QUANT_MIN_ROWS on a pageable cache."""
    if cache_len < 2 * page_size:
        return "fp"
    return "int8" if rows >= KV_QUANT_MIN_ROWS else "fp"


def kv_dtype_bytes(kv_quant: str) -> int:
    if kv_quant not in KV_QUANT_DTYPES:
        raise ValueError(f"kv_quant must be one of {KV_QUANT_DTYPES}")
    return 1 if kv_quant == "int8" else 2


def paged_kv_bytes(n_pages: int, page_size: int, kv_heads: int,
                   head_dim: int, n_layers: int, kv_quant: str = "fp") -> int:
    """Bytes of an ``n_pages`` K+V pool over ``n_layers`` global layers,
    including the int8 format's per-(page, kv-head) fp32 scales."""
    payload = 2 * n_pages * page_size * kv_heads * head_dim \
        * kv_dtype_bytes(kv_quant) * n_layers
    scales = 2 * n_pages * kv_heads * 4 * n_layers if kv_quant == "int8" \
        else 0
    return payload + scales


def prefill_kv_transient_bytes(batch: int, seq: int, kv_heads: int,
                               head_dim: int, n_global_layers: int,
                               dtype_bytes: int = 2) -> int:
    """The largest global-attention K+V buffer a batched prefill builds per
    layer, summed over the global layers: (batch, seq, KV, D) x 2. At
    ``seq = cache_len`` the dense transient of a prefill padded to the
    cache before a page scatter; at ``seq = tier`` the page-native
    prefill's only one (the projection's own output)."""
    return 2 * batch * seq * kv_heads * head_dim * dtype_bytes \
        * n_global_layers


def spad_fit_report(weight_count: int, sparsity: float,
                    tiling: MatmulTiling) -> dict:
    """The paper's Table III at the reference's TPU budget: the weights'
    nominal and compressed bytes (CSC's 12-bit entries for 8-bit values,
    x 1.5), the stationary tile's bytes and whether it fits VMEM."""
    nominal = weight_count * tiling.dtype_bytes
    compressed = int(nominal * (1 - sparsity) * 1.5)
    resident = tiling.bk * tiling.bn * tiling.dtype_bytes
    return {
        "nominal_bytes": nominal,
        "compressed_bytes": compressed,
        "resident_tile_bytes": resident,
        "fits_vmem": resident <= VMEM_BYTES,
    }
