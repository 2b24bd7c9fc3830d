"""Dispatch rules the serving path reads (the port's copy of the rules in
``repro.core.dataflow``).

The constants are still the TPU-derived ones (VMEM budget, GEMV crossover,
page size), kept on purpose so that every route the port takes is the route
the reference takes on the same shapes. Re-deriving them for Hopper is a
later planning item (ROADMAP queue 1, item 10).
"""
from __future__ import annotations

VMEM_BYTES = 16 * 1024 * 1024      # the reference's per-core scratch budget
SUBLANE = 8

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
