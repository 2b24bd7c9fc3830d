"""ServePlan: every serving dispatch decision resolved once, passed explicitly.

The port's counterpart of ``repro.core.plan``. It carries the same dispatch
fields and route queries, so a plan resolved by the reference
(``plan.as_dict()``) loads here through :meth:`ServePlan.from_dict` and routes
every call identically. Two things differ on purpose:

* the plan is an argument of whatever reads it (``layers.mlp``,
  ``kernels.ops``, the scheduler), never a context variable;
* of the reference's decision records (:class:`Decision`), the port resolves
  the ones drift detection reads (``attention``, ``kv_quant``, ``mlp``,
  ``degrade``, ``prefill``), with the reference's names, choices and byte
  and token counts; their ``why`` prose and the roofline's seconds (which
  divide by a TPU's memory rate) are not carried. A reference plan loaded
  through :meth:`ServePlan.from_dict` keeps its own records.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import dataflow

# the serving roofline's terms a decision may cite (the reference's BOUNDS)
BOUNDS = ("compute", "HBM", "occupancy", "collective")
BCSC_OVERHEAD = 1.02     # index-vector bytes per payload byte
MLP_SPARSITY = 0.75      # the served MLPs' block sparsity
PACKING_EFFICIENCY = 0.93  # real blocks per padded block slot


@dataclasses.dataclass(frozen=True)
class Decision:
    """One resolved dispatch decision: ``bound`` names the roofline term
    behind it, ``numbers`` the counts it was resolved from (what
    ``serve.telemetry.detect_drift`` measures a run against)."""
    name: str
    choice: str
    bound: str
    why: str = ""
    numbers: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.bound not in BOUNDS:
            raise ValueError(f"{self.name}: bound must be one of {BOUNDS}, "
                             f"got {self.bound!r}")


def _fused_m_max(d_ff: int, n_out: int, gated: bool) -> Optional[int]:
    """Largest M routed 'fused' by ``dataflow.mlp_path``: None when even
    bm=512 fits (fused at every M), 0 when even bm=8 does not."""
    best = 0
    bm = dataflow.SUBLANE
    while bm <= 512:
        if dataflow.fused_mlp_scratch_bytes(bm, d_ff, n_out, gated) \
                <= dataflow.FUSED_MLP_VMEM_BUDGET:
            best = bm
        bm *= 2
    return None if best == 512 else best


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """The reference's dispatch fields; route queries are table lookups."""
    arch: str
    rows: int
    cache_len: int
    sync_every: int
    gemv_m_max: int
    gemv_bm: int
    mlp_fused_m_max: Optional[int]       # None = fused at every M; 0 = never
    mlp_pack_dense_density: float
    bcsc_chunk: int
    attn_path: str
    page_size: int
    max_pages: int
    num_pages: int
    share_prefix: bool
    kv_quant: str
    prefill_exact: bool
    prefill_tiers: Tuple[int, ...]
    degrade: Tuple[str, ...] = ()
    num_pages_int8: int = 0
    spec_k: int = 0
    tp: int = 1
    ep: int = 1
    decisions: Tuple[Decision, ...] = ()

    # ------------------------------------------------------- route queries
    def matmul_route(self, M: int) -> str:
        return "gemv" if M <= self.gemv_m_max else "gemm"

    def bcsc_bm(self, M: int) -> int:
        if self.matmul_route(M) == "gemv":
            return self.gemv_bm
        return min(512, max(dataflow.SUBLANE,
                            1 << (max(M, 1) - 1).bit_length()))

    def mlp_route(self, M: int) -> str:
        if self.mlp_fused_m_max is None or M <= self.mlp_fused_m_max:
            return "fused"
        return "two_call"

    def tier(self, plen: int) -> int:
        if self.prefill_exact:
            return plen
        for t in self.prefill_tiers:
            if t >= plen:
                return t
        return self.cache_len

    @property
    def paged(self) -> bool:
        return self.attn_path == "paged"

    # ------------------------------------------------------- serialization
    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ServePlan":
        """Build from a plan dict, the reference's ``as_dict()`` included:
        its ``decisions`` become :class:`Decision` records, sequences
        tuples."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        for k in ("prefill_tiers", "degrade"):
            if k in kw:
                kw[k] = tuple(kw[k])
        if "decisions" in kw:
            kw["decisions"] = tuple(
                x if isinstance(x, Decision) else Decision(**x)
                for x in kw["decisions"])
        return cls(**kw)


def _pow2_tiers(cache_len: int) -> Tuple[int, ...]:
    tiers = []
    t = 1
    while t < cache_len:
        tiers.append(t)
        t <<= 1
    tiers.append(cache_len)
    return tuple(tiers)


def plan_for_scheduler(cfg, *, rows: int, cache_len: int, page_size: int = 0,
                       num_pages: int = 0, attn_path: Optional[str] = None,
                       share_prefix: Optional[bool] = None,
                       kv_quant: Optional[str] = None,
                       sync_every: int = 8) -> ServePlan:
    """The streaming scheduler's plan from explicit geometry: the same
    dispatch fields the reference's ``plan_for_scheduler`` resolves, for
    the single-device, non-speculative case (``spec_k`` = 0, tp = ep = 1)."""
    return _resolve(cfg, rows, cache_len, page_size=page_size,
                    num_pages=num_pages, attn_path=attn_path,
                    share_prefix=share_prefix, kv_quant=kv_quant,
                    sync_every=sync_every, drain_only=False)


def plan_for_engine(cfg, *, slots: int, cache_len: int,
                    sync_every: int = 8) -> ServePlan:
    """The drain engine's single-decision plan (the reference's
    ``plan_for_engine``): a dense per-slot cache, contiguous attention, no
    pages, every other dispatch field resolved by the same rules as
    ``plan_for_scheduler``."""
    return _resolve(cfg, slots, cache_len, page_size=0, num_pages=0,
                    attn_path=None, share_prefix=None, kv_quant=None,
                    sync_every=sync_every, drain_only=True)


def _resolve(cfg, rows: int, cache_len: int, *, page_size: int,
             num_pages: int, attn_path: Optional[str],
             share_prefix: Optional[bool], kv_quant: Optional[str],
             sync_every: int, drain_only: bool) -> ServePlan:
    """The reference's ``_resolve`` for one device and no speculation;
    ``drain_only`` (the drain engine) never pages."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import kvcache

    kinds = {k for k, _ in tfm.slot_kinds(cfg)}
    recurrent = bool(kinds & {"ssm", "rglru"})
    has_global = "global" in kinds
    ps = page_size or min(dataflow.PAGE_SIZE, cache_len)
    max_pages = dataflow.pages_for(cache_len, ps)
    mean_len = cache_len / 2
    decisions = []

    ff = cfg.dense_d_ff if (cfg.moe and cfg.dense_d_ff) else cfg.d_ff
    fused_max = _fused_m_max(ff, cfg.d_model, cfg.mlp_gated)
    decode_bm = dataflow.bcsc_tile_m(rows)
    mlp_n = _mlp_bytes(cfg, bm=decode_bm)
    mlp_n["fused_m_max"] = fused_max
    mlp_n["scratch_bytes_at_decode_bm"] = dataflow.fused_mlp_scratch_bytes(
        decode_bm, ff, cfg.d_model, cfg.mlp_gated)
    mlp_n["scratch_budget_bytes"] = dataflow.FUSED_MLP_VMEM_BUDGET
    mlp_route = "fused" if (fused_max is None or rows <= fused_max) \
        else "two_call"
    decisions.append(Decision(
        "mlp", f"{mlp_route} (fused_m_max="
        f"{'inf' if fused_max is None else fused_max}, "
        f"chunk={dataflow.BCSC_CHUNK})", "HBM", numbers=mlp_n))

    rule_attn = dataflow.attn_path(cache_len, mean_len, ps) \
        if has_global else "contiguous"
    if attn_path is None:
        attn_path = rule_attn
    if attn_path not in ("paged", "contiguous"):
        raise ValueError(f"attn_path must be paged|contiguous, got {attn_path}")
    paged = has_global and attn_path == "paged" and not drain_only
    np_ = (num_pages or rows * max_pages) if paged else 0
    expected = dataflow.pages_for(mean_len, ps) * ps
    decisions.append(Decision(
        "attention", "paged" if paged else "contiguous", "occupancy",
        numbers={
            "page_size": ps, "max_pages_per_row": max_pages,
            "num_pages": np_, "expected_resident_tokens": expected,
            "cache_len": cache_len,
            "occupancy_threshold": dataflow.PAGED_OCCUPANCY_MAX,
            "tokens_resident_paged": rows * expected,
            "tokens_resident_dense": rows * cache_len,
            "rule_choice": "paged" if (has_global and rule_attn == "paged"
                                       and not drain_only) else "contiguous",
        }))

    if share_prefix is None:
        share_prefix = cfg.num_codebooks == 1
    share_prefix = bool(paged and share_prefix and cfg.num_codebooks == 1)

    rule_kv = dataflow.kv_quant_path(rows, cache_len, ps) if paged else "fp"
    if kv_quant is None:
        kv_quant = rule_kv
    if kv_quant not in dataflow.KV_QUANT_DTYPES:
        raise ValueError(f"kv_quant must be one of {dataflow.KV_QUANT_DTYPES}")
    kv_quant = kv_quant if paged else "fp"
    w_bytes = cfg.param_count() * 2
    c_bytes = kvcache.cache_bytes(cfg, max(rows, 1), cache_len)
    decisions.append(Decision("kv_quant", kv_quant, "HBM", numbers={
        "kv_quant_min_rows": dataflow.KV_QUANT_MIN_ROWS, "rows": rows,
        "weight_stream_bytes": w_bytes, "cache_stream_bytes": c_bytes,
        "cache_share": c_bytes / max(w_bytes + c_bytes, 1),
        "int8_step_speedup": (w_bytes + c_bytes) / (w_bytes + c_bytes / 2),
        "rule_choice": rule_kv,
    }))

    ladder = []
    np_int8 = 0
    deg_n: Dict = {"num_pages": np_}
    if paged:
        fp_b = kvcache.kv_page_bytes(cfg, ps, "fp")
        i8_b = kvcache.kv_page_bytes(cfg, ps, "int8")
        deg_n.update(fp_page_bytes=fp_b, int8_page_bytes=i8_b)
        if kv_quant == "fp":
            np_int8 = min(int(np_ * fp_b // max(i8_b, 1)), rows * max_pages)
            if np_int8 > np_:
                ladder.append("int8_kv")
        ladder += ["clamp_max_new", "shed"]
        deg_n["num_pages_int8"] = np_int8
    decisions.append(Decision(
        "degrade", " -> ".join(ladder) if ladder else "none", "occupancy",
        numbers=deg_n))

    tiers = () if recurrent else _pow2_tiers(cache_len)
    decisions.append(Decision(
        "prefill", "exact-length tiers" if recurrent else
        f"pow2 tiers ({len(tiers)} buckets <= {cache_len})", "compute",
        numbers={"n_tiers": len(tiers), "sync_every": sync_every}))

    return ServePlan(
        arch=getattr(cfg, "name", type(cfg).__name__), rows=rows,
        cache_len=cache_len, sync_every=sync_every,
        gemv_m_max=dataflow.GEMV_M_MAX, gemv_bm=dataflow.GEMV_BM,
        mlp_fused_m_max=fused_max,
        mlp_pack_dense_density=dataflow.DENSE_BLOCK_DENSITY,
        bcsc_chunk=dataflow.BCSC_CHUNK,
        attn_path="paged" if paged else "contiguous", page_size=ps,
        max_pages=max_pages, num_pages=np_, share_prefix=share_prefix,
        kv_quant=kv_quant, prefill_exact=recurrent, prefill_tiers=tiers,
        degrade=tuple(ladder), num_pages_int8=np_int8,
        decisions=tuple(decisions))


def _mlp_bytes(cfg, bm: int = 8) -> Dict:
    """The byte counts of the reference's ``mlp_roofline`` for one layer
    at ``bm`` rows (its seconds, which divide by a TPU's memory rate, are
    not carried)."""
    d, ff = cfg.d_model, cfg.d_ff
    ups = 2 if cfg.mlp_gated else 1
    w_dense = (ups * d * ff + ff * d) * 2            # bf16
    w_real = w_dense * (1 - MLP_SPARSITY) * BCSC_OVERHEAD
    return {
        "sparsity": MLP_SPARSITY, "layers": cfg.num_layers,
        "per_layer_bytes": {
            "weights_dense": w_dense,
            "weights_sparse_real": w_real,
            "weights_sparse_padded": w_real / PACKING_EFFICIENCY,
            "hidden_roundtrip": bm * ff * (ups * 4 + (2 * 4 if ups == 2
                                                     else 0) + 2 + 2),
            "act_in_out": bm * d * (2 + 4),
        },
    }


def num_global_layers(cfg) -> int:
    """Global-attention layers: the ones a paged pool holds."""
    return sum(1 for i in range(cfg.num_layers)
               if cfg.layer_kind(i) == "global")
