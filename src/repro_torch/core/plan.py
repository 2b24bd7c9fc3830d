"""ServePlan: every serving dispatch decision resolved once, passed explicitly.

The port's counterpart of ``repro.core.plan``. It carries the same dispatch
fields and route queries, so a plan resolved by the reference
(``plan.as_dict()``) loads here through :meth:`ServePlan.from_dict` and routes
every call identically. :func:`plan_serve` resolves a plan from a serving
budget (rows from the HBM budget and the expected batch, the pool from the
expected lengths, speculation's depth by rule); :func:`plan_for_scheduler`
and :func:`plan_for_engine` from explicit geometry. Two things differ on
purpose:

* the plan is an argument of whatever reads it (``layers.mlp``,
  ``kernels.ops``, the scheduler), never a context variable;
* of the reference's decision records (:class:`Decision`), the port resolves
  ``capacity``, ``mlp``, ``attention``, ``kv_quant``, ``spec``, ``degrade``
  and ``prefill``, with the reference's names, choices and byte and token
  counts; their ``why`` prose, the roofline's seconds (which divide by a
  TPU's memory rate), the ``matmul`` decision and the mesh are not carried.
  A reference plan loaded through :meth:`ServePlan.from_dict` keeps its own
  records.
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
# speculative decoding's model: the assumed per-candidate acceptance of the
# bigram self-draft, the draft depths considered, and the modelled gain
# below which speculation stays off (the reference's constants)
SPEC_ALPHA = 0.8
SPEC_K_CANDIDATES = (2, 3, 4, 6, 8)
SPEC_MIN_GAIN = 1.5


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
    dispatch fields the reference's ``plan_for_scheduler`` resolves, for one
    device (tp = ep = 1). It never speculates (``spec_k`` pinned 0):
    speculation is :func:`plan_serve`'s."""
    return _resolve(cfg, rows, cache_len, mean_len=cache_len / 2,
                    page_size=page_size, num_pages=num_pages,
                    attn_path=attn_path, share_prefix=share_prefix,
                    kv_quant=kv_quant, sync_every=sync_every,
                    drain_only=False, spec_k=0)


def plan_for_engine(cfg, *, slots: int, cache_len: int,
                    sync_every: int = 8) -> ServePlan:
    """The drain engine's single-decision plan (the reference's
    ``plan_for_engine``): a dense per-slot cache, contiguous attention, no
    pages, every other dispatch field resolved by the same rules as
    ``plan_for_scheduler``."""
    return _resolve(cfg, slots, cache_len, mean_len=cache_len / 2,
                    page_size=0, num_pages=0, attn_path=None,
                    share_prefix=None, kv_quant=None, sync_every=sync_every,
                    drain_only=True)


def _normalize_len_dist(expected_len_dist) -> Tuple[float, int]:
    """(mean, max) from a {'mean', 'max'} dict or an iterable of lengths."""
    if isinstance(expected_len_dist, dict):
        mx = int(expected_len_dist["max"])
        return float(expected_len_dist.get("mean", mx / 2)), mx
    lens = [int(x) for x in expected_len_dist]
    if not lens:
        raise ValueError("expected_len_dist must be non-empty")
    return sum(lens) / len(lens), max(lens)


def plan_serve(cfg, *, hbm_budget_bytes: int, expected_batch: int,
               expected_len_dist, page_size: Optional[int] = None,
               num_pages: Optional[int] = None,
               attn_path: Optional[str] = None,
               share_prefix: Optional[bool] = None,
               kv_quant: Optional[str] = None, sync_every: int = 8,
               spec_k: Optional[int] = None, mesh=None) -> ServePlan:
    """A plan from a serving budget, as the reference's ``plan_serve``
    resolves it on one device.

    ``expected_len_dist`` ({'mean', 'max'} or an iterable of total lengths,
    prompt plus generation) gives ``cache_len`` (its max) and the expected
    occupancy (its mean). ``expected_batch`` rows are provisioned, clamped
    to what ``hbm_budget_bytes`` holds in dense ``(1, cache_len)`` slots (at
    least one must fit). The pool holds the expected occupancy plus one
    growth page a row, at least one whole request and at most full
    provisioning. ``spec_k`` None lets the ``spec`` rule pick the draft
    depth (on at one row, for an all-global fp paged plan, when the
    modelled gain reaches ``SPEC_MIN_GAIN``); an int pins it. The keyword
    overrides pin single decisions. ``mesh`` other than one device raises:
    sharded serving is not ported."""
    from repro_torch.serve import kvcache

    if mesh not in (None, (1, 1)):
        raise NotImplementedError(
            f"mesh={mesh!r}: sharded serving is not ported yet")
    mean_len, cache_len = _normalize_len_dist(expected_len_dist)
    slot_bytes = kvcache.cache_bytes(cfg, 1, cache_len)
    fit_rows = int(hbm_budget_bytes // max(slot_bytes, 1))
    if fit_rows < 1:
        raise ValueError(
            f"hbm_budget_bytes={hbm_budget_bytes} cannot hold one "
            f"(1, {cache_len}) cache slot ({slot_bytes} B)")
    rows = max(1, min(int(expected_batch), fit_rows))
    ps = page_size or min(dataflow.PAGE_SIZE, cache_len)
    if num_pages is None:
        max_pages = dataflow.pages_for(cache_len, ps)
        want = rows * (dataflow.pages_for(mean_len, ps) + 1)
        num_pages = min(max(max_pages, want), rows * max_pages)
    return _resolve(cfg, rows, cache_len, mean_len=mean_len, page_size=ps,
                    num_pages=num_pages, attn_path=attn_path,
                    share_prefix=share_prefix, kv_quant=kv_quant,
                    sync_every=sync_every, drain_only=False, spec_k=spec_k,
                    capacity_numbers={
                        "hbm_budget_bytes": int(hbm_budget_bytes),
                        "expected_batch": int(expected_batch),
                        "expected_mean_len": mean_len,
                        "slot_bytes": slot_bytes,
                        "rows_fitting_budget": fit_rows})


def _spec_decision(spec_k: Optional[int], eligible: bool, rows: int,
                   w_bytes: int, c_bytes: int) -> Tuple[int, Decision]:
    """The reference's ``spec`` rule: one flattened k-position verify
    streams the weights once and the cache k times, and retires E[n] =
    (1 - alpha^k) / (1 - alpha) tokens a round, so its modelled gain over
    sequential steps is E[n] (w + c) / (w + k c). On at one row for an
    eligible plan when the best k reaches ``SPEC_MIN_GAIN``; a pinned
    ``spec_k`` is validated. Returns (k, the Decision)."""
    cand = {}
    for kk in SPEC_K_CANDIDATES:
        exp_tokens = (1 - SPEC_ALPHA ** kk) / (1 - SPEC_ALPHA)
        cand[kk] = exp_tokens * (w_bytes + c_bytes) / (w_bytes + kk * c_bytes)
    rule_k = max(cand, key=cand.get)
    rule_on = eligible and rows == 1 and cand[rule_k] >= SPEC_MIN_GAIN
    if spec_k is None:
        k = rule_k if rule_on else 0
    else:
        k = int(spec_k)
        if k and not 2 <= k <= max(SPEC_K_CANDIDATES):
            raise ValueError(f"spec_k must be 0 or in "
                             f"[2, {max(SPEC_K_CANDIDATES)}], got {k}")
        if k and not eligible:
            raise ValueError(
                "spec_k > 0 requires an all-global-attention, single-"
                "codebook, fp paged plan: the flattened verifier's appends "
                "are exact only there")
    return k, Decision(
        "spec", f"k={k}" if k else "off", "HBM", numbers={
            "alpha_assumed": SPEC_ALPHA, "rows": rows,
            "step_bytes_baseline": w_bytes + c_bytes,
            "verify_bytes_per_round": w_bytes + max(k, rule_k) * c_bytes,
            "est_tokens_per_round": (1 - SPEC_ALPHA ** rule_k)
            / (1 - SPEC_ALPHA),
            "est_speedup": cand[rule_k],
            "candidates": {str(kk): v for kk, v in cand.items()},
            "rule_choice": f"k={rule_k}" if rule_on else "off",
        })


def _resolve(cfg, rows: int, cache_len: int, *, mean_len: float,
             page_size: int, num_pages: int, attn_path: Optional[str],
             share_prefix: Optional[bool], kv_quant: Optional[str],
             sync_every: int, drain_only: bool,
             spec_k: Optional[int] = None,
             capacity_numbers: Optional[Dict] = None) -> ServePlan:
    """The reference's ``_resolve`` for one device; ``drain_only`` (the
    drain engine) never pages."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import kvcache

    kinds = {k for k, _ in tfm.slot_kinds(cfg)}
    recurrent = bool(kinds & {"ssm", "rglru"})
    has_global = "global" in kinds
    ps = page_size or min(dataflow.PAGE_SIZE, cache_len)
    max_pages = dataflow.pages_for(cache_len, ps)

    cap_n = dict(capacity_numbers or {})
    cap_n.setdefault("slot_bytes", kvcache.cache_bytes(cfg, 1, cache_len))
    decisions = [Decision("capacity", f"rows={rows} cache_len={cache_len}",
                          "HBM", numbers=cap_n)]

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

    spec_eligible = (paged and kv_quant == "fp" and not recurrent
                     and kinds == {"global"} and cfg.num_codebooks == 1
                     and not drain_only)
    spec_choice, spec_d = _spec_decision(spec_k, spec_eligible, rows,
                                         w_bytes, c_bytes)
    decisions.append(spec_d)

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
        degrade=tuple(ladder), num_pages_int8=np_int8, spec_k=spec_choice,
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
