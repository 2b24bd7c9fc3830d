"""ServePlan: every serving dispatch decision resolved once, passed explicitly.

The port's counterpart of ``repro.core.plan``. Eyeriss v2 picks its
configuration ahead of execution from the layer's shape and sparsity, with
Eyexam (paper Appendix A) justifying each choice; :func:`plan_serve` does
the same for serving. It resolves a plan from a serving budget (rows from
the HBM budget and the expected batch, the pool from the expected lengths,
speculation's depth by rule); :func:`plan_for_scheduler` and
:func:`plan_for_engine` from explicit geometry; :func:`replan_from_lengths`
and :func:`replan_spec_k` re-resolve a serving fleet's plan from measured
lengths and draft acceptance. Each decision carries its
rationale: the roofline term that bounds it, the reference's prose and the
numbers it was resolved from; :meth:`ServePlan.explain` renders them and
:meth:`ServePlan.to_json` serializes the plan.

The plan carries the reference's dispatch fields and route queries, so a
plan resolved by the reference (``plan.as_dict()``) loads here through
:meth:`ServePlan.from_dict` and routes every call identically. Two things
differ on purpose:

* the plan is an argument of whatever reads it (``layers.mlp``,
  ``kernels.ops``, the scheduler); the reference's context variable
  (:func:`activate`, :func:`active_plan`) is read only where a caller
  passes none, and the route lookups (:func:`route_matmul`,
  :func:`route_mlp`, :func:`tile_m`, ...) take the given plan first,
  then the active one, then the ``core.dataflow`` rules;
* the MLP roofline's seconds divide by a named device's rates (``rates=``,
  ``core.eyexam.H100_SXM`` by default; ``TPU_V5E`` gives the reference's).

A ``mesh`` (``"tp=2,ep=4"``) runs the reference's mesh stage: tensor- and
expert-parallel degrees, one ``core.hmmesh.Mode`` decision per data type
and the per-device pool; ``serve.shard`` and ``sharding.tensor_parallel``
serve such a plan shard by shard on the one serving device.

The dispatch constants behind the prose (``core.dataflow``) are still the
TPU-derived ones, so the prose speaks of VMEM scratch and the MXU.

CLI::

    PYTHONPATH=src python -m repro_torch.core.plan --cfg qwen2.5-3b --hbm 40GB
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
from typing import Dict, Optional, Tuple

from repro_torch.core import dataflow, hmmesh
from repro_torch.core.eyexam import H100_SXM, RATES, DeviceRates

# the serving roofline's terms a decision may cite (the reference's BOUNDS)
BOUNDS = ("compute", "HBM", "occupancy", "collective")
BCSC_OVERHEAD = 1.02     # index-vector bytes per payload byte
# speculative decoding's model: the assumed per-candidate acceptance of the
# bigram self-draft, the draft depths considered, and the modelled gain
# below which speculation stays off (the reference's constants)
SPEC_ALPHA = 0.8
SPEC_K_CANDIDATES = (2, 3, 4, 6, 8)
SPEC_MIN_GAIN = 1.5

# the canonical snapshot inputs (the reference's, behind
# scripts/golden_plans.json)
SNAPSHOT_BUDGET_BYTES = 2 << 30          # 2 GiB
SNAPSHOT_BATCH = 8
SNAPSHOT_LEN_DIST = {"mean": 1024, "max": 2048}
SNAPSHOT_SPARSITY = {"sparsity": 0.75, "packing_efficiency": 0.93}
# the canonical sharded snapshots: the MoE configs at two mesh shapes each
# (the reference's, under "__sharded__" in scripts/golden_plans.json)
SHARDED_SNAPSHOT_CONFIGS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
SHARDED_SNAPSHOT_MESHES = ("tp=2,ep=4", "tp=4,ep=2")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One resolved dispatch decision: ``bound`` names the roofline term
    behind it, ``why`` the rationale, ``numbers`` the inputs it was resolved
    from (what ``serve.telemetry.detect_drift`` measures a run against)."""
    name: str
    choice: str
    bound: str
    why: str
    numbers: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.bound not in BOUNDS:
            raise ValueError(f"{self.name}: bound must be one of {BOUNDS}, "
                             f"got {self.bound!r}")


def mlp_roofline(cfg, sparsity: float = 0.75,
                 packing_efficiency: float = 0.93, bm: int = 8,
                 rates: DeviceRates = H100_SXM) -> Dict:
    """Eyexam-style MLP bound model (paper Appendix A): per decode step one
    layer's MLP takes

        t = t_weight_stream + t_hidden_roundtrip + n_launch · t_launch

    over ``rates``' memory rate and launch cost. Sparsity only shrinks the
    first term; the two-call path adds the second (the (bm × d_ff) hidden
    crosses device memory four times) and triples the third, while the
    fused kernel removes both added terms."""
    d, ff = cfg.d_model, cfg.d_ff
    ups = 2 if cfg.mlp_gated else 1
    w_dense = (ups * d * ff + ff * d) * 2            # bf16
    w_real = w_dense * (1 - sparsity) * BCSC_OVERHEAD
    w_padded = w_real / max(packing_efficiency, 1e-6)
    hidden_rt = bm * ff * (ups * 4 + (2 * 4 if ups == 2 else 0) + 2 + 2)
    xio = bm * d * (2 + 4)

    def t(bytes_, launches):
        return bytes_ / rates.hbm_bw + launches * rates.launch_s

    t_dense = t(w_dense + hidden_rt + xio, ups + 1)
    t_two = t(w_padded + hidden_rt + xio, ups + 1)
    t_fused = t(w_real + xio, 1)
    return {
        "sparsity": sparsity, "layers": cfg.num_layers,
        "per_layer_bytes": {
            "weights_dense": w_dense,
            "weights_sparse_real": w_real,
            "weights_sparse_padded": w_padded,
            "hidden_roundtrip": hidden_rt,
            "act_in_out": xio,
        },
        "per_layer_time_s": {
            "dense": t_dense,
            "two_call_sparse": t_two,
            "fused_sparse": t_fused,
        },
        "speedup": {
            "two_call_vs_dense": t_dense / t_two,
            "fused_vs_dense": t_dense / t_fused,
            "fused_vs_two_call": t_two / t_fused,
        },
        "bound": "weight-stream (the term sparsity shrinks) once the hidden "
                 "round-trip and extra launches are fused away",
        "kernel_launch_s": rates.launch_s,
    }


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

    @property
    def sharded(self) -> bool:
        """True when the mesh stage chose more than one device."""
        return self.tp > 1 or self.ep > 1

    @property
    def mesh_devices(self) -> int:
        """Devices the resolved mesh spans (1 for a one-device plan)."""
        return self.tp * self.ep

    # ------------------------------------------------------- serialization
    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.as_dict(), indent=indent, sort_keys=True)

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

    # ------------------------------------------------------------- context
    def activate(self):
        """Context manager making this plan the active dispatch source
        (see :func:`activate`)."""
        return activate(self)

    # -------------------------------------------------------------- report
    def explain(self, drift=None) -> str:
        """Render the per-decision rationale, the Eyexam-style report: every
        decision's choice, its bound, its prose and the numbers it was
        resolved from (the MLP's as its per-layer roofline). With a
        ``serve.telemetry.DriftReport`` as ``drift``, each decision is
        followed by its measured-against-predicted findings."""
        mesh = f", mesh=tp{self.tp}xep{self.ep}" if self.sharded else ""
        lines = [
            f"ServePlan — {self.arch}  "
            f"(rows={self.rows}, cache_len={self.cache_len}, "
            f"sync_every={self.sync_every}{mesh})",
        ]
        for d in self.decisions:
            lines.append(f"  {d.name:<9s}: {d.choice:<28s} [bound: {d.bound}]")
            lines.append(f"      {d.why}")
            if drift is not None:
                for f in drift.for_decision(d.name):
                    lines.append(f"      drift: {f.render()}")
            if d.name == "mlp" and "per_layer_time_s" in d.numbers:
                t = d.numbers["per_layer_time_s"]
                s = d.numbers["speedup"]
                lines.append(
                    "      per-layer roofline: "
                    f"dense {t['dense']:.3e}s / "
                    f"two-call {t['two_call_sparse']:.3e}s / "
                    f"fused {t['fused_sparse']:.3e}s "
                    f"(fused x{s['fused_vs_dense']:.2f} vs dense, "
                    f"x{s['fused_vs_two_call']:.2f} vs two-call)")
            elif d.numbers:
                kv = ", ".join(
                    f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in d.numbers.items()
                    if isinstance(v, (int, float)))
                if kv:
                    lines.append(f"      {kv}")
        if drift is not None:
            lines.append(
                f"  drift: {len(drift.confirmed)} CONFIRMED / "
                f"{len(drift.findings)} compared over {drift.windows} "
                "measured window(s)")
        return "\n".join(lines)


# ----------------------------------------------------------- active context
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("serve_plan",
                                                         default=None)


def active_plan() -> Optional[ServePlan]:
    """The plan made active by :func:`activate`, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def activate(plan: ServePlan):
    """Make ``plan`` the dispatch source of calls inside the block that are
    given no plan."""
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def _dispatch(plan: Optional[ServePlan]) -> Optional[ServePlan]:
    """The plan a call routes by: the one it was given, else the active
    one, else None (the ``core.dataflow`` rules)."""
    return plan if plan is not None else active_plan()


def route_matmul(M: int, plan: Optional[ServePlan] = None) -> str:
    """Plan-first matmul dispatch ('gemv' | 'gemm')."""
    pl = _dispatch(plan)
    return pl.matmul_route(M) if pl is not None else dataflow.matmul_path(M)


def tile_m(M: int, plan: Optional[ServePlan] = None) -> int:
    pl = _dispatch(plan)
    return pl.bcsc_bm(M) if pl is not None else dataflow.bcsc_tile_m(M)


def gemv_bm(plan: Optional[ServePlan] = None) -> int:
    pl = _dispatch(plan)
    return pl.gemv_bm if pl is not None else dataflow.GEMV_BM


def route_mlp(M: int, d_ff: int, n_out: int, gated: bool = True,
              plan: Optional[ServePlan] = None) -> str:
    """Plan-first MLP dispatch ('fused' | 'two_call')."""
    pl = _dispatch(plan)
    if pl is not None:
        return pl.mlp_route(M)
    return dataflow.mlp_path(M, d_ff, n_out, gated=gated)


def bcsc_chunk(plan: Optional[ServePlan] = None) -> int:
    """Plan-first BCSC payload chunk stride (pack-time padding unit)."""
    pl = _dispatch(plan)
    return pl.bcsc_chunk if pl is not None else dataflow.BCSC_CHUNK


def mesh_degrees(plan: Optional[ServePlan] = None) -> Tuple[int, int]:
    """Plan-first ``(tp, ep)``: the mesh a call shards by, (1, 1) with no
    plan."""
    pl = _dispatch(plan)
    return (pl.tp or 1, pl.ep or 1) if pl is not None else (1, 1)


def page_size_default(cache_len: int,
                      plan: Optional[ServePlan] = None) -> int:
    """Plan-first KV page size (``dataflow.PAGE_SIZE`` clamped to the
    cache)."""
    pl = _dispatch(plan)
    if pl is not None:
        return pl.page_size
    return min(dataflow.PAGE_SIZE, cache_len)


def _pow2_tiers(cache_len: int) -> Tuple[int, ...]:
    tiers = []
    t = 1
    while t < cache_len:
        tiers.append(t)
        t <<= 1
    tiers.append(cache_len)
    return tuple(tiers)


def _normalize_len_dist(expected_len_dist) -> Tuple[float, int]:
    """(mean, max) from a {'mean', 'max'} dict or an iterable of lengths."""
    if isinstance(expected_len_dist, dict):
        mx = int(expected_len_dist["max"])
        return float(expected_len_dist.get("mean", mx / 2)), mx
    lens = [int(x) for x in expected_len_dist]
    if not lens:
        raise ValueError("expected_len_dist must be non-empty")
    return sum(lens) / len(lens), max(lens)


def parse_mesh(mesh) -> Tuple[int, int]:
    """Parse a mesh request into ``(tp, ep)``.

    Accepts ``None``/``""`` (no mesh → ``(1, 1)``), a ``(tp, ep)`` pair, a
    mapping ``{"tp": 2, "ep": 4}``, or the CLI string form ``"tp=2,ep=4"``
    (axes optional and order-free, so ``"ep=4"`` means ``tp=1, ep=4``).
    """
    if mesh is None or mesh == "" or mesh == {}:
        return 1, 1
    if isinstance(mesh, str):
        axes = {"tp": 1, "ep": 1}
        for part in mesh.split(","):
            name, sep, val = part.strip().partition("=")
            if name not in axes or not sep or not val.strip().isdigit():
                raise ValueError(
                    f"bad mesh spec {mesh!r}: expected 'tp=N,ep=M' "
                    f"(got segment {part.strip()!r})")
            axes[name.strip()] = int(val)
        tp, ep = axes["tp"], axes["ep"]
    elif isinstance(mesh, dict):
        unknown = sorted(set(mesh) - {"tp", "ep"})
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; the serving "
                             "mesh has axes 'tp' and 'ep'")
        tp, ep = int(mesh.get("tp", 1)), int(mesh.get("ep", 1))
    else:
        tp, ep = (int(mesh[0]), int(mesh[1]))
    if tp < 1 or ep < 1:
        raise ValueError(f"mesh axes must be >= 1, got tp={tp} ep={ep}")
    return tp, ep


def plan_for_scheduler(cfg, *, rows: int, cache_len: int, page_size: int = 0,
                       num_pages: int = 0, attn_path: Optional[str] = None,
                       share_prefix: Optional[bool] = None,
                       kv_quant: Optional[str] = None,
                       sync_every: int = 8,
                       rates: DeviceRates = H100_SXM) -> ServePlan:
    """The streaming scheduler's plan from explicit geometry: the same
    dispatch fields and decisions the reference's ``plan_for_scheduler``
    resolves, for one device (tp = ep = 1; a mesh is :func:`plan_serve`'s).
    It never speculates (``spec_k`` pinned 0): speculation is
    :func:`plan_serve`'s."""
    return _resolve(cfg, cfg.name, rows, cache_len, mean_len=cache_len / 2,
                    page_size=page_size, num_pages=num_pages,
                    attn_path=attn_path, share_prefix=share_prefix,
                    kv_quant=kv_quant, sync_every=sync_every,
                    sparsity_stats=None, drain_only=False, spec_k=0,
                    rates=rates)


def plan_for_engine(cfg, *, slots: int, cache_len: int,
                    sync_every: int = 8, rates: DeviceRates = H100_SXM,
                    mesh=None) -> ServePlan:
    """The drain engine's plan (the reference's ``plan_for_engine``): a
    dense per-slot cache, contiguous attention, no pages, every other
    dispatch field resolved by the same rules as ``plan_for_scheduler``.
    The drain engine is single-device: a ``mesh`` of more than one device
    raises the reference's ``ValueError``."""
    return _resolve(cfg, cfg.name, slots, cache_len, mean_len=cache_len / 2,
                    page_size=0, num_pages=0, attn_path=None,
                    share_prefix=None, kv_quant=None, sync_every=sync_every,
                    sparsity_stats=None, drain_only=True, rates=rates,
                    mesh=mesh)


def plan_serve(cfg, *, hbm_budget_bytes: int, expected_batch: int,
               expected_len_dist, sparsity_stats: Optional[Dict] = None,
               page_size: Optional[int] = None,
               num_pages: Optional[int] = None,
               attn_path: Optional[str] = None,
               share_prefix: Optional[bool] = None,
               kv_quant: Optional[str] = None,
               sync_every: int = 8, arch: Optional[str] = None,
               spec_k: Optional[int] = None, mesh=None,
               rates: DeviceRates = H100_SXM) -> ServePlan:
    """A plan from a serving budget, as the reference's ``plan_serve``
    resolves it.

    ``expected_len_dist`` ({'mean', 'max'} or an iterable of total lengths,
    prompt plus generation) gives ``cache_len`` (its max) and the expected
    occupancy (its mean). ``expected_batch`` rows are provisioned, clamped
    to what ``hbm_budget_bytes`` holds in dense ``(1, cache_len)`` slots (at
    least one must fit). The pool holds the expected occupancy plus one
    growth page a row, at least one whole request and at most full
    provisioning. ``sparsity_stats`` ({'sparsity', 'packing_efficiency'},
    as ``serve.sparse.sparsify_mlp_params`` reports them) feeds the MLP
    roofline, whose seconds divide by ``rates``. ``spec_k`` None lets the
    ``spec`` rule pick the draft depth (on at one row, for an all-global fp
    paged plan, when the modelled gain reaches ``SPEC_MIN_GAIN``); an int
    pins it. The keyword overrides pin single decisions. ``arch`` names the
    plan (the config's name by default). ``mesh`` takes every spelling
    :func:`parse_mesh` reads; one of more than one device runs the mesh
    stage (tensor- and expert-parallel degrees, one ``hmmesh.Mode``
    decision per data type, the per-device pool), and raises the
    reference's ``ValueError`` where the config cannot take it."""
    from repro_torch.serve import kvcache

    mean_len, cache_len = _normalize_len_dist(expected_len_dist)
    slot_bytes = kvcache.cache_bytes(cfg, 1, cache_len)
    fit_rows = int(hbm_budget_bytes // max(slot_bytes, 1))
    if fit_rows < 1:
        raise ValueError(
            f"hbm_budget_bytes={hbm_budget_bytes} cannot hold one "
            f"(1, {cache_len}) cache slot ({slot_bytes} B) — shrink the "
            "expected max length, shard over more chips, or raise the "
            "budget")
    rows = max(1, min(int(expected_batch), fit_rows))
    ps = page_size or min(dataflow.PAGE_SIZE, cache_len)
    if num_pages is None:
        max_pages = dataflow.pages_for(cache_len, ps)
        want = rows * (dataflow.pages_for(mean_len, ps) + 1)
        num_pages = min(max(max_pages, want), rows * max_pages)
    return _resolve(cfg, arch or cfg.name, rows, cache_len,
                    mean_len=mean_len, page_size=ps, num_pages=num_pages,
                    attn_path=attn_path, share_prefix=share_prefix,
                    kv_quant=kv_quant, sync_every=sync_every,
                    sparsity_stats=sparsity_stats, drain_only=False,
                    spec_k=spec_k, rates=rates, mesh=mesh,
                    capacity_numbers={
                        "hbm_budget_bytes": int(hbm_budget_bytes),
                        "expected_batch": int(expected_batch),
                        "expected_mean_len": mean_len,
                        "slot_bytes": slot_bytes,
                        "rows_fitting_budget": fit_rows})


def _resolve(cfg, arch: str, rows: int, cache_len: int, *, mean_len: float,
             page_size: Optional[int], num_pages: Optional[int],
             attn_path: Optional[str], share_prefix: Optional[bool],
             kv_quant: Optional[str], sync_every: int,
             sparsity_stats: Optional[Dict], drain_only: bool,
             rates: DeviceRates, spec_k: Optional[int] = None,
             capacity_numbers: Optional[Dict] = None,
             mesh=None) -> ServePlan:
    """The reference's ``_resolve``: every decision from the
    ``core.dataflow`` rule it centralizes, with the reference's prose, and
    the mesh stage when ``mesh`` spans more than one device.
    ``drain_only`` (the drain engine) never pages and never shards."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import kvcache

    kinds = {k for k, _ in tfm.slot_kinds(cfg)}
    recurrent = bool(kinds & {"ssm", "rglru"})
    has_global = "global" in kinds
    ps = page_size or min(dataflow.PAGE_SIZE, cache_len)
    max_pages = dataflow.pages_for(cache_len, ps)
    decisions = []

    # ---- capacity (HBM): rows × cache_len against the budget ----
    cap_n = dict(capacity_numbers or {})
    cap_n.setdefault("slot_bytes", kvcache.cache_bytes(cfg, 1, cache_len))
    decisions.append(Decision(
        "capacity", f"rows={rows} cache_len={cache_len}", "HBM",
        f"{rows} dense slot(s) of {cap_n['slot_bytes']} B each"
        + (f" fit the {cap_n['hbm_budget_bytes']} B budget"
           if "hbm_budget_bytes" in cap_n else " (caller-fixed geometry)"),
        cap_n))

    # ---- matmul route (compute): GEMV crossover at the decode width ----
    decode_route = dataflow.matmul_path(rows)
    decode_bm = dataflow.bcsc_tile_m(rows)
    decisions.append(Decision(
        "matmul", f"{decode_route} (bm={decode_bm}) at M={rows}", "compute",
        f"M={rows} {'<=' if decode_route == 'gemv' else '>'} "
        f"GEMV_M_MAX={dataflow.GEMV_M_MAX}: "
        + ("MXU m-rows would be padding — skip weight blocks via the "
           "scratch-accumulator GEMV kernel"
           if decode_route == "gemv" else
           "enough rows to amortize the index walk per resident block — "
           "revisit-accumulate GEMM"),
        {"gemv_m_max": dataflow.GEMV_M_MAX, "decode_bm": decode_bm}))

    # ---- MLP route (HBM): scratch-fit crossover + Eyexam roofline ----
    stats = sparsity_stats or {}
    d = cfg.d_model
    ff = cfg.dense_d_ff if (cfg.moe and cfg.dense_d_ff) else cfg.d_ff
    fused_max = _fused_m_max(ff, d, cfg.mlp_gated)
    mlp_route_decode = "fused" if (fused_max is None or rows <= fused_max) \
        else "two_call"
    mlp_n = mlp_roofline(cfg,
                         sparsity=float(stats.get("sparsity", 0.75)),
                         packing_efficiency=float(
                             stats.get("packing_efficiency", 0.93)),
                         bm=decode_bm, rates=rates)
    mlp_n["fused_m_max"] = fused_max
    mlp_n["scratch_bytes_at_decode_bm"] = dataflow.fused_mlp_scratch_bytes(
        decode_bm, ff, d, cfg.mlp_gated)
    mlp_n["scratch_budget_bytes"] = dataflow.FUSED_MLP_VMEM_BUDGET
    decisions.append(Decision(
        "mlp",
        f"{mlp_route_decode} (fused_m_max="
        f"{'inf' if fused_max is None else fused_max}, "
        f"chunk={dataflow.BCSC_CHUNK})", "HBM",
        "hidden activation stays in VMEM scratch while it fits "
        f"({mlp_n['scratch_bytes_at_decode_bm']} B <= "
        f"{mlp_n['scratch_budget_bytes']} B at bm={decode_bm}) — the "
        "two-call hidden round-trip and extra launches are the terms "
        "sparsity cannot shrink",
        mlp_n))

    # ---- attention (occupancy): paged vs contiguous + pool size ----
    rule_attn = dataflow.attn_path(cache_len, mean_len, ps) \
        if has_global else "contiguous"
    attn_pinned = attn_path is not None
    if attn_path is None:
        attn_path = rule_attn
    if attn_path not in ("paged", "contiguous"):
        raise ValueError(f"attn_path must be paged|contiguous, got {attn_path}")
    paged = has_global and attn_path == "paged" and not drain_only
    attn_choice = "paged" if paged else "contiguous"
    rule_choice = "paged" if (has_global and rule_attn == "paged"
                              and not drain_only) else "contiguous"
    expected = dataflow.pages_for(mean_len, ps) * ps
    np_ = (num_pages or rows * max_pages) if paged else 0
    attn_n = {
        "page_size": ps, "max_pages_per_row": max_pages, "num_pages": np_,
        "expected_resident_tokens": expected, "cache_len": cache_len,
        "occupancy_threshold": dataflow.PAGED_OCCUPANCY_MAX,
        "tokens_resident_paged": rows * expected,
        "tokens_resident_dense": rows * cache_len,
        "rule_choice": rule_choice,
    }
    if not has_global:
        why = ("no global-attention layers: ring/recurrent state is already "
               "bounded — indirection would reclaim nothing")
    elif drain_only:
        why = ("drain engine (DecodeEngine): dense per-slot cache by "
               "construction — paging applies to the streaming scheduler")
    elif attn_pinned and attn_choice != rule_choice:
        why = (f"pinned '{attn_choice}' by caller — the occupancy rule "
               f"would pick '{rule_choice}' (expected resident {expected} "
               f"tokens vs {dataflow.PAGED_OCCUPANCY_MAX:.2f}·cache_len="
               f"{dataflow.PAGED_OCCUPANCY_MAX * cache_len:.0f})")
    elif paged:
        why = (f"expected resident {expected} tokens <= "
               f"{dataflow.PAGED_OCCUPANCY_MAX:.2f}·cache_len="
               f"{dataflow.PAGED_OCCUPANCY_MAX * cache_len:.0f}: block-table "
               "indirection converts stranded HBM into extra batch rows")
    else:
        why = ("occupancy too high (or cache shorter than two pages) for "
               "page indirection to reclaim anything — contiguous ring/dense "
               "slots")
    decisions.append(Decision("attention", attn_choice, "occupancy", why,
                              attn_n))

    if share_prefix is None:
        share_prefix = cfg.num_codebooks == 1
    share_prefix = bool(paged and share_prefix and cfg.num_codebooks == 1)

    # ---- KV quant (HBM): cache-stream share of the decode step ----
    rule_kv = dataflow.kv_quant_path(rows, cache_len, ps) if paged else "fp"
    kv_pinned = kv_quant is not None
    if kv_quant is None:
        kv_quant = rule_kv
    if kv_quant not in dataflow.KV_QUANT_DTYPES:
        raise ValueError(f"kv_quant must be one of {dataflow.KV_QUANT_DTYPES}")
    kv_quant = kv_quant if paged else "fp"
    w_bytes = cfg.param_count(active_only=True) * 2
    c_bytes = kvcache.cache_bytes(cfg, max(rows, 1), cache_len)
    cache_share = c_bytes / max(w_bytes + c_bytes, 1)
    kv_n = {
        "kv_quant_min_rows": dataflow.KV_QUANT_MIN_ROWS, "rows": rows,
        "weight_stream_bytes": w_bytes, "cache_stream_bytes": c_bytes,
        "cache_share": cache_share,
        "int8_step_speedup": (w_bytes + c_bytes) / (w_bytes + c_bytes / 2),
        "rule_choice": rule_kv,
    }
    if kv_pinned and kv_quant != rule_kv:
        kv_why = (f"pinned '{kv_quant}' by caller — the cache-bound rule "
                  f"would pick '{rule_kv}' (cache share {cache_share:.2f} "
                  f"at rows={rows} vs KV_QUANT_MIN_ROWS="
                  f"{dataflow.KV_QUANT_MIN_ROWS})")
    else:
        kv_why = (
            f"decode step streams the whole resident cache: cache share "
            f"{cache_share:.2f} of HBM bytes at rows={rows} "
            + (f">= KV_QUANT_MIN_ROWS={dataflow.KV_QUANT_MIN_ROWS} — int8 "
               "pages halve the dominant stream" if kv_quant == "int8" else
               "— below the cache-bound regime (or unpaged): per-page scale "
               "bookkeeping would outweigh the payload win"))
    decisions.append(Decision("kv_quant", kv_quant, "HBM", kv_why, kv_n))

    # ---- speculative decode (HBM): draft k, verify once per round ----
    # one flattened k-position verify streams the weights once and the
    # resident cache k times, and retires E[n] = (1 - alpha^k)/(1 - alpha)
    # tokens a round: speculation pays when the weight stream dominates
    # the step (batch-1 decode)
    spec_pinned = spec_k is not None
    spec_eligible = (paged and kv_quant == "fp" and not recurrent
                     and kinds == {"global"} and cfg.num_codebooks == 1
                     and not drain_only)
    spec_cand = {}
    for kk in SPEC_K_CANDIDATES:
        exp_tokens = (1 - SPEC_ALPHA ** kk) / (1 - SPEC_ALPHA)
        spec_cand[kk] = exp_tokens * (w_bytes + c_bytes) \
            / (w_bytes + kk * c_bytes)
    rule_spec = max(spec_cand, key=spec_cand.get)
    rule_gain = spec_cand[rule_spec]
    rule_on = spec_eligible and rows == 1 and rule_gain >= SPEC_MIN_GAIN
    if spec_pinned:
        spec_choice = int(spec_k)
        if spec_choice and not (2 <= spec_choice <= max(SPEC_K_CANDIDATES)):
            raise ValueError(
                f"spec_k must be 0 or in [2, {max(SPEC_K_CANDIDATES)}], "
                f"got {spec_choice}")
        if spec_choice and not spec_eligible:
            raise ValueError(
                "spec_k > 0 requires an all-global-attention, single-"
                "codebook, fp paged plan: the flattened verifier's appends "
                "are exact only there")
    else:
        spec_choice = rule_spec if rule_on else 0
    spec_n = {
        "alpha_assumed": SPEC_ALPHA, "rows": rows,
        "step_bytes_baseline": w_bytes + c_bytes,
        "verify_bytes_per_round": w_bytes + max(spec_choice, rule_spec)
        * c_bytes,
        "est_tokens_per_round": (1 - SPEC_ALPHA ** rule_spec)
        / (1 - SPEC_ALPHA),
        "est_speedup": rule_gain,
        "candidates": {str(kk): v for kk, v in spec_cand.items()},
        "rule_choice": f"k={rule_spec}" if rule_on else "off",
    }
    if spec_pinned and (spec_choice > 0) != rule_on:
        spec_why = (f"pinned {'k=%d' % spec_choice if spec_choice else 'off'}"
                    f" by caller — the batch-1 weight-stream rule would pick "
                    f"'{spec_n['rule_choice']}' (modeled "
                    f"{rule_gain:.2f}x at alpha={SPEC_ALPHA})")
    elif spec_choice:
        spec_why = (
            f"batch-1 decode is weight-stream bound (cache share "
            f"{cache_share:.2f}): one k={spec_choice} verify streams the "
            f"weights once for E[n]="
            f"{(1 - SPEC_ALPHA ** spec_choice) / (1 - SPEC_ALPHA):.2f} "
            f"retired tokens at alpha={SPEC_ALPHA} — modeled "
            f"{spec_cand.get(spec_choice, rule_gain):.2f}x over sequential "
            "greedy, bit-exact by accept-prefix construction")
    elif not spec_eligible:
        spec_why = ("requires an all-global-attention, single-codebook, "
                    "fp paged plan (flattened verify appends are only "
                    "bit-exact there) — "
                    + ("drain engine" if drain_only else
                       f"this plan has kinds={sorted(kinds)}, "
                       f"kv_quant={kv_quant}, paged={paged}"))
    elif rows != 1:
        spec_why = (f"rows={rows}: batch rows already amortize the "
                    "weight stream, and the k x cache-stream verify "
                    "cost scales with occupancy — speculation is the "
                    "batch-1 lever")
    else:
        spec_why = (f"modeled gain {rule_gain:.2f}x < "
                    f"{SPEC_MIN_GAIN}x at alpha={SPEC_ALPHA}")
    decisions.append(Decision(
        "spec", f"k={spec_choice}" if spec_choice else "off", "HBM",
        spec_why, spec_n))

    # ---- degrade ladder (occupancy): authorized overload behavior ----
    ladder = []
    np_int8 = 0
    deg_n: Dict = {"num_pages": np_}
    if paged:
        fp_b = kvcache.kv_page_bytes(cfg, ps, "fp")
        i8_b = kvcache.kv_page_bytes(cfg, ps, "int8")
        deg_n.update(fp_page_bytes=fp_b, int8_page_bytes=i8_b)
        if kv_quant == "fp":
            # pages the fp pool's footprint holds in the int8 layout, capped
            # at full provisioning (more is unreachable)
            np_int8 = min(int(np_ * fp_b // max(i8_b, 1)), rows * max_pages)
            if np_int8 > np_:
                ladder.append("int8_kv")
        ladder += ["clamp_max_new", "shed"]
        deg_n["num_pages_int8"] = np_int8
    if not paged:
        deg_why = ("contiguous KV: no page pool to trade occupancy against "
                   "— arrivals queue on the slot allocator and only "
                   "deadlines bound their wait")
    else:
        steps = []
        if "int8_kv" in ladder:
            steps.append(
                f"requantize the pool to int8 pages at the same HBM "
                f"footprint ({np_} -> {np_int8} pages of {i8_b} B "
                f"vs {fp_b} B)")
        steps.append("clamp new admissions' max_new")
        steps.append("shed new arrivals off measured pool pressure")
        deg_why = ("occupancy, not compute, is what collapses under an "
                   "arrival spike: " + "; then ".join(steps)
                   + " — admitted work keeps finishing instead of the run "
                     "raising on pool exhaustion")
    decisions.append(Decision(
        "degrade", " -> ".join(ladder) if ladder else "none", "occupancy",
        deg_why, deg_n))

    # ---- prefill schedule (compute): pow2 tiers vs exact lengths ----
    tiers = () if recurrent else _pow2_tiers(cache_len)
    decisions.append(Decision(
        "prefill",
        "exact-length tiers" if recurrent else
        f"pow2 tiers ({len(tiers)} buckets <= {cache_len})", "compute",
        ("recurrent state (ssm/rglru): pad tokens would pollute the carried "
         "state, so admission buckets by exact length" if recurrent else
         "causality makes right-padding exact, so admission buckets to the "
         "next power of two — trace count stays logarithmic in prompt-"
         "length spread while batched prefill amortizes over the cohort"),
        {"n_tiers": len(tiers), "sync_every": sync_every}))

    # ---- mesh resolution (collective): the hierarchical-mesh stage ----
    # decisions appear only when a mesh is requested; per data type, the
    # multicast pattern that matches its reuse (the paper's per-data-type
    # NoC reconfiguration, at cluster scale)
    tp, ep = parse_mesh(mesh)
    if tp > 1 or ep > 1:
        decisions += _mesh_decisions(
            cfg, arch, tp, ep, drain_only=drain_only, recurrent=recurrent,
            w_bytes=w_bytes, c_bytes=c_bytes, paged=paged, rows=rows,
            cache_len=cache_len, num_pages=np_, page_size=ps,
            kv_quant=kv_quant)

    return ServePlan(
        arch=arch, rows=rows, cache_len=cache_len, sync_every=sync_every,
        gemv_m_max=dataflow.GEMV_M_MAX, gemv_bm=dataflow.GEMV_BM,
        mlp_fused_m_max=fused_max,
        mlp_pack_dense_density=dataflow.DENSE_BLOCK_DENSITY,
        bcsc_chunk=dataflow.BCSC_CHUNK,
        attn_path=attn_choice, page_size=ps, max_pages=max_pages,
        num_pages=np_, share_prefix=share_prefix, kv_quant=kv_quant,
        prefill_exact=recurrent, prefill_tiers=tiers,
        degrade=tuple(ladder), num_pages_int8=np_int8, spec_k=spec_choice,
        tp=tp, ep=ep, decisions=tuple(decisions))


def _mesh_decisions(cfg, arch: str, tp: int, ep: int, *, drain_only: bool,
                    recurrent: bool, w_bytes: int, c_bytes: int, paged: bool,
                    rows: int, cache_len: int, num_pages: int,
                    page_size: int, kv_quant: str) -> list:
    """The reference's mesh stage: validation (its ``ValueError``s), then
    the ``mesh``, ``noc_weights``, ``noc_kv``, ``noc_acts``,
    ``noc_experts`` (ep > 1) and ``pool_shard`` (paged) decisions with its
    numbers and prose."""
    from repro_torch.serve import kvcache

    if drain_only:
        raise ValueError("mesh sharding serves through the streaming "
                         "scheduler — the drain engine is single-device")
    if recurrent and tp > 1:
        raise ValueError(
            f"tp={tp} shards attention KV heads; {arch} carries "
            "recurrent (ssm/rglru) state that has no head axis — "
            "serve it single-device or dp-replicated")
    if tp > 1 and cfg.num_kv_heads % tp != 0:
        raise ValueError(
            f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads} — "
            "the paged-attention kernel reads whole local KV-head "
            "shards (hmmesh.divisible)")
    if ep > 1 and not getattr(cfg, "moe", False):
        raise ValueError(
            f"ep={ep} shards the MoE expert axis but {arch} has no "
            "experts — use tp (or dp replicas) instead")
    if ep > 1 and cfg.num_experts % ep != 0:
        raise ValueError(
            f"ep={ep} must divide num_experts={cfg.num_experts} — "
            "expert shards are contiguous slices of the expert axis")
    devices = tp * ep
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.layer_kind(i) in ("global", "local", "chunked"))
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    # per-token collective traffic: each device produces a 1/tp slice of
    # every layer's head context and receives the other (tp-1)/tp
    ctx_bytes = cfg.num_heads * cfg.head_dim * 2
    ag_bytes_tok = int(n_attn * ctx_bytes * (tp - 1) / max(tp, 1))
    per_dev_hbm = w_bytes + c_bytes // max(tp, 1)
    out = [Decision(
        "mesh", f"tp={tp} ep={ep} ({devices} devices)", "collective",
        f"{cfg.num_kv_heads} KV heads partition over tp={tp} "
        f"({cfg.num_kv_heads // tp} local heads/device)"
        + (f"; {cfg.num_experts} experts over ep={ep} "
           f"({cfg.num_experts // ep} local experts/device)"
           if ep > 1 else "")
        + f" — {ag_bytes_tok} collective B/token vs "
        f"{per_dev_hbm} HBM B/step per device: the all-gather is "
        "negligible next to the weight stream, so sharding converts "
        "mesh width into cache capacity at full occupancy",
        {"tp": tp, "ep": ep, "devices": devices,
         "allgather_bytes_per_token": ag_bytes_tok,
         "hbm_bytes_per_step_per_device": per_dev_hbm})]
    out.append(Decision(
        "noc_weights", hmmesh.Mode.BROADCAST.name, "HBM",
        f"dense weights replicate to all {devices} devices "
        f"({w_bytes} B each): decode is weight-stream bound, and a "
        f"sharded store would re-gather {(tp - 1) * w_bytes // max(tp, 1)}"
        " B per step onto the critical path — replication trades idle "
        "HBM capacity for zero collective bytes per step",
        {"mode": hmmesh.Mode.BROADCAST.value,
         "weight_bytes_per_device": w_bytes,
         "allgather_bytes_avoided_per_step":
             (tp - 1) * w_bytes // max(tp, 1)}))
    out.append(Decision(
        "noc_kv", f"{hmmesh.Mode.GROUPED_MC.name} (local shards)", "HBM",
        f"KV pages shard by head over tp={tp}: every device streams "
        f"only its {c_bytes // max(tp, 1)} B local slice per step "
        f"(1/{tp} of {c_bytes} B) and the paged-attention kernel never "
        "reads a remote page — attention is per-KV-head local, so the "
        "cache stream divides with zero collective bytes",
        {"mode": hmmesh.Mode.GROUPED_MC.value, "tp": tp,
         "cache_stream_bytes_per_device": c_bytes // max(tp, 1),
         "cache_stream_bytes_single": c_bytes}))
    out.append(Decision(
        "noc_acts", "all-gather -> " + hmmesh.Mode.BROADCAST.name,
        "collective",
        f"head contexts are produced {hmmesh.Mode.UNICAST.name} (a "
        f"unique 1/{tp} slice per device) and all-gathered to full "
        f"width before the output projection: {ag_bytes_tok} B/token "
        f"received per device across {n_attn} attention layer(s) — "
        "the only per-step mesh traffic, and it is token-sized, not "
        "cache-sized",
        {"allgather_bytes_per_token": ag_bytes_tok,
         "attn_layers": n_attn, "ctx_bytes_per_layer": ctx_bytes}))
    if ep > 1:
        nmats = 3 if cfg.mlp_gated else 2
        e_bytes = cfg.num_experts * nmats * cfg.d_model * cfg.d_ff * 2 \
            * max(n_moe, 1)
        out.append(Decision(
            "noc_experts",
            f"{hmmesh.Mode.INTERLEAVED_MC.name} "
            f"({cfg.num_experts // ep}/{cfg.num_experts} per device)",
            "HBM",
            f"expert weights shard over ep={ep}: {e_bytes // ep} B "
            f"resident per device instead of {e_bytes} B — the expert "
            "axis is a batch axis in the decode einsums, so each shard "
            "computes its slice and the gate-weighted combine runs on "
            "the gathered full-E tensor (router stays replicated)",
            {"mode": hmmesh.Mode.INTERLEAVED_MC.value, "ep": ep,
             "expert_bytes_per_device": e_bytes // ep,
             "expert_bytes_total": e_bytes, "moe_layers": n_moe}))
    if paged:
        pool_b = kvcache.paged_cache_bytes(cfg, rows, cache_len, num_pages,
                                           page_size, kv_quant)
        out.append(Decision(
            "pool_shard",
            f"{num_pages} pages x 1/{tp} heads per device", "occupancy",
            f"every device runs its own PageAllocator over {num_pages} "
            f"pages holding the local KV-head slice: "
            f"{pool_b // max(tp, 1)} B pool per device (1/{tp} of the "
            f"{pool_b} B single-device pool), same block tables on every "
            "shard — the block table IS the distributed address space, "
            "so CoW sharing and the degrade ladder operate per device "
            "pool in lockstep",
            {"num_pages_per_device": num_pages,
             "pool_bytes_per_device": pool_b // max(tp, 1),
             "pool_bytes_single": pool_b, "tp": tp}))
    return out


def replan_from_lengths(cfg, base_plan: ServePlan, lengths, *,
                        arch: Optional[str] = None,
                        rates: DeviceRates = H100_SXM) -> ServePlan:
    """Feedback re-planning (the fleet's, ``serve.replica.ReplicaSet``): a
    fresh plan from measured finished-request lengths (prompt plus
    generated tokens), as the reference's ``replan_from_lengths`` resolves
    it. The serving envelope stays pinned (rows, cache_len, page geometry,
    the attention path, sharing, KV format, sync cadence, ``spec_k``), so a
    swap at a drain boundary never shrinks feasibility or flips a dispatch
    decision; only the pool re-resolves, from ``{'mean': measured mean,
    'max': base.cache_len}``. ``rates`` divides the MLP roofline's seconds,
    as in :func:`plan_serve`."""
    from repro_torch.serve import kvcache

    mean_len, _ = _normalize_len_dist(list(lengths))
    mean_len = min(mean_len, float(base_plan.cache_len))
    slot_bytes = kvcache.cache_bytes(cfg, 1, base_plan.cache_len)
    return plan_serve(
        cfg,
        hbm_budget_bytes=base_plan.rows * slot_bytes,
        expected_batch=base_plan.rows,
        expected_len_dist={"mean": mean_len, "max": base_plan.cache_len},
        page_size=base_plan.page_size or None,
        attn_path=base_plan.attn_path,
        share_prefix=base_plan.share_prefix,
        kv_quant=base_plan.kv_quant,
        sync_every=base_plan.sync_every,
        spec_k=base_plan.spec_k,
        mesh={"tp": base_plan.tp, "ep": base_plan.ep}
        if base_plan.sharded else None,
        arch=arch or base_plan.arch, rates=rates)


def _alpha_from_acceptance(rate: float, k: int) -> float:
    """The per-candidate acceptance ``alpha`` behind a measured acceptance
    rate (emitted over drafted per round) under the geometric model
    ``E[n]/k = (1 - alpha^k) / ((1 - alpha) k)``, increasing in alpha on
    (0, 1): 60 steps of bisection."""
    k = max(int(k), 1)
    rate = min(max(float(rate), 0.0), 1.0)
    lo, hi = 0.0, 0.999
    for _ in range(60):
        mid = (lo + hi) / 2
        if (1 - mid ** k) / ((1 - mid) * k) < rate:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def replan_spec_k(cfg, base_plan: ServePlan, *, drafted_tokens: int,
                  accepted_tokens: int, min_samples: int = 64) -> ServePlan:
    """Acceptance-adaptive speculative depth (the reference's
    ``replan_spec_k``): the ``spec`` rule's gain model run again with the
    measured acceptance in place of :data:`SPEC_ALPHA`, k set to the best
    candidate, or off below :data:`SPEC_MIN_GAIN`. Everything else stays
    pinned; ``base_plan`` itself comes back when speculation is off, the
    sample is under ``min_samples`` drafted tokens, or k stays."""
    from repro_torch.serve import kvcache

    if base_plan.spec_k < 2 or drafted_tokens < min_samples:
        return base_plan
    rate = accepted_tokens / max(drafted_tokens, 1)
    alpha = _alpha_from_acceptance(rate, base_plan.spec_k)
    w_bytes = cfg.param_count(active_only=True) * 2
    c_bytes = kvcache.cache_bytes(cfg, max(base_plan.rows, 1),
                                  base_plan.cache_len)
    cand = {}
    for kk in SPEC_K_CANDIDATES:
        exp_tokens = (1 - alpha ** kk) / max(1 - alpha, 1e-9)
        cand[kk] = exp_tokens * (w_bytes + c_bytes) \
            / (w_bytes + kk * c_bytes)
    best = max(cand, key=cand.get)
    new_k = best if cand[best] >= SPEC_MIN_GAIN else 0
    if new_k == base_plan.spec_k:
        return base_plan
    spec_n = {
        "alpha_assumed": SPEC_ALPHA, "alpha_measured": round(alpha, 4),
        "acceptance_rate_measured": round(rate, 4),
        "drafted_tokens": int(drafted_tokens),
        "accepted_tokens": int(accepted_tokens),
        "previous_k": base_plan.spec_k,
        "est_speedup": cand[best],
        "candidates": {str(kk): v for kk, v in cand.items()},
    }
    why = (f"measured acceptance {rate:.2f} over {drafted_tokens} drafted "
           f"tokens inverts to alpha={alpha:.2f} (planned {SPEC_ALPHA}): "
           + (f"the gain model now peaks at k={new_k} "
              f"({cand[best]:.2f}x)" if new_k else
              f"best modeled gain {cand[best]:.2f}x < {SPEC_MIN_GAIN}x — "
              "drafts miss too often to pay for the k-wide verify; "
              "speculation turns off")
           + f" — re-planned from k={base_plan.spec_k} at a drain boundary")
    decisions = tuple(
        d if d.name != "spec" else Decision(
            "spec", f"k={new_k}" if new_k else "off", "HBM", why, spec_n)
        for d in base_plan.decisions)
    return dataclasses.replace(base_plan, spec_k=new_k, decisions=decisions)


def num_global_layers(cfg) -> int:
    """Global-attention layers: the ones a paged pool holds."""
    return sum(1 for i in range(cfg.num_layers)
               if cfg.layer_kind(i) == "global")


# -------------------------------------------------------------- snapshotting
def snapshot_plan(arch: str, rates: DeviceRates = H100_SXM) -> ServePlan:
    """The canonical resolved plan of a config: the reference's fixed
    budget and shape inputs (``SNAPSHOT_*``), so that the serialized plan
    is deterministic. At ``TPU_V5E`` rates it is the plan
    ``scripts/golden_plans.json`` records for ``arch``."""
    from repro_torch.configs import get_config
    return plan_serve(get_config(arch),
                      hbm_budget_bytes=SNAPSHOT_BUDGET_BYTES,
                      expected_batch=SNAPSHOT_BATCH,
                      expected_len_dist=dict(SNAPSHOT_LEN_DIST),
                      sparsity_stats=dict(SNAPSHOT_SPARSITY), arch=arch,
                      rates=rates)


def snapshot_sharded_plan(arch: str, mesh: str,
                          rates: DeviceRates = H100_SXM) -> ServePlan:
    """The canonical sharded plan of a config at one mesh shape: the
    :func:`snapshot_plan` inputs plus the mesh stage, which reads no device
    count. At ``TPU_V5E`` rates it is the plan
    ``scripts/golden_plans.json`` records under ``"__sharded__"``."""
    from repro_torch.configs import get_config
    return plan_serve(get_config(arch),
                      hbm_budget_bytes=SNAPSHOT_BUDGET_BYTES,
                      expected_batch=SNAPSHOT_BATCH,
                      expected_len_dist=dict(SNAPSHOT_LEN_DIST),
                      sparsity_stats=dict(SNAPSHOT_SPARSITY), arch=arch,
                      rates=rates, mesh=mesh)


# ----------------------------------------------------------------------- CLI
def _parse_bytes(s: str) -> int:
    s = s.strip()
    units = {"kib": 1 << 10, "mib": 1 << 20, "gib": 1 << 30,
             "kb": 10 ** 3, "mb": 10 ** 6, "gb": 10 ** 9, "b": 1}
    low = s.lower()
    for suffix, mult in units.items():
        if low.endswith(suffix):
            return int(float(low[: -len(suffix)]) * mult)
    return int(float(s))


def _resolve_arch_name(name: str) -> str:
    """Accept registry ids ('gemma2-2b'), module names ('gemma2_2b'), and
    either with a '-reduced' suffix."""
    from repro_torch.configs import _ARCH_MODULES
    suffix = ""
    base = name
    if name.endswith("-reduced") or name.endswith("_reduced"):
        base, suffix = name[:-len("-reduced")], "-reduced"
    if base in _ARCH_MODULES:
        return base + suffix
    for reg, mod in _ARCH_MODULES.items():
        if base in (mod, reg.replace("-", "_")):
            return reg + suffix
    raise KeyError(f"unknown arch {name!r}; known: {list(_ARCH_MODULES)}")


def main(argv=None) -> int:
    import argparse
    from repro_torch.configs import get_config

    ap = argparse.ArgumentParser(
        description="Resolve a ServePlan and print its Eyexam-style "
                    "per-decision rationale.")
    ap.add_argument("--cfg", required=True,
                    help="arch id (gemma2-2b) or module name (gemma2_2b)")
    ap.add_argument("--hbm", default="2GiB",
                    help="HBM budget (e.g. 40GB, 2GiB, 512MiB, 16e9)")
    ap.add_argument("--batch", type=int, default=SNAPSHOT_BATCH,
                    help="expected decode batch width")
    ap.add_argument("--mean-len", type=int,
                    default=SNAPSHOT_LEN_DIST["mean"],
                    help="expected mean total tokens per request")
    ap.add_argument("--max-len", type=int, default=SNAPSHOT_LEN_DIST["max"],
                    help="max total tokens per request (the cache length)")
    ap.add_argument("--sparsity", type=float,
                    default=SNAPSHOT_SPARSITY["sparsity"])
    ap.add_argument("--mesh", default=None,
                    help="mesh shape, e.g. 'tp=2,ep=4' — adds the mesh "
                         "resolution stage (NoC mode per data type, "
                         "per-device pool)")
    ap.add_argument("--rates", choices=sorted(RATES), default=H100_SXM.name,
                    help="the device whose rates the MLP roofline divides "
                         "by")
    ap.add_argument("--json", action="store_true",
                    help="print plan.to_json() instead of the report")
    args = ap.parse_args(argv)

    arch = _resolve_arch_name(args.cfg)
    plan = plan_serve(
        get_config(arch),
        hbm_budget_bytes=_parse_bytes(args.hbm),
        expected_batch=args.batch,
        expected_len_dist={"mean": args.mean_len, "max": args.max_len},
        sparsity_stats={"sparsity": args.sparsity,
                        "packing_efficiency":
                            SNAPSHOT_SPARSITY["packing_efficiency"]},
        arch=arch, mesh=args.mesh, rates=RATES[args.rates])
    print(plan.to_json() if args.json else plan.explain())
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
