"""HM-mesh planner: per-layer sharding-mode selection (the paper's per-layer
NoC reconfiguration); the port's copy of ``repro.core.planner``.

For every layer GEMM the planner scores candidate (weight-mode, iact-mode)
pairs with an Eyexam-step-6 roofline over a device's rates and picks the
fastest feasible one, which reproduces the paper's behaviour table
(Fig. 9):

    CONV-like   (high reuse both)   → weights GROUPED_MC  / iacts INTERLEAVED_MC
    DW-CONV     (no iact reuse)     → weights BROADCAST   / iacts UNICAST
    FC @ B=1    (no weight reuse)   → weights UNICAST     / iacts BROADCAST
    MoE experts (G dimension)       → weights GROUPED_MC over experts (= EP)

``plan_model`` aggregates the layer votes into a :class:`ModelPlan`: the
parameter-sharding rule and which dimensions shard over the model axis.
The roofline divides by ``rates`` (``core.eyexam.H100_SXM`` by default;
``TPU_V5E`` gives the reference's choices and times).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.shapes import ShapeConfig  # noqa: F401 (planner.ShapeConfig)
from repro_torch.core.eyexam import H100_SXM, DeviceRates
from repro_torch.core.hmmesh import Mode
from repro_torch.core.reuse import LayerShape, model_gemms, reuse

BYTES = 2            # bf16
TRAIN_BACKWARD = 3.0  # the backward ≈ 2x the forward's FLOPs


@dataclasses.dataclass
class MeshDesc:
    pod: int
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data

    def axes(self) -> Dict[str, int]:
        return {"pod": self.pod, "data": self.data, "model": self.model}


@dataclasses.dataclass
class LayerPlan:
    layer: str
    weight_mode: Mode
    iact_mode: Mode
    est_time: float
    terms: Dict[str, float]
    note: str = ""


# --------------------------------------------------------------- candidates
def _candidate_time(shape: LayerShape, wm: Mode, im: Mode, mesh: MeshDesc,
                    training: bool, rates: DeviceRates
                    ) -> Optional[Tuple[float, Dict[str, float]]]:
    """Roofline time of one (weight-mode, iact-mode) candidate, or None if
    it is infeasible (indivisible dimensions, an incoherent pairing)."""
    N, C, M, G = shape.N, shape.C, shape.M, shape.G
    dp, mp = mesh.dp, mesh.model
    flops = 2.0 * shape.effective_macs * (TRAIN_BACKWARD if training else 1.0)

    # tokens are interleaved (sharded) over the data axes whenever possible
    tok_shards = dp if (im in (Mode.INTERLEAVED_MC, Mode.UNICAST) and
                        N % dp == 0) else 1
    if im in (Mode.INTERLEAVED_MC, Mode.UNICAST) and N % dp:
        return None

    coll = 0.0
    if wm == Mode.BROADCAST:
        w_shards = 1
        if training:  # gradient all-reduce over dp (2(n-1)/n ≈ 2x bytes)
            coll += 2.0 * shape.weight_count * BYTES * (dp - 1) / max(dp, 1)
    elif wm == Mode.GROUPED_MC:
        # TP: weights sharded over model on G (where it means something),
        # else on M
        if G > 1:
            if G % mp:
                return None
        elif M % mp:
            return None
        w_shards = mp
        if G > 1:  # EP: tokens all-to-all there and back
            coll += 2.0 * (N / max(tok_shards, 1)) * C * BYTES
        else:      # Megatron pair: all-reduce activations once per 2 GEMMs
            coll += (N / max(tok_shards, 1)) * M * BYTES / 2
        if training:
            coll += 2.0 * shape.weight_count * BYTES / mp * (dp - 1) / max(dp, 1)
    elif wm == Mode.UNICAST:
        # FSDP / ZeRO-3: weights sharded over every device, gathered per use
        w_shards = dp * mp
        gathers = 2 if training else 1  # forward and backward re-gather
        coll += gathers * shape.weight_count * BYTES * (1 - 1.0 / w_shards)
        if training:  # reduce-scatter of the gradients
            coll += shape.weight_count * BYTES * (1 - 1.0 / w_shards)
    elif wm == Mode.INTERLEAVED_MC:
        # weights sharded over the data axes only (ZeRO within pod rows)
        w_shards = dp
        gathers = 2 if training else 1
        coll += gathers * shape.weight_count * BYTES * (1 - 1.0 / dp)
        if training:
            coll += shape.weight_count * BYTES * (1 - 1.0 / dp)
    else:
        return None

    if im == Mode.BROADCAST and tok_shards > 1:
        return None

    chips = mesh.chips
    # device-memory traffic per device: the local weight shard, iacts and
    # psums, each crossing memory once
    w_bytes = shape.weight_count * (1 - shape.sparsity_w) * BYTES / w_shards
    a_bytes = (shape.iact_count * (1 - shape.sparsity_a) +
               shape.psum_count) * BYTES / max(tok_shards, 1)
    t_c = flops / chips / rates.peak_flops
    t_m = (w_bytes + a_bytes) / rates.hbm_bw
    t_n = (coll / chips) / rates.link_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_n}
    return max(t_c, t_m, t_n), terms


_W_MODES = (Mode.BROADCAST, Mode.GROUPED_MC, Mode.UNICAST, Mode.INTERLEAVED_MC)
_I_MODES = (Mode.BROADCAST, Mode.INTERLEAVED_MC)


def plan_layer(shape: LayerShape, mesh: MeshDesc, training: bool,
               rates: DeviceRates = H100_SXM) -> LayerPlan:
    """The fastest feasible (weight-mode, iact-mode) pair for one GEMM."""
    best = None
    for wm in _W_MODES:
        for im in _I_MODES:
            res = _candidate_time(shape, wm, im, mesh, training, rates)
            if res is None:
                continue
            t, terms = res
            if best is None or t < best[0]:
                best = (t, terms, wm, im)
    if best is None:
        raise ValueError(f"no feasible plan for {shape.name}")
    t, terms, wm, im = best
    r = reuse(shape)
    note = f"reuse w={r['weight']:.0f} i={r['iact']:.0f} p={r['psum']:.0f}"
    return LayerPlan(shape.name, wm, im, t, terms, note)


# ------------------------------------------------------------- model planning
@dataclasses.dataclass
class ModelPlan:
    """The aggregated decision: the parameter-sharding rule and which
    dimensions shard over the model axis."""
    param_rule: str            # fsdp_tp | tp_only | ep_fsdp | fsdp_dp | replicated
    shard_experts: bool        # EP over the model axis
    shard_heads: bool          # attention heads over the model axis
    shard_kv_heads: bool
    shard_ffn: bool            # d_ff over the model axis
    shard_vocab: bool
    cache_seq_sharded: bool    # decode KV cache: sequence over model
    layers: List[LayerPlan]
    mesh: MeshDesc
    # 'dp': tokens over the dp axes, TP over model (grouped multicast).
    # 'all': tokens over every axis, weights broadcast: the paper's DW-CONV
    # mode (Fig. 9b) for families with no TP-able dimension (pure SSM)
    act_axes: str = "dp"

    def describe(self) -> str:
        lines = [f"param_rule={self.param_rule} experts={self.shard_experts} "
                 f"heads={self.shard_heads} kv={self.shard_kv_heads} "
                 f"ffn={self.shard_ffn} vocab={self.shard_vocab} "
                 f"cache_seq={self.cache_seq_sharded}"]
        for lp in self.layers:
            lines.append(f"  {lp.layer:18s} W={lp.weight_mode.value:22s} "
                         f"A={lp.iact_mode.value:22s} t={lp.est_time:.2e} "
                         f"[{lp.note}]")
        return "\n".join(lines)


def plan_model(cfg, shape_cfg, mesh: MeshDesc,
               rates: DeviceRates = H100_SXM) -> ModelPlan:
    """Plan a whole (arch x input shape) cell. ``shape_cfg`` is any object
    with ``kind`` ("train", "prefill" or "decode"), ``global_batch`` and
    ``seq_len`` (``configs.shapes.ShapeConfig``)."""
    training = shape_cfg.kind == "train"
    decode = shape_cfg.kind == "decode"
    tokens = shape_cfg.global_batch * (1 if decode else shape_cfg.seq_len)
    gemms = model_gemms(cfg, max(tokens, 1), decode=decode)
    layer_plans = [plan_layer(g, mesh, training, rates) for g in gemms]

    mp = mesh.model
    shard_heads = cfg.num_heads > 0 and cfg.num_heads % mp == 0
    shard_kv = cfg.num_kv_heads > 0 and cfg.num_kv_heads % mp == 0
    shard_ffn = (cfg.d_ff or cfg.d_inner) % mp == 0 \
        if (cfg.d_ff or cfg.ssm_state) else False
    shard_vocab = cfg.vocab_padded % mp == 0
    shard_experts = cfg.moe and cfg.num_experts % mp == 0

    if training or not decode:
        # params FSDP over data (+ pod), TP over model
        rule = "ep_fsdp" if shard_experts else "fsdp_tp"
    else:
        # decode: little weight reuse, TP / EP shards replicated over data
        rule = "ep_fsdp" if shard_experts else "tp_only"

    # pure SSM: no heads, experts or MLP for TP to grip (paper Fig. 9b):
    # weights broadcast, tokens over the whole mesh, params FSDP over dp
    act_axes = "dp"
    if all(k == "ssm" for k in cfg.attn_pattern):
        act_axes = "all"
        rule = "fsdp_dp"
        shard_heads = shard_kv = shard_ffn = shard_experts = False
        shard_vocab = False

    return ModelPlan(param_rule=rule, shard_experts=shard_experts,
                     shard_heads=shard_heads, shard_kv_heads=shard_kv,
                     shard_ffn=shard_ffn, shard_vocab=shard_vocab,
                     cache_seq_sharded=decode and not shard_kv,
                     layers=layer_plans, mesh=mesh, act_axes=act_axes)
