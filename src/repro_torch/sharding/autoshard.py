"""Apply a ``core.planner.ModelPlan`` to a whole model: partition specs for
params, optimizer state, batches and decode caches, and the activation
hints (the port's copy of ``repro.sharding.autoshard``).

Rules (all divisibility-guarded — indivisible dims fall back to replication,
the planner's BROADCAST mode):

    param_rule 'fsdp_tp'  — TP over `model` (heads / d_ff / experts / vocab),
                            FSDP (ZeRO-3) over (`pod`,`data`) on the d_model dim
    param_rule 'ep_fsdp'  — same, but expert dim takes `model` (EP)
    param_rule 'tp_only'  — TP over `model`, replicated over data axes (decode)
    param_rule 'replicated' — pure DP

A tree's leaves are named by their path of dict keys, the reference's
names, so the port's spec trees equal the reference's leaf for leaf. The
port runs every shard in one process: a spec says how a tensor would be
cut over the mesh (``specs.Layout``), and the hints change the
computation only where the reference's do (``models.layers.seq_shards``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.planner import ModelPlan
from repro_torch.sharding.specs import P, dp_axes, maybe, mesh_axis_sizes


def _map_with_path(fn, tree, path=()):
    """``tree`` (nested dicts) with each leaf replaced by ``fn(path,
    leaf)``; ``path`` is the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


class _Rules:
    def __init__(self, plan: ModelPlan, mesh_axes: Dict[str, int]):
        self.plan = plan
        self.ma = mesh_axes
        rule = plan.param_rule
        self.fsdp = (dp_axes(mesh_axes)
                     if rule in ("fsdp_tp", "ep_fsdp", "fsdp_dp") else None)
        self.tp = "model" if rule in ("fsdp_tp", "ep_fsdp", "tp_only") else None

    def f(self, dim: int):
        """FSDP axes if divisible."""
        return maybe(self.fsdp, dim, self.ma) if self.fsdp else None

    def t(self, dim: int):
        return maybe(self.tp, dim, self.ma) if self.tp else None


def param_spec(path, leaf, plan: ModelPlan, mesh_axes: Dict[str, int]) -> P:
    """Partition spec for one parameter leaf (shape includes any leading
    stacked-period dim, which is never sharded); ``path`` is its keys."""
    r = _Rules(plan, mesh_axes)
    names = [str(k) for k in path]
    name = names[-1] if names else ""
    shape = tuple(leaf.shape)
    stacked = 1 if (names and names[0] == "blocks") else 0

    def pad(spec_entries):
        return P(*([None] * stacked + spec_entries))

    dims = shape[stacked:]
    nd = len(dims)

    if name == "embed":
        if nd == 3:  # (K, V, d)
            return pad([None, r.t(dims[1]) if plan.shard_vocab else None,
                        r.f(dims[2])])
        return pad([r.t(dims[0]) if plan.shard_vocab else None, r.f(dims[1])])
    if name == "lm_head":
        if nd == 3:  # (K, d, V)
            return pad([None, r.f(dims[1]),
                        r.t(dims[2]) if plan.shard_vocab else None])
        return pad([r.f(dims[0]), r.t(dims[1]) if plan.shard_vocab else None])

    if name in ("wq",):  # (d, H, D)
        return pad([r.f(dims[0]),
                    r.t(dims[1]) if plan.shard_heads else None, None])
    if name in ("wk", "wv"):  # (d, KV, D) — cross-attn uses H
        sh = plan.shard_kv_heads if "cross_attn" not in names \
            else plan.shard_heads
        return pad([r.f(dims[0]), r.t(dims[1]) if sh else None, None])
    if name == "wo":  # (H, D, d)
        return pad([r.t(dims[0]) if plan.shard_heads else None, None,
                    r.f(dims[2])])
    if name in ("bq",):
        return pad([r.t(dims[0]) if plan.shard_heads else None, None])
    if name in ("bk", "bv"):
        return pad([r.t(dims[0]) if plan.shard_kv_heads else None, None])

    if name in ("wg", "wu", "w1"):
        if nd == 3:  # MoE experts (E, d, f)
            if plan.shard_experts:
                return pad([r.t(dims[0]), r.f(dims[1]), None])
            return pad([None, r.f(dims[1]),
                        r.t(dims[2]) if plan.shard_ffn else None])
        return pad([r.f(dims[0]), r.t(dims[1]) if plan.shard_ffn else None])
    if name in ("wd", "w2"):
        if nd == 3:  # (E, f, d)
            if plan.shard_experts:
                return pad([r.t(dims[0]), None, r.f(dims[2])])
            return pad([None, r.t(dims[1]) if plan.shard_ffn else None,
                        r.f(dims[2])])
        return pad([r.t(dims[0]) if plan.shard_ffn else None, r.f(dims[1])])
    if name == "router":  # (d, E)
        return pad([r.f(dims[0]), r.t(dims[1])])

    if name == "in_proj":  # ssm (d, e_all) — e_all rarely divisible; guard
        return pad([r.f(dims[0]), r.t(dims[1])])
    if name == "out_proj":  # (di|w, d)
        return pad([r.t(dims[0]), r.f(dims[1])])
    if name in ("in_x", "in_gate"):  # rglru (d, w)
        return pad([r.f(dims[0]), r.t(dims[1])])

    # conv weights, norms, gates, biases, scalars: replicate
    return pad([None] * nd)


def param_specs(abstract_params, plan: ModelPlan, mesh_axes: Dict[str, int]):
    return _map_with_path(lambda p, l: param_spec(p, l, plan, mesh_axes),
                          abstract_params)


# ------------------------------------------------------------ activation hints
@dataclasses.dataclass(frozen=True)
class ShardingHints:
    """Activation sharding constraints — the planner's iact-NoC mode applied
    inside the step (paper: per-layer NoC reconfiguration).

    In the reference they pin activations for XLA's propagation
    (``with_sharding_constraint``): batch over the dp axes, one dim over
    the model axis where it divides. The port runs every shard in one
    process, where a placement constraint changes nothing, as on one
    device: ``constrain_*`` return their input, and the hints keep the
    reference's ``act`` and ``logits`` specs. What they do change is
    attention's sequence sharding (``models.layers.seq_shards`` reads
    ``tp`` and ``model_size``).
    """
    mesh: Optional[object] = None  # sharding.mesh.TrainMesh
    act: Optional[P] = None        # (B, S, d) hidden states
    logits: Optional[P] = None     # (B, C, V[,K]) loss-chunk logits
    model_size: int = 1            # size of the TP axis (for divisibility)
    tp: bool = True                # TP constraints enabled (param_rule != repl)

    def constrain_act(self, x):
        return x

    def constrain_tokens(self, x, **kw):
        return x

    def constrain_logits(self, x):
        return x


def act_batch_axes(plan: ModelPlan, mesh_axes: Dict[str, int],
                   batch_size: int):
    """Mesh axes for the token/batch dim, honoring the plan's iact mode with
    divisibility fall-backs: 'all' → dp+model → dp → None."""
    dp = dp_axes(mesh_axes)
    prefs = ([tuple(dp) + ("model",), dp] if plan.act_axes == "all"
             else [dp])
    for axes in prefs:
        got = maybe(axes, batch_size, mesh_axes)
        if got is not None:
            return got
    return None


def make_hints(plan: ModelPlan, mesh, batch_size: int) -> ShardingHints:
    mesh_axes = mesh_axis_sizes(mesh)
    b_ax = act_batch_axes(plan, mesh_axes, batch_size)
    act = P(b_ax, None, None)
    v_ax = "model" if plan.shard_vocab else None
    logits = P(b_ax, None, v_ax)
    return ShardingHints(mesh=mesh, act=act, logits=logits,
                         model_size=mesh_axes.get("model", 1),
                         tp=plan.param_rule in ("fsdp_tp", "ep_fsdp",
                                                "tp_only"))


# ----------------------------------------------------------------- batch/cache
def batch_spec(abstract_batch, plan: ModelPlan, mesh_axes: Dict[str, int]):
    def spec(path, leaf):
        lead = act_batch_axes(plan, mesh_axes, leaf.shape[0])
        return P(*([lead] + [None] * (len(leaf.shape) - 1)))
    return _map_with_path(spec, abstract_batch)


def cache_spec(abstract_cache, plan: ModelPlan, mesh_axes: Dict[str, int]):
    """KV caches: batch per the plan's iact mode; heads over model if
    divisible, else the cache *sequence* dim over model (flash-decode style) —
    the planner's psum-NoC decision. Recurrent states: batch-sharded."""
    dp = dp_axes(mesh_axes)

    def spec(path, leaf):
        names = [str(k) for k in path]
        name = names[-1] if names else ""
        stacked = 1 if (names and names[0] == "blocks") else 0
        dims = tuple(leaf.shape)[stacked:]

        def pad(entries):
            return P(*([None] * stacked + entries))

        b_ax = act_batch_axes(plan, mesh_axes, dims[0])
        if name in ("k", "v"):          # (B, T, KV, D)
            if plan.shard_kv_heads:
                return pad([b_ax, None, maybe("model", dims[2], mesh_axes),
                            None])
            t_ax = maybe("model", dims[1], mesh_axes)
            if b_ax is None and t_ax is not None:
                # batch unshardable (long_500k B=1): spread seq over dp too
                t_all = maybe(tuple(dp) + ("model",), dims[1], mesh_axes)
                if t_all is not None:
                    t_ax = t_all
            return pad([b_ax, t_ax, None, None])
        # ssd state, conv windows, rglru h: batch-leading
        return pad([b_ax] + [None] * (len(dims) - 1))

    return _map_with_path(spec, abstract_cache)


def replicated_spec(tree):
    return _map_with_path(lambda p, l: P(), tree)
