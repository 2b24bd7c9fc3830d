"""One (arch x input shape x mesh) cell: its step function, its abstract
inputs and the layouts of its inputs and outputs (the port's copy of
``repro.launch.cell``).

The reference builds a cell for ``jax.jit(...).lower``: ShapeDtypeStruct
inputs and NamedShardings from the HM planner. The port builds the same
cell on the ``meta`` device: every input a ``meta`` tensor of the
reference's shape and dtype (no memory), every sharding a
``sharding.specs.Layout`` of the same spec over a ``sharding.mesh.
TrainMesh`` (which may be logical: ``launch.mesh``), and the outputs'
layouts from one run of the step on ``meta``, in the place of
``jax.eval_shape``. ``CellBuild.trace`` is the counterpart of ``lower``:
it runs the step on the meta inputs under the cell's hints and counts
its FLOPs (``torch.utils.flop_counter``). ``launch.dryrun`` turns a cell
into the reference's cost record.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.core import planner
from repro_torch.models import decoding, layers, transformer as tfm
from repro_torch.models.layers import COMPUTE_DTYPE
from repro_torch.sharding import autoshard, specs as sh
from repro_torch.sharding.mesh import mesh_desc
from repro_torch.sharding.specs import P, tree_named
from repro_torch.train import loop as train_loop
from repro_torch.train import optimizer as opt_lib

__all__ = ["CellBuild", "build_cell", "input_specs", "mesh_desc",
           "serve_partition_specs"]


@dataclasses.dataclass
class CellBuild:
    """A cell's step and everything needed to cost it: ``fn(*abstract_args)``
    runs the step; ``in_layouts`` / ``out_layouts`` are ``Layout`` trees
    shaped as the arguments and the outputs."""
    name: str
    kind: str                     # train | prefill | decode
    fn: Callable
    abstract_args: Tuple
    in_layouts: Tuple
    out_layouts: Any
    donate_argnums: Tuple[int, ...]
    plan: planner.ModelPlan
    cfg: Any
    shape: ShapeConfig
    hints: Any = None
    traced: Optional[Tuple[Any, int]] = dataclasses.field(
        default=None, repr=False)

    def trace(self) -> Tuple[Any, int]:
        """(abstract outputs, FLOPs) of one run of ``fn`` on the meta
        arguments under the cell's hints (``layers.hints_context``): the
        counterpart of ``lower``. The FLOPs are every matrix product's
        (``FlopCounterMode``: forward, backward and the recomputation of
        a remat), at global shapes. Run once; later calls return the same
        result."""
        if self.traced is None:
            with layers.hints_context(self.hints), \
                    FlopCounterMode(display=False) as counter:
                out = self.fn(*self.abstract_args)
            self.traced = (out, counter.get_total_flops())
        return self.traced


# ------------------------------------------------------------- input specs
def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell, of the
    reference's shapes and dtypes. train / prefill: the token batch
    ((B, K, S) at K codebooks; S less the patches of a vision config, whose
    ``patch_embeds`` come beside it), with labels for train; decode: the
    one-token batch. ``cond`` for a config with cross-attention."""
    B = shape.global_batch
    if shape.kind == "decode":
        tok_shape = ((B, cfg.num_codebooks, 1) if cfg.num_codebooks > 1
                     else (B, 1))
        out = {"tokens": _meta(tok_shape, torch.int32)}
    else:
        S_text = shape.seq_len - (cfg.num_patches if cfg.frontend == "vision"
                                  else 0)
        tok_shape = ((B, cfg.num_codebooks, S_text) if cfg.num_codebooks > 1
                     else (B, S_text))
        out = {"tokens": _meta(tok_shape, torch.int32)}
        if shape.kind == "train":
            out["labels"] = _meta(tok_shape, torch.int32)
        if cfg.frontend == "vision":
            out["patch_embeds"] = _meta((B, cfg.num_patches, cfg.d_model),
                                        COMPUTE_DTYPE)
    if cfg.cross_attn_cond:
        out["cond"] = _meta((B, cfg.cross_attn_cond, cfg.d_model),
                            COMPUTE_DTYPE)
    return out


# ------------------------------------------------------------ cell builders
def build_cell(arch: str, shape: ShapeConfig, mesh, *,
               remat_policy: str = "dots", microbatches: int = 1,
               plan: Optional[planner.ModelPlan] = None) -> CellBuild:
    """The cell of ``arch`` (a name, ``-reduced`` allowed) at ``shape`` on
    ``mesh`` (a ``TrainMesh``): the plan is ``planner.plan_model``'s unless
    one is given, the hints ``autoshard.make_hints``'."""
    cfg = get_config(arch)
    plan = plan or planner.plan_model(cfg, shape, mesh_desc(mesh))
    mesh_axes = sh.mesh_axis_sizes(mesh)
    if shape.kind == "train":
        return _build_train(cfg, shape, mesh, plan, mesh_axes, remat_policy,
                            microbatches)
    if shape.kind == "prefill":
        return _build_prefill(cfg, shape, mesh, plan, mesh_axes)
    return _build_decode(cfg, shape, mesh, plan, mesh_axes)


def serve_partition_specs(serve_plan) -> Dict[str, Dict]:
    """The serving path's placement, read off a frozen ``ServePlan``
    (``serve.shard.partition_specs``): launch tooling that reports the
    serving placement asks the plan, never ``planner.plan_model``."""
    from repro_torch.serve import shard
    return shard.partition_specs(serve_plan)


def _logits_spec(a_logits, mesh_axes) -> P:
    dp = sh.dp_axes(mesh_axes)
    return P(*([sh.maybe(dp, a_logits.shape[0], mesh_axes)] +
               [None] * (a_logits.dim() - 1)))


def _build_train(cfg, shape, mesh, plan, mesh_axes, remat_policy,
                 microbatches) -> CellBuild:
    hints = autoshard.make_hints(plan, mesh, shape.global_batch)
    step = train_loop.make_train_step(cfg, opt_lib.OptimizerConfig(),
                                      remat_policy=remat_policy,
                                      microbatches=microbatches,
                                      hints=hints)
    a_params, a_opt = train_loop.abstract_train_state(cfg)
    a_batch = input_specs(cfg, shape)
    p_spec = autoshard.param_specs(a_params, plan, mesh_axes)
    opt_spec = opt_lib.AdamWState(step=P(), mu=p_spec, nu=p_spec)
    b_spec = autoshard.batch_spec(a_batch, plan, mesh_axes)
    cell = CellBuild(
        name=f"{cfg.name}:{shape.name}", kind="train", fn=step,
        abstract_args=(a_params, a_opt, a_batch),
        in_layouts=(tree_named(mesh, p_spec),
                    tree_named(mesh, opt_spec), tree_named(mesh, b_spec)),
        out_layouts=None, donate_argnums=(0, 1), plan=plan, cfg=cfg,
        shape=shape, hints=hints)
    metrics = cell.trace()[0][2]
    m_spec = {k: P() for k in metrics}
    cell.out_layouts = (tree_named(mesh, p_spec),
                        tree_named(mesh, opt_spec),
                        tree_named(mesh, m_spec))
    return cell


def _build_prefill(cfg, shape, mesh, plan, mesh_axes) -> CellBuild:
    cache_len = shape.seq_len
    hints = autoshard.make_hints(plan, mesh, shape.global_batch)

    def prefill_step(params, batch):
        return decoding.prefill(params, batch["tokens"], cfg, cache_len,
                                patch_embeds=batch.get("patch_embeds"),
                                cond=batch.get("cond"), hints=hints)

    a_params = tfm.abstract_params(cfg)
    a_batch = input_specs(cfg, shape)
    p_spec = autoshard.param_specs(a_params, plan, mesh_axes)
    b_spec = autoshard.batch_spec(a_batch, plan, mesh_axes)
    cell = CellBuild(
        name=f"{cfg.name}:{shape.name}", kind="prefill", fn=prefill_step,
        abstract_args=(a_params, a_batch),
        in_layouts=(tree_named(mesh, p_spec), tree_named(mesh, b_spec)),
        out_layouts=None, donate_argnums=(), plan=plan, cfg=cfg,
        shape=shape, hints=hints)
    a_logits, a_cache = cell.trace()[0]
    c_spec = autoshard.cache_spec(a_cache, plan, mesh_axes)
    cell.out_layouts = (tree_named(mesh, _logits_spec(a_logits,
                                                      mesh_axes)),
                        tree_named(mesh, c_spec))
    return cell


def _build_decode(cfg, shape, mesh, plan, mesh_axes) -> CellBuild:
    B, cache_len = shape.global_batch, shape.seq_len
    hints = autoshard.make_hints(plan, mesh, B)

    def serve_step(params, cache, batch, pos):
        return decoding.serve_step(params, cache, batch["tokens"], pos, cfg,
                                   cond=batch.get("cond"), hints=hints)

    a_params = tfm.abstract_params(cfg)
    a_cache = decoding.abstract_cache(cfg, B, cache_len)
    a_batch = input_specs(cfg, shape)
    a_pos = _meta((), torch.int32)
    p_spec = autoshard.param_specs(a_params, plan, mesh_axes)
    c_spec = autoshard.cache_spec(a_cache, plan, mesh_axes)
    b_spec = autoshard.batch_spec(a_batch, plan, mesh_axes)
    cell = CellBuild(
        name=f"{cfg.name}:{shape.name}", kind="decode", fn=serve_step,
        abstract_args=(a_params, a_cache, a_batch, a_pos),
        in_layouts=(tree_named(mesh, p_spec), tree_named(mesh, c_spec),
                    tree_named(mesh, b_spec), tree_named(mesh, P())),
        out_layouts=None, donate_argnums=(1,), plan=plan, cfg=cfg,
        shape=shape, hints=hints)
    a_logits = cell.trace()[0][0]
    cell.out_layouts = (tree_named(mesh, _logits_spec(a_logits,
                                                      mesh_axes)),
                        tree_named(mesh, c_spec))
    return cell
