"""Elastic scaling: restore a checkpoint onto whatever mesh currently
exists (the port's copy of ``repro.runtime.elastic``).

Checkpoints are stored by logical shape (``checkpoint.manager``), so
scaling a job from N to M devices — or degrading around a dead host — is:
build the new mesh, re-run the planner for its ``MeshDesc``, and restore
with the new layouts. No checkpoint conversion step. Each leaf lands whole
on the mesh's device: the one process's on a logical mesh, each rank's own
on a process mesh (``mesh.group``), where the params are replicated, so a
checkpoint written at a world of N ranks restores at any world M. The
re-planned specs are checked against every leaf and returned beside the
state.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.planner import plan_model
from repro_torch.sharding import autoshard, specs as sspec
from repro_torch.sharding.mesh import mesh_desc
from repro_torch.sharding.specs import P


def state_specs(abstract_state, cfg, shape_cfg, mesh):
    """(param specs, optimizer specs) of the plan for ``mesh``: the moments
    share the param specs, the step is replicated."""
    plan = plan_model(cfg, shape_cfg, mesh_desc(mesh))
    ma = sspec.mesh_axis_sizes(mesh)
    params_abs, opt_abs = abstract_state
    p_specs = autoshard.param_specs(params_abs, plan, ma)
    return p_specs, type(opt_abs)(step=P(), mu=p_specs, nu=p_specs)


def restore_elastic(ckpt: CheckpointManager, abstract_state, cfg, shape_cfg,
                    mesh, step: Optional[int] = None) -> Tuple[Any, dict]:
    """Restore (params, opt_state) onto ``mesh``, re-planning its layouts
    (under a process group, every rank onto its own device). Returns
    (state, manifest); the manifest's ``"specs"`` holds the (param specs,
    optimizer specs) the re-plan gave."""
    p_specs, o_specs = state_specs(abstract_state, cfg, shape_cfg, mesh)
    state, manifest = ckpt.restore(
        abstract_state, step=step, device=mesh.device,
        shardings=(sspec.tree_named(mesh, p_specs),
                   sspec.tree_named(mesh, o_specs)))
    return state, {**manifest, "specs": (p_specs, o_specs)}
