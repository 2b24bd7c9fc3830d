"""The dry-run's meshes (the port's copy of ``repro.launch.mesh``).

``pod`` is the paper's inter-cluster 2D-mesh level; (``data``, ``model``)
are the axes within a pod. The reference builds these meshes over 256 or
512 forced host devices; the port's are logical ``sharding.mesh.
TrainMesh``es on the ``meta`` device, which need no device at all
(``backed`` is False): a cell built on one says how each tensor would be
cut, and ``launch.dryrun`` counts its per-device bytes from that.
``make_local_mesh`` and ``mesh_desc`` live in ``sharding.mesh`` and are
re-exported here.
"""
from __future__ import annotations

from repro_torch.sharding.mesh import TrainMesh, make_local_mesh, mesh_desc

__all__ = ["make_production_mesh", "make_scaled_mesh", "make_local_mesh",
           "mesh_desc"]


def make_production_mesh(*, multi_pod: bool = False) -> TrainMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16)."""
    return TrainMesh(data=16, model=16, pod=2 if multi_pod else 1,
                     device="meta")


def make_scaled_mesh(chips: int, *, model: int = 16,
                     pods: int = 1) -> TrainMesh:
    """A mesh of ``chips`` devices at any scale (the Fig. 14 strong-scaling
    study): ``pods`` pods of (chips // pods // model, model)."""
    per_pod = chips // pods
    if per_pod % model:
        raise ValueError(f"{chips} chips in {pods} pod(s) do not divide "
                         f"into a model axis of {model}")
    return TrainMesh(data=per_pod // model, model=model, pod=pods,
                     device="meta")
