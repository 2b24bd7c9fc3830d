"""The training mesh: (pod, data, model) axes over the devices there are.

:class:`TrainMesh` is the port's counterpart of the reference's
``jax.sharding.Mesh`` for training. Without a process group it is
logical, as sharded serving's ``serve.shard.ServeMesh`` is: the port runs
every shard of a step in one process, on one device (``device``), shard
after shard, so a data=2, model=4 mesh trains on one card. Under a group
(``sharding.dist``) each dp replica is a process with its own device:
rank r is replica r (``dp_index``, pod-major), and the model axis stays
logical inside each rank. ``make_local_mesh`` and ``mesh_desc`` are the
port's copies of the reference's ``launch.mesh.make_local_mesh`` and
``launch.cell.mesh_desc`` (whose modules lower XLA programs and stay
JAX-only); tests, examples and ``chip_smoke.py`` build a larger logical
mesh directly, as the reference's tests force eight host devices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.planner import MeshDesc
from repro_torch.sharding.dist import Group


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    data: int = 1
    model: int = 1
    pod: int = 1
    device: str = "cuda"
    group: Optional[Group] = None    # one process a dp replica

    def __post_init__(self):
        if min(self.pod, self.data, self.model) < 1:
            raise ValueError(f"axis sizes must be >= 1: {self}")
        if self.group is not None and self.group.world != self.dp:
            raise ValueError(f"{self.dp} dp replicas over "
                             f"{self.group.world} ranks")

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """("data", "model"), with "pod" first on a multi-pod mesh (the
        reference's ``make_production_mesh`` axes)."""
        return (("pod",) if self.pod > 1 else ()) + ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (((self.pod,) if self.pod > 1 else ())
                + (self.data, self.model))

    @property
    def size(self) -> int:
        """Devices in the mesh (the reference's ``mesh.devices.size``)."""
        return self.pod * self.data * self.model

    @property
    def dp(self) -> int:
        return self.pod * self.data

    @property
    def dp_index(self) -> int:
        """This process's dp replica: its rank under a group, else 0."""
        return 0 if self.group is None else self.group.rank

    @property
    def backed(self) -> bool:
        """Whether every dp replica runs in a process of its own: one a
        rank under ``group``, or the one replica of a mesh without a data
        axis in this process (never on ``meta``, which computes
        nothing)."""
        if torch.device(self.device).type == "meta":
            return False
        return self.group is not None or self.dp == 1


def make_local_mesh(model: int = 1, device: str = "cuda",
                    group: Optional[Group] = None) -> TrainMesh:
    """A mesh over the devices there are (one CPU, or the CUDA cards):
    data = devices // model. One H100 gives data=1, model=1. Under
    ``group`` the devices are the ranks' (one each), on this rank's own
    device: data = world // model, where the model axis, not placed
    across cards yet, must be 1."""
    if group is not None:
        if model != 1:
            raise ValueError(f"a model axis of {model} across ranks: each "
                             "rank is one dp replica")
        return TrainMesh(data=group.world, device=str(group.device),
                         group=group)
    n = torch.cuda.device_count() if device == "cuda" else 1
    if n < 1 or n % model:
        raise ValueError(f"{n} {device} device(s) for a model axis of "
                         f"{model}")
    return TrainMesh(data=n // model, model=model,
                     device=torch.device(device).type)


def mesh_desc(mesh: TrainMesh) -> MeshDesc:
    return MeshDesc(pod=mesh.pod, data=mesh.data, model=mesh.model)
