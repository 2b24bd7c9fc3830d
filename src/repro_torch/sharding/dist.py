"""Data-parallel process groups: one process a dp replica, each on its own
device (``torch.distributed``).

The reference runs its data axis as the devices of one jitted program
(``jax.jit`` over ``make_local_mesh``'s devices, ``shard_map`` for the
compressed step). The port runs it as processes: rank r is dp replica r of
the mesh, numbered pod-major as the mesh orders its devices, on
``cuda:LOCAL_RANK`` or on the CPU. The backend is NCCL for CUDA tensors
and gloo for the CPU. A caller may name another backend, and only by name:
gloo for ranks that share one card, which NCCL refuses. A backend that
fails to start raises; none is ever put in its place.

:func:`init` makes a rank's :class:`Group` from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) or
from explicit arguments and a store. :func:`spawn` starts the ranks
itself over a ``FileStore`` in a fresh temporary directory (no port to
pick, so concurrent jobs cannot clash), and raises as soon as a rank
fails: the other ranks are stopped then, not left waiting in a
collective until the group times out.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time
import warnings
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 300.0     # a collective that waits longer raises


@dataclasses.dataclass(frozen=True, eq=False)
class Group:
    """This process's place in the default process group: its rank, the
    world, its rank on the host, the backend and its device."""
    rank: int
    world: int
    local_rank: int
    backend: str
    device: torch.device
    _subgroups: Dict = dataclasses.field(default_factory=dict, repr=False)

    def subgroups(self, pod: int, data: int):
        """(the ranks of this rank's pod, the ranks at its data index in
        every pod) on a (pod, data) mesh of ranks numbered pod-major: the
        groups of the hierarchical all-reduce's data and pod stages. Every
        rank creates every group, in one order, the first time any asks
        (``torch.distributed.new_group`` is collective)."""
        key = (pod, data)
        if key not in self._subgroups:
            if pod * data != self.world:
                raise ValueError(f"a (pod {pod}, data {data}) mesh over "
                                 f"{self.world} ranks")
            by_pod = [dist.new_group([p * data + d for d in range(data)])
                      for p in range(pod)]
            by_data = [dist.new_group([p * data + d for p in range(pod)])
                       for d in range(data)]
            p, d = divmod(self.rank, data)
            self._subgroups[key] = (by_pod[p], by_data[d])
        return self._subgroups[key]


def default_backend(device) -> str:
    """NCCL for CUDA tensors, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def in_torchrun() -> bool:
    """Whether torchrun (or another launcher) has set this process's
    rank and world in the environment."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init(rank: Optional[int] = None, world: Optional[int] = None,
         local_rank: Optional[int] = None, *, device="cuda",
         backend: Optional[str] = None, store=None,
         timeout_s: float = GROUP_TIMEOUT_S) -> Group:
    """Join the default process group as ``rank`` of ``world``, taken
    from torchrun's environment where not given (``LOCAL_RANK`` defaults
    to the rank). ``device`` "cuda" means ``cuda:local_rank``; a device
    with an index is used as it is (ranks sharing a card). ``store`` (a
    ``torch.distributed.Store``) meets the peers; without one, torchrun's
    ``env://`` rendezvous. Raises when there is no CUDA device for a CUDA
    rank, or when the group does not form."""
    if rank is None or world is None:
        if not in_torchrun():
            raise ValueError("no rank or world given and none in the "
                             "environment (RANK, WORLD_SIZE: torchrun)")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world = int(os.environ["WORLD_SIZE"]) if world is None else world
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_rank = rank if local_rank is None else local_rank
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a CUDA rank")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or default_backend(dev)
    kw = dict(backend=backend, rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = "env://"
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    return Group(rank=rank, world=world, local_rank=local_rank,
                 backend=backend, device=dev)


def destroy() -> None:
    """Leave the default process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(group: Group) -> None:
    """Wait for every rank (an all-reduce on the rank's device, the same
    call on every backend)."""
    dist.all_reduce(torch.zeros(1, device=group.device))


def any_rank(flag: bool, group: Group) -> bool:
    """Whether ``flag`` holds on any rank (every rank learns the same)."""
    t = torch.tensor([int(flag)], device=group.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def gather_into(out: torch.Tensor, x: torch.Tensor, group=None) -> None:
    """``all_gather_into_tensor``: the ranks' ``x`` concatenated on dim 0
    into ``out``, in rank order."""
    with warnings.catch_warnings():   # renamed *_single in torch 2.13;
        warnings.simplefilter("ignore", FutureWarning)   # 2.11 lacks that
        dist.all_gather_into_tensor(out, x, group=group)


def scatter_sum_into(out: torch.Tensor, x: torch.Tensor, group=None) -> None:
    """``reduce_scatter_tensor``: chunk r of the ranks' summed ``x`` into
    rank r's ``out``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, group=group)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s storage as integers of its element width."""
    kind = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.detach().reshape(-1).view(kind[t.element_size()])


def check_replicated(group: Group, leaves, what: str = "params") -> None:
    """Raise on every rank unless each leaf holds the same bits on every
    rank: a checksum a leaf (the sum of its words), gathered."""
    sums = torch.stack([_bits(t).sum(dtype=torch.int64) for t in leaves])
    every = sums.new_empty((group.world,) + tuple(sums.shape))
    gather_into(every, sums[None])
    differ = (every != every[0]).any(0).nonzero().reshape(-1).tolist()
    if differ:
        raise RuntimeError(f"rank {group.rank}: {what} differ across the "
                           f"{group.world} ranks at leaves {differ}")


# ------------------------------------------------------------------ spawn
def _worker(index: int, fn: Callable, world: int, tmp: str, device: str,
            backend: Optional[str], timeout_s: float, threads: int,
            args: tuple) -> None:
    """Rank ``index`` of :func:`spawn`: join the group, run ``fn``, save
    its result for the parent."""
    if threads:
        torch.set_num_threads(threads)
    group = init(index, world, index, device=device, backend=backend,
                 store=dist.FileStore(os.path.join(tmp, "store"), world),
                 timeout_s=timeout_s)
    out = fn(group, *args)
    torch.save(out, os.path.join(tmp, f"{index}.pt"))
    destroy()


def _stop(processes) -> None:
    for p in processes:
        if p.is_alive():
            p.terminate()
    for p in processes:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def spawn(fn: Callable, world: int, *args, device=None,
          backend: Optional[str] = None, timeout_s: float = GROUP_TIMEOUT_S,
          join_timeout_s: Optional[float] = None) -> List:
    """Run ``fn(group, *args)`` in ``world`` new processes (the ``spawn``
    start method: ``fn`` and ``args`` are pickled, ``fn`` by its import
    path) and return their results in rank order. ``device`` as for
    :func:`init`: "cuda" (a card a rank; the default, which raises when
    there is no CUDA device), one card for every rank, or "cpu". On the
    CPU each rank gets this process's threads over ``world``. A
    collective waits at most ``timeout_s``; the ranks together at most
    ``join_timeout_s`` (None: as long as they run). Raises as soon as a
    rank raises or dies, stopping the others."""
    import torch.multiprocessing as mp
    # the serving engine's rule for every entry point (imported here:
    # the engine's imports reach this module)
    from repro_torch.serve.engine import resolve_device
    device = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="repro-dist-")
    threads = (max(1, torch.get_num_threads() // world)
               if torch.device(device).type == "cpu" else 0)
    ctx = None
    try:
        ctx = mp.start_processes(
            _worker, args=(fn, world, tmp, str(device), backend, timeout_s,
                           threads, args),
            nprocs=world, join=False, daemon=True, start_method="spawn")
        deadline = (None if join_timeout_s is None
                    else time.monotonic() + join_timeout_s)
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{join_timeout_s} s")
        return [torch.load(os.path.join(tmp, f"{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        if ctx is not None:
            _stop(ctx.processes)
        shutil.rmtree(tmp, ignore_errors=True)
