"""Atomic checkpoints of a train state (the port's copy of
``repro.checkpoint.manager``).

* **Atomic**: state is written to ``step_XXXXXXXX.tmp/`` and renamed to
  ``step_XXXXXXXX/``, so a crash mid-write never corrupts the latest
  checkpoint.
* **The reference's format**: one ``arrays.npz`` of every leaf, keyed by
  its flattened path (entries joined by ``__``: tuple indices, NamedTuple
  field names and dict keys, so ``(params, AdamWState)`` gives ``0__embed``,
  ``1__mu__embed``, ``1__step``), and a ``manifest.json`` of step, time,
  keys, shapes, dtypes and extras. A checkpoint written by either package
  restores in the other.
* **Retention**: the newest ``keep`` checkpoints are kept.
* **Ranks**: under a process group (``sharding.dist``) the state is
  replicated, so rank 0 alone writes it, after a barrier, and the other
  ranks wait for it; every rank restores onto its own device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.bridge import tensor_from_numpy, tensor_to_numpy
from repro_torch.sharding import dist

_SEP = "__"


def _paths(tree, prefix=()):
    """(path, leaf) of every tensor of a tree of tuples, NamedTuples and
    dicts, in ``jax.tree_util``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _rebuild(tree, fn, prefix=()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), fn, prefix + (n,))
                            for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {_SEP.join(p): tensor_to_numpy(leaf) for p, leaf in _paths(tree)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 group: Optional[dist.Group] = None):
        self.directory = directory
        self.keep = keep
        self.group = group
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, extra: Optional[Dict] = None) -> str:
        """Write ``state`` as step ``step``; under a group, rank 0 writes
        once every rank has reached the save, and every rank returns once
        it is written."""
        final = os.path.join(self.directory, f"step_{step:08d}")
        if self.group is None:
            self._write(step, final, state, extra)
        else:
            dist.barrier(self.group)
            if self.group.rank == 0:
                self._write(step, final, state, extra)
            dist.barrier(self.group)
        return final

    def _write(self, step: int, final: str, state: Any,
               extra: Optional[Dict]) -> None:
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(state)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        f_dir = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(f_dir)
        finally:
            os.close(f_dir)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    # ----------------------------------------------------------------- load
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, target: Any, step: Optional[int] = None,
                device=None, shardings=None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``target`` (its values are
        ignored; its leaves may be meta tensors). Each leaf lands on
        ``device``, else on the target leaf's device (the CPU for a meta
        one). ``shardings``: an optional congruent tree of
        ``sharding.specs.Layout`` for the current mesh (an elastic
        re-shard): each leaf still lands whole on the device, the port
        running every shard in one process, after its layout is checked to
        divide it (under a process group each rank restores the whole
        replicated state onto its own device). Raises ``ValueError`` on a
        missing checkpoint, a shape that differs from the target's or a
        layout that does not fit."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise ValueError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = np.load(os.path.join(path, "arrays.npz"))
        layouts = {} if shardings is None else {
            _SEP.join(p): layout for p, layout in _paths(shardings)}

        def load(p, leaf):
            key = _SEP.join(p)
            arr = arrays[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"target {tuple(leaf.shape)}")
            if shardings is not None:
                layouts[key].check(arr.shape)
            dev = device if device is not None else (
                "cpu" if leaf.device.type == "meta" else leaf.device)
            return tensor_from_numpy(arr, dev)

        return _rebuild(target, load), manifest

    # ------------------------------------------------------------------- gc
    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
