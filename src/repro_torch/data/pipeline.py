"""Deterministic synthetic token pipeline with per-host sharding + prefetch
(the port's copy of ``repro.data.pipeline``: numpy only, its batches bit
for bit the reference's).

Design points for the 1000-node posture:
 * **Stateless indexing** — batch ``i`` is a pure function of (seed, i, host),
   so any host can (re)produce any shard: restarts and elastic re-sharding need
   no data-state checkpoint, and a straggler's shard can be re-dispatched to a
   healthy host (runtime.fault_tolerance consumes this property).
 * **Prefetch** — a background thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    num_codebooks: int = 1
    num_patches: int = 0
    d_model: int = 0
    cond_len: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _rng_for(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host]))


def synth_batch(cfg: DataConfig, step: int,
                host: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The batch for (step, host) — pure function, any host can build any shard."""
    host = cfg.host_id if host is None else host
    rng = _rng_for(cfg, step, host)
    B, S = cfg.host_batch, cfg.seq_len
    S_text = S - cfg.num_patches
    if cfg.num_codebooks > 1:
        toks = rng.integers(0, cfg.vocab_size,
                            (B, cfg.num_codebooks, S_text), dtype=np.int32)
        labels = np.concatenate([toks[..., 1:],
                                 np.full((B, cfg.num_codebooks, 1), -1,
                                         np.int32)], axis=-1)
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S_text), dtype=np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((B, 1), -1, np.int32)], axis=-1)
    batch = {"tokens": toks, "labels": labels}
    if cfg.num_patches:
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.cond_len:
        batch["cond"] = rng.standard_normal(
            (B, cfg.cond_len, cfg.d_model)).astype(np.float32) * 0.02
    return batch


class Pipeline:
    """Prefetching iterator over synth batches, resumable from any step."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            b = synth_batch(self.cfg, s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        s, b = self._q.get()
        self.step = s + 1
        return s, b

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def batch_for_arch(arch_cfg, seq_len: int, global_batch: int, step: int,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """Convenience: one host, shapes derived from an ArchConfig."""
    d = DataConfig(
        seq_len=seq_len, global_batch=global_batch,
        vocab_size=arch_cfg.vocab_size, seed=seed,
        num_codebooks=arch_cfg.num_codebooks,
        num_patches=arch_cfg.num_patches if arch_cfg.frontend == "vision" else 0,
        d_model=arch_cfg.d_model,
        cond_len=arch_cfg.cross_attn_cond)
    return synth_batch(d, step)


def replica_rows(batch: Dict, index: int, n: int) -> Dict:
    """Rows [index·B/n, (index+1)·B/n) of every array of ``batch`` (numpy
    or torch): what the reference's ``P(dp)`` on dim 0 gives replica
    ``index`` of n, one host's batch cut across its devices. (Drawing the
    replica's rows with ``host_id`` would give other tokens, so n replicas
    would not train on what one does.)"""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"{rows} batch rows over {n} replicas")
    m = rows // n
    return {k: v[index * m:(index + 1) * m] for k, v in batch.items()}


def to_torch(batch: Dict[str, np.ndarray], device=None) -> Dict:
    """A batch's arrays as tensors on ``device`` (the port's train step
    takes tensors)."""
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
