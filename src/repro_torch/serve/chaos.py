"""Seeded fault injection for the serving loop (the port's copy of
``repro.serve.chaos``; the fleet's ``ReplicaChaosConfig`` is not ported).

Three fault classes the guarded scheduler must absorb, all driven by a fixed
seed so a chaos run is reproducible and, for the same seed, schedules the
same faults as the reference's injector:

* page ``ensure`` failures: ``ensure_fails`` makes an allocation probe report
  pressure even when pages are free (capped by ``ensure_fail_max`` so a run
  always ends);
* transient step failures: ``check_step`` raises :class:`InjectedFault` for
  the first ``step_fail_attempts`` attempts of each listed chunk, before the
  chunk's device work and before any sampler draw, so a retry replays
  nothing and survivors' streams stay bit-identical to a fault-free run;
* NaN logits: ``nan_rids_for`` names the requests whose next-token logits are
  poisoned before a given chunk; the guard's NaN sweep must quarantine
  exactly those rows.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """A deterministic injected fault, transient and safe to retry."""


@dataclasses.dataclass
class ChaosConfig:
    """One seeded fault schedule (``scheduler.run(..., chaos=)``).

    ``ensure_fail_rate`` is the per-probe probability of a spurious
    allocation failure, capped at ``ensure_fail_max`` injections;
    ``step_fail_chunks`` lists decode-chunk indices whose first
    ``step_fail_attempts`` attempts raise; ``nan_rids`` maps a chunk index
    to the rids whose logits are poisoned before that chunk.
    """
    seed: int = 0
    ensure_fail_rate: float = 0.0
    ensure_fail_max: int = 64
    step_fail_chunks: Tuple[int, ...] = ()
    step_fail_attempts: int = 1
    nan_rids: Dict[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)


class FaultInjector:
    """Stateful executor of one :class:`ChaosConfig` (one run's faults).
    ``injected`` counts the faults delivered per class; ``on_inject(kind,
    rid)``, when set, is called at every delivery (the scheduler traces
    them)."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)
        self._step_attempts: Dict[int, int] = {}
        self._nan_pending = {k: tuple(v) for k, v in cfg.nan_rids.items()}
        self.injected = {"ensure": 0, "step": 0, "nan": 0}
        self.on_inject = None

    def _notify(self, kind: str, rid: int = -1) -> None:
        if self.on_inject is not None:
            self.on_inject(kind, rid)

    def ensure_fails(self, rid: int, n_tokens: int) -> bool:
        """Should this allocation probe spuriously report page pressure?"""
        if self.cfg.ensure_fail_rate <= 0.0 \
                or self.injected["ensure"] >= self.cfg.ensure_fail_max:
            return False
        if self._rng.random() < self.cfg.ensure_fail_rate:
            self.injected["ensure"] += 1
            self._notify("ensure", rid)
            return True
        return False

    def check_step(self, chunk_index: int) -> None:
        """Raise :class:`InjectedFault` while this chunk's failure budget
        lasts; pass once it is spent (the retry then succeeds)."""
        if chunk_index not in self.cfg.step_fail_chunks:
            return
        attempts = self._step_attempts.get(chunk_index, 0)
        if attempts >= self.cfg.step_fail_attempts:
            return
        self._step_attempts[chunk_index] = attempts + 1
        self.injected["step"] += 1
        self._notify("step")
        raise InjectedFault(
            f"injected step failure (chunk {chunk_index}, "
            f"attempt {attempts + 1})")

    def nan_rids_for(self, chunk_index: int) -> Tuple[int, ...]:
        """Rids whose pre-chunk logits are to be poisoned with NaN; fires at
        most once per chunk index (a boundary whose chunk is then skipped
        must not poison again)."""
        rids = self._nan_pending.pop(chunk_index, ())
        if rids:
            self.injected["nan"] += len(rids)
            for rid in rids:
                self._notify("nan", rid)
        return rids
