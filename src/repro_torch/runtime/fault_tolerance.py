"""Fault tolerance: the supervised train loop with checkpoint/restart,
heartbeat and straggler detection, and the retry pacing serving shares
(the port's copy of ``repro.runtime.fault_tolerance``).

The :class:`Supervisor` drives a step function over a stateless-indexable
data function: periodic checkpoints (``checkpoint.CheckpointManager``), a
retry budget with exponential backoff (a failed step restarts from the
last durable checkpoint), straggler detection against the running median
(``on_straggler`` when persistent) and a heartbeat file in the telemetry
schema. Failure injection (``failure_injector(step, attempt)``) is for
tests. Under a process group (``sharding.dist``: one rank a dp replica)
rank 0 alone writes checkpoints and the heartbeat, and only a failure
before the step is retried, collectively: one injected on any rank fails
the attempt on every rank, and every rank restores the same checkpoint. A
failure inside the step is raised on its rank with no retry: its peers
wait in the step's collectives, which no retry would match, so the job
ends (``dist.spawn`` and torchrun stop the other ranks) and a restart
resumes from rank 0's last checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.sharding import dist


def backoff_delay(attempt: int, base_s: float) -> float:
    """Exponential backoff: ``base_s * 2**(attempt-1)`` seconds for attempt
    >= 1 (attempts below 1 count as 1). The train loop's Supervisor paces
    its retries with it, the serving guard its transient decode-step
    retries, and the fleet its migrations."""
    return base_s * (2 ** (max(attempt, 1) - 1))


@dataclasses.dataclass
class FaultToleranceConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    keep: int = 3
    max_retries: int = 3
    backoff_s: float = 0.1
    straggler_factor: float = 3.0
    straggler_patience: int = 3
    heartbeat_path: Optional[str] = None


class StragglerDetector:
    """Median-based straggler detector (the train loop's
    :class:`Supervisor` and the fleet's heartbeat audit,
    ``serve.replica.ReplicaSupervisor``).

    ``observe(step, dt)`` flags ``dt`` once it exceeds ``factor`` times the
    median of the last 50 observations (after 5 of them); each flag is a
    strike, each unflagged observation takes one back, and ``persistent``
    holds from ``patience`` strikes on. A replica restarts its local step
    counter at a plan swap, so ``step`` may move backwards: that starts a
    fresh epoch (strikes cleared, the history kept, since step durations
    stay comparable across restarts). ``reset`` drops everything."""

    def __init__(self, factor: float, patience: int):
        self.factor = factor
        self.patience = patience
        self.times: List[float] = []
        self.strikes = 0
        self.events: List[Dict] = []
        self.last_step: Optional[int] = None

    def reset(self) -> None:
        """Forget all observations (history, strikes, events, epoch)."""
        self.times.clear()
        self.strikes = 0
        self.events.clear()
        self.last_step = None

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        if self.last_step is not None and step < self.last_step:
            self.strikes = 0              # a restarted step clock
        self.last_step = step
        dt = max(dt, 0.0)
        flagged = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-50:])
            if dt > self.factor * med:
                flagged = True
                self.strikes += 1
                self.events.append({"step": step, "dt": dt, "median": med})
            else:
                self.strikes = max(self.strikes - 1, 0)
        self.times.append(dt)
        return flagged

    @property
    def persistent(self) -> bool:
        return self.strikes >= self.patience


class Supervisor:
    """Drives (step_fn, data_fn) with checkpoint/restart and the straggler
    policy.

    step_fn(state, batch) -> (state, metrics); data_fn(step) -> batch,
    stateless-indexable (``data.pipeline`` is). The port's train step
    updates the state in place, so a failed step leaves no durable state
    behind it: a retry restores the last checkpoint into a fresh
    ``init_state_fn()`` (or starts from that when there is none), as the
    reference's does. Under ``group`` every rank runs the loop with its
    own step and state; an exception from ``step_fn`` is raised as it is
    (the module's docstring says why)."""

    def __init__(self, cfg: FaultToleranceConfig, step_fn: Callable,
                 data_fn: Callable, init_state_fn: Callable,
                 on_straggler: Optional[Callable] = None,
                 failure_injector: Optional[Callable] = None,
                 group: Optional[dist.Group] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.init_state_fn = init_state_fn
        self.on_straggler = on_straggler or (lambda det: None)
        self.failure_injector = failure_injector
        self.group = group
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep,
                                      group=group)
        self.detector = StragglerDetector(cfg.straggler_factor,
                                          cfg.straggler_patience)
        self.restarts = 0
        # the heartbeat's clocks, injectable so tests control both readings
        self.wall_clock: Callable[[], float] = time.time
        self.mono_clock: Callable[[], float] = time.monotonic

    # -------------------------------------------------------------- plumbing
    def _heartbeat(self, step: int):
        if self.cfg.heartbeat_path and (self.group is None
                                        or self.group.rank == 0):
            # the serving telemetry's schema; imported here, since the
            # serving side imports this module (backoff_delay)
            from repro_torch.serve.telemetry import heartbeat_record
            with open(self.cfg.heartbeat_path, "w") as f:
                json.dump(heartbeat_record(
                    step, wall_time=self.wall_clock(),
                    mono_s=self.mono_clock(), restarts=self.restarts), f)

    def _inject(self, step: int, attempt: int):
        """Run the failure injector; under a group, fail on every rank
        when it failed on any (before the step, whose collectives a rank
        that skipped them would leave waiting)."""
        err = None
        if self.failure_injector is not None:
            try:
                self.failure_injector(step, attempt)
            except Exception as e:  # noqa: BLE001 (re-raised below)
                err = e
        if self.group is not None and dist.any_rank(err is not None,
                                                     self.group):
            raise err or RuntimeError(f"step {step}: a peer rank failed")
        if err is not None:
            raise err

    def _restore_or_init(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0, self.init_state_fn()
        restored, _ = self.ckpt.restore(self.init_state_fn(), step=latest)
        return latest + 1, restored

    # ------------------------------------------------------------------ run
    def run(self, num_steps: int) -> Dict[str, Any]:
        start, state = self._restore_or_init()
        metrics_log: List[Dict] = []
        step = start
        while step < num_steps:
            batch = self.data_fn(step)
            attempt = 0
            while True:
                in_step = False
                try:
                    self._inject(step, attempt)
                    in_step = True
                    t0 = time.monotonic()
                    state, metrics = self.step_fn(state, batch)
                    dt = time.monotonic() - t0
                    break
                except Exception as e:  # noqa: BLE001 (a node failure)
                    if in_step and self.group is not None:
                        raise       # the peers wait in its collectives
                    attempt += 1
                    self.restarts += 1
                    if attempt > self.cfg.max_retries:
                        raise RuntimeError(
                            f"step {step}: retry budget exhausted") from e
                    time.sleep(backoff_delay(attempt, self.cfg.backoff_s))
                    step, state = self._restore_or_init()
                    batch = self.data_fn(step)
            if self.detector.observe(step, dt) and self.detector.persistent:
                self.on_straggler(self.detector)
            metrics_log.append({"step": step, **{k: float(v) for k, v in
                                                 metrics.items()}})
            if (step + 1) % self.cfg.checkpoint_every == 0 or \
                    step == num_steps - 1:
                self.ckpt.save(step, state)
            self._heartbeat(step)
            step += 1
        return {"metrics": metrics_log, "restarts": self.restarts,
                "straggler_events": self.detector.events,
                "final_step": step - 1}
