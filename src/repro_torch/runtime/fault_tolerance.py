"""Retry pacing and straggler detection (the port's copy of
``repro.runtime.fault_tolerance``'s ``backoff_delay`` and
``StragglerDetector``; the reference's supervised train loop is not
ported)."""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def backoff_delay(attempt: int, base_s: float) -> float:
    """Exponential backoff: ``base_s * 2**(attempt-1)`` seconds for attempt
    >= 1 (attempts below 1 count as 1). The serving guard paces its
    transient decode-step retries with it, and the fleet its migrations."""
    return base_s * (2 ** (max(attempt, 1) - 1))


class StragglerDetector:
    """Median-based straggler detector (the fleet's heartbeat audit,
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
