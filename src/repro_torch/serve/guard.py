"""Request outcomes (the part of ``repro.serve.guard`` the port serves with).

Only :class:`RequestOutcome` is here: the drain engine (``serve.engine.
DecodeEngine``) stamps ``RequestOutcome("ok")`` on every request it
finishes. The rest of the reference's guard (``GuardConfig``, deadlines,
the degradation ladder, ``audit_pool``) is not ported yet, and ``LLM``
refuses ``guard=True``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

OUTCOMES = ("ok", "shed", "expired", "preempted_out", "failed")


@dataclasses.dataclass(frozen=True)
class RequestOutcome:
    """Terminal status of one request. ``at_step`` is the scheduler's
    virtual clock when the request resolved; ``degraded`` lists the ladder
    rungs applied to it."""
    status: str
    reason: str = ""
    at_step: float = 0.0
    degraded: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.status not in OUTCOMES:
            raise ValueError(f"status must be one of {OUTCOMES}, got "
                             f"{self.status!r}")

    @property
    def ok(self) -> bool:
        return self.status == "ok"
