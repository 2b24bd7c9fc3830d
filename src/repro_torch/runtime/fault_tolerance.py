"""Retry pacing (the port's copy of ``repro.runtime.fault_tolerance``'s
``backoff_delay``; the reference's supervised train loop is not ported)."""
from __future__ import annotations


def backoff_delay(attempt: int, base_s: float) -> float:
    """Exponential backoff: ``base_s * 2**(attempt-1)`` seconds for attempt
    >= 1 (attempts below 1 count as 1). The serving guard paces its
    transient decode-step retries with it."""
    return base_s * (2 ** (max(attempt, 1) - 1))
