"""Serving robustness: request outcomes, the guard's policy and the pool
auditor (the port's copy of ``repro.serve.guard``).

With a :class:`GuardConfig` attached, every request the scheduler is given
ends in exactly one :class:`RequestOutcome`:

* ``ok``            completed normally (EOS or budget);
* ``shed``          refused at arrival: measured pool pressure above the
  shed threshold;
* ``expired``       its deadline (arrival + ttl) passed before it finished
  (waiting requests expire unadmitted, active rows keep their partial
  output);
* ``preempted_out`` preempted more than ``retry_budget`` times;
* ``failed``        a fault that is not transient: a decode step failing past
  its retries, non-finite logits on its row, or a pool stall that outlived
  ``stall_budget`` boundaries.

Overload walks the degradation ladder the plan authorises
(``ServePlan.degrade``): requantize the page pool to int8 at the same
footprint (about twice the pages), then clamp new admissions' ``max_new``,
then shed. :func:`audit_pool` checks every ``PageAllocator`` invariant from
its ``snapshot()``; the scheduler runs it after every sync window when
``audit_every_sync`` is set, and on the drained pool at the end of a
guarded run.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

OUTCOMES = ("ok", "shed", "expired", "preempted_out", "failed")


class PoolAuditError(RuntimeError):
    """A pool invariant was violated (leak, refcount drift, stale index)."""


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


@dataclasses.dataclass
class GuardConfig:
    """Robustness policy for the serving loop (the scheduler's ``guard=``).

    ``default_ttl_steps`` (virtual decode steps from arrival) applies to
    requests without their own ``ttl``; None disables deadlines.
    ``retry_budget`` bounds recompute preemptions per request;
    ``stall_budget`` bounds consecutive boundaries the pool may stall with
    nothing left to preempt before the oldest resident request fails.
    ``max_step_retries`` and ``backoff_s`` govern transient decode-step
    faults (``runtime.fault_tolerance.backoff_delay``).

    The pressure thresholds gate the ladder's rungs against measured pool
    utilisation (``PageAllocator.in_use / num_pages``); a rung fires only if
    the plan's ``degrade`` authorises it (further restricted by
    ``degrade_rungs`` when set). ``nan_check`` quarantines rows whose logits
    went non-finite (one more host transfer per boundary);
    ``audit_every_sync`` runs the pool auditor after every sync window and
    raises :class:`PoolAuditError` on a violation.
    """
    default_ttl_steps: Optional[float] = None
    retry_budget: int = 8
    stall_budget: int = 8
    max_step_retries: int = 3
    backoff_s: float = 0.0
    int8_pressure: float = 0.85
    clamp_pressure: float = 0.92
    shed_pressure: float = 0.97
    clamp_max_new: int = 32
    degrade_rungs: Optional[Tuple[str, ...]] = None
    nan_check: bool = False
    audit_every_sync: bool = False


# ---------------------------------------------------------------- auditing
def audit_pool(pager, drained: bool = False, *, tracer=None,
               clock: float = 0.0, slot: int = -1) -> List[str]:
    """Every ``PageAllocator`` invariant; returns the violations (empty when
    clean).

    * the free list: no duplicates, ids in range, disjoint from every block
      table;
    * refcounts: each page's count equals the block-table entries that name
      it, and a count of 0 holds exactly for the pages on the free list;
    * block tables: no page twice in one table, recorded lengths covered;
    * the prefix index: every indexed page resident, the reverse map
      agreeing (both empty while prefix sharing is not ported).

    ``drained=True`` (end of run) also requires the whole pool returned.
    A ``tracer`` records a ``pool_audit`` event only when violations are
    found, so a clean audit leaves the trace unchanged.
    """
    v: List[str] = []
    snap = pager.snapshot()
    num = pager.num_pages
    free, refs = snap["free"], snap["refs"]
    tables, lengths = snap["tables"], snap["lengths"]
    pidx, pkeys = snap["prefix_index"], snap["page_keys"]

    if len(set(free)) != len(free):
        v.append("free list contains duplicate page ids")
    for p in free:
        if not 0 <= p < num:
            v.append(f"free list id {p} out of range [0, {num})")
    held = [0] * num
    for rid, table in tables.items():
        seen = set()
        for p in table:
            if not 0 <= p < num:
                v.append(f"rid {rid}: table page {p} out of range")
                continue
            if p in seen:
                v.append(f"rid {rid}: page {p} appears twice in one "
                         "block table (CoW should have split it)")
            seen.add(p)
            held[p] += 1
    for p in range(num):
        if refs[p] != held[p]:
            v.append(f"page {p}: refcount {refs[p]} != {held[p]} block-table "
                     "references (leak or double-hold)")
    freeset = set(free)
    for p in range(num):
        if refs[p] == 0 and p not in freeset:
            v.append(f"page {p}: refcount 0 but not on the free list "
                     "(leaked page)")
        if refs[p] > 0 and p in freeset:
            v.append(f"page {p}: refcount {refs[p]} but on the free list "
                     "(double-free hazard)")
    for rid, n in lengths.items():
        if rid not in tables:
            v.append(f"rid {rid}: length recorded with no block table")
        elif pager.pages_for(n) > len(tables[rid]):
            v.append(f"rid {rid}: length {n} not covered by "
                     f"{len(tables[rid])} pages")
    for key, p in pidx.items():
        if not 0 <= p < num:
            v.append(f"prefix index entry {key!r} -> page {p} out of range")
        elif refs[p] == 0:
            v.append(f"prefix index entry -> page {p} with refcount 0 "
                     "(dangling: purge-on-release missed it)")
        elif key not in pkeys.get(p, ()):
            v.append(f"prefix key {key!r} missing from page {p}'s "
                     "reverse key list")
    for p, keys in pkeys.items():
        for key in keys:
            if pidx.get(key) != p:
                v.append(f"page {p}: stale reverse key {key!r} "
                         "(index maps it elsewhere)")
    if drained:
        if tables:
            v.append(f"drained pool still holds tables for rids "
                     f"{sorted(tables)}")
        if len(free) != num:
            v.append(f"drained pool has {len(free)}/{num} pages free")
        if any(refs):
            v.append("drained pool has nonzero refcounts: "
                     f"{[p for p in range(num) if refs[p]]}")
        if pidx:
            v.append(f"drained pool retains {len(pidx)} prefix index "
                     "entries")
    if v and tracer is not None:
        tracer.event("pool_audit", clock, cat="pool", slot=slot,
                     violations=len(v))
    return v


def assert_pool_clean(pager, drained: bool = False, *, tracer=None,
                      clock: float = 0.0, slot: int = -1) -> None:
    """Raise :class:`PoolAuditError` listing every violated invariant."""
    violations = audit_pool(pager, drained=drained, tracer=tracer,
                            clock=clock, slot=slot)
    if violations:
        raise PoolAuditError(
            f"pool audit failed ({len(violations)} violation(s)): "
            + "; ".join(violations))
