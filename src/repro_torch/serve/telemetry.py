"""Step-clock tracing, the metrics registry and plan drift (the port's copy
of ``repro.serve.telemetry``).

Host-only and deterministic by construction, as in the reference:

* :class:`Tracer` records typed spans and events keyed by ``(clock,
  replica_slot, rid)`` on the scheduler's virtual step clock. Wall-clock
  durations ride along as annotations (``wall_s``) that
  :meth:`Tracer.signature` and ``to_chrome_trace(strip_wall=True)`` drop,
  so two same-seed runs, chaos runs included, give byte-identical traces,
  and the port's signature of a run equals the reference's for the same
  requests. ``to_chrome_trace()`` exports Chrome ``trace_event`` JSON (one
  virtual step renders as 1 ms).
* :class:`MetricsRegistry` keeps counters, gauges and histograms over the
  frozen key set :data:`METRIC_KEYS` (an undeclared name raises); gauges are
  archived once per sync window (``end_window``), the measurement side of
  drift detection.
* :func:`detect_drift` compares measured proxies (resident tokens per row,
  the per-step HBM byte estimate at measured occupancy, forced requants, the
  MLP route at the measured decode width, prefill pad waste) with the
  plan's ``Decision.numbers`` and names every decision whose measured value
  left its band.

:func:`phase_timer` is the one wall-clock phase-timing pattern;
``PhaseHandle.ready(tensor)`` makes it wait for the tensor's device work
before the clock stops (an event recorded on the current stream after the
work, then synchronized; nothing on the CPU). :func:`heartbeat_record` is
the shared heartbeat schema.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

SCHEMA = "repro.telemetry/v1"

# ---------------------------------------------------------------- tracing
# Span/event categories:
#   request — queued / admitted / outcome instants, per-rid
#   phase   — prefill / decode_chunk spans (wall_s annotated)
#   pool    — preempt / cow_copy / stall / pool_audit
#   degrade — degrade_rung (int8_kv requant, clamp_max_new)
#   chaos   — step_retry and other injected-fault absorptions
#   window  — fleet window stages: dispatch / tick / failover / migrate /
#             scale_up / scale_down / replan
#   spec    — speculative decode rounds: spec_chunk (drafted/accepted per
#             dispatch window)
#   collective — mesh traffic: per-chunk all-gather accounting
#             on sharded plans (serve.shard.chunk_collectives)
CATEGORIES = ("request", "phase", "pool", "degrade", "chaos", "window",
              "event", "spec", "collective")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One trace record. ``dur == 0`` renders as an instant event.

    Every field except ``wall_s`` is deterministic given the seed;
    ``wall_s`` is the wall-clock annotation and is the ONLY field stripped
    for trace-identity comparisons.
    """
    name: str
    cat: str
    clock: float                 # virtual-step stamp (span start)
    dur: float = 0.0             # virtual-step duration (0: instant)
    slot: int = -1               # replica slot (-1: single scheduler/fleet)
    rid: int = -1                # request id (-1: not request-scoped)
    args: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    wall_s: Optional[float] = None   # annotation — never part of identity

    def key(self) -> Tuple[float, int, int]:
        return (self.clock, self.slot, self.rid)


class Tracer:
    """Deterministic span/event recorder on the virtual step clock."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.events: List[TraceEvent] = []

    def reset(self) -> None:
        self.events.clear()

    def event(self, name: str, clock: float, *, cat: str = "event",
              slot: int = -1, rid: int = -1, wall_s: Optional[float] = None,
              **args) -> None:
        """Record an instant event at ``clock``."""
        self.span(name, clock, clock, cat=cat, slot=slot, rid=rid,
                  wall_s=wall_s, **args)

    def span(self, name: str, start: float, end: float, *, cat: str = "event",
             slot: int = -1, rid: int = -1, wall_s: Optional[float] = None,
             **args) -> None:
        """Record a complete span over ``[start, end]`` virtual steps."""
        if not self.enabled:
            return
        self.events.append(TraceEvent(
            name=name, cat=cat, clock=float(start),
            dur=float(end) - float(start), slot=int(slot), rid=int(rid),
            args=dict(args), wall_s=wall_s))

    # ------------------------------------------------------------- exports
    def signature(self) -> str:
        """Canonical JSON of the trace with wall-time annotations stripped
        — the bit-identity surface the determinism tests/gates compare."""
        return json.dumps(
            [{"name": e.name, "cat": e.cat, "clock": e.clock, "dur": e.dur,
              "slot": e.slot, "rid": e.rid, "args": e.args}
             for e in self.events],
            sort_keys=True, separators=(",", ":"))

    def to_chrome_trace(self, strip_wall: bool = False) -> Dict:
        """Chrome ``trace_event`` JSON (Perfetto-loadable).

        Mapping: 1 virtual step -> 1000 µs (1 ms), pid = replica slot + 1
        (pid 0 is the single scheduler / fleet control plane), tid = rid + 1
        (tid 0 is the window lane). Wall-clock annotations ride in
        ``args.wall_s`` unless ``strip_wall`` — with it stripped the JSON is
        byte-identical across same-seed runs.
        """
        evs: List[Dict] = []
        pids = {}
        for e in self.events:
            pid = e.slot + 1
            if pid not in pids:
                pids[pid] = ("scheduler" if pid == 0
                             else f"replica {e.slot}")
            tid = e.rid + 1
            args = dict(e.args)
            if e.wall_s is not None and not strip_wall:
                args["wall_s"] = e.wall_s
            rec = {"name": e.name, "cat": e.cat, "pid": pid, "tid": tid,
                   "ts": round(e.clock * 1000.0, 3), "args": args}
            if e.dur > 0:
                rec["ph"] = "X"
                rec["dur"] = round(e.dur * 1000.0, 3)
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            evs.append(rec)
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": label}}
                for pid, label in sorted(pids.items())]
        return {"traceEvents": meta + evs, "displayTimeUnit": "ms",
                "otherData": {"schema": SCHEMA,
                              "clock": "virtual decode steps (1 step = 1ms)"}}


# ------------------------------------------------------------ phase timing
def _wait_for(x: torch.Tensor) -> None:
    """Block until the work queued so far on ``x``'s device (current
    stream) is done: an event recorded after it, then synchronized. The
    rest of the card is not waited for; on the CPU there is nothing to
    wait for."""
    if x.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
        ev.synchronize()


class PhaseHandle:
    """Yielded by :func:`phase_timer`. ``ready(x)`` registers a tensor whose
    device work the timer waits for before the clock stops (phase-accurate
    timing of asynchronous launches); ``note(**kw)`` attaches deterministic
    args to the span."""

    def __init__(self):
        self.elapsed_s = 0.0
        self._sync = None
        self._args: Dict[str, Any] = {}

    def ready(self, x):
        self._sync = x
        return x

    def note(self, **kw) -> None:
        self._args.update(kw)


@contextlib.contextmanager
def phase_timer(sink: Optional[Dict], key: Optional[str], *,
                tracer: Optional[Tracer] = None, name: Optional[str] = None,
                cat: str = "phase", start: float = 0.0,
                end: Optional[float] = None, slot: int = -1, rid: int = -1):
    """The one wall-clock phase-timing pattern: accumulates elapsed wall
    seconds into ``sink[key]`` (when given) and, when a tracer is attached,
    records a span named ``name or key`` over ``[start, end]`` virtual steps
    with the wall time as an annotation. Call ``handle.ready(tensor)``
    inside the block to make the timer wait for that tensor's device work
    before stopping the clock.
    """
    h = PhaseHandle()
    t0 = time.perf_counter()
    try:
        yield h
    finally:
        if h._sync is not None:
            _wait_for(h._sync)
        h.elapsed_s = time.perf_counter() - t0
        if sink is not None and key:
            sink[key] = sink.get(key, 0.0) + h.elapsed_s
        if tracer is not None:
            tracer.span(name or key or "phase", start,
                        start if end is None else end, cat=cat, slot=slot,
                        rid=rid, wall_s=h.elapsed_s, **h._args)


class RunClock:
    """Wall clock for a whole run: started at construction, read via :meth:`elapsed_s` for ``finished_wall_s`` /
    ``total_wall_s`` stamps — annotations, never part of trace identity."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed_s(self) -> float:
        return time.perf_counter() - self.t0


# --------------------------------------------------------------- heartbeat
HEARTBEAT_SCHEMA = "repro.telemetry/heartbeat-v1"


def heartbeat_record(step: int, *, wall_time: Optional[float] = None,
                     mono_s: Optional[float] = None, restarts: int = 0,
                     **extra) -> Dict:
    """The one heartbeat schema (shared with trace annotations): a monotonic
    reading (``mono_s``, immune to wall-clock jumps) PLUS wall time, both
    injectable so tests control them. Extra keys ride along verbatim."""
    rec = {"schema": HEARTBEAT_SCHEMA, "step": int(step),
           "wall_time": time.time() if wall_time is None else float(wall_time),
           "mono_s": time.monotonic() if mono_s is None else float(mono_s),
           "restarts": int(restarts)}
    rec.update(extra)
    return rec


# ---------------------------------------------------------- metric registry
# THE frozen key set, equal to the reference's: adding or removing a
# metric is an API change of both packages. MetricsRegistry raises KeyError on any undeclared name, so the
# set cannot drift silently.
COUNTER_KEYS: Tuple[str, ...] = (
    # request lifecycle
    "requests_queued", "requests_admitted", "tokens_emitted",
    # terminal outcomes (mirrors serve.guard.OUTCOMES)
    "ok", "shed", "expired", "preempted_out", "failed",
    # prefill / decode work
    "prefill_batches", "prefill_prompts", "prefill_real_tokens",
    "prefill_padded_tokens", "decode_chunks", "decode_steps",
    # pool / degradation / chaos events
    "preemptions", "cow_copies", "shared_tokens_admitted",
    "requant_events", "clamped_admissions", "stalled_boundaries",
    "step_retries",
    # fleet control plane
    "migrations", "failovers", "scale_ups", "scale_downs", "replans",
    # speculative decode: acceptance rate =
    # spec_accepted_tokens / spec_drafted_tokens
    "spec_rounds", "spec_drafted_tokens", "spec_accepted_tokens",
    # mesh collectives: analytic all-gather accounting on
    # sharded plans (serve.shard.chunk_collectives); zero on tp=ep=1
    "collective_ops", "collective_allgather_bytes",
)
GAUGE_KEYS: Tuple[str, ...] = (
    "clock", "queue_pending", "queue_waiting", "active_rows",
    "pool_pressure", "pages_used", "pages_free", "shared_page_ratio",
    "resident_tokens",
    # shard-tagged pool gauges: per-device occupancy spread and
    # the lockstep-divergence count of the sharded page pool
    "shard_pages_used_max", "shard_pages_used_min",
    "shard_lockstep_divergence",
)
HISTOGRAM_KEYS: Tuple[str, ...] = (
    "admission_wait_steps", "ttft_steps", "e2e_latency_steps",
    "finished_len_tokens", "generated_tokens",
)
# per-tenant sub-registry keys (satellite: p50/p99 admission wait + goodput)
TENANT_COUNTER_KEYS: Tuple[str, ...] = ("ok_requests", "ok_tokens")
TENANT_HISTOGRAM_KEYS: Tuple[str, ...] = ("admission_wait_steps",)

METRIC_KEYS = frozenset(COUNTER_KEYS) | frozenset(GAUGE_KEYS) \
    | frozenset(HISTOGRAM_KEYS)
assert len(METRIC_KEYS) == len(COUNTER_KEYS) + len(GAUGE_KEYS) \
    + len(HISTOGRAM_KEYS), "metric names must be unique across kinds"


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    rank = max(int(math.ceil(q / 100.0 * len(sorted_vals))), 1)
    return float(sorted_vals[min(rank, len(sorted_vals)) - 1])


def _hist_summary(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                "mean": 0.0, "p50": 0.0, "p99": 0.0}
    sv = sorted(values)
    total = float(sum(sv))
    return {"count": len(sv), "sum": total, "min": float(sv[0]),
            "max": float(sv[-1]), "mean": total / len(sv),
            "p50": _percentile(sv, 50.0), "p99": _percentile(sv, 99.0)}


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """One frozen view of the registry: full counter/gauge maps plus
    histogram and per-tenant summaries. ``key_set()`` must equal
    :data:`METRIC_KEYS` — the drift test pins it."""
    clock: float
    counters: Mapping[str, float]
    gauges: Mapping[str, float]
    histograms: Mapping[str, Mapping[str, float]]
    tenants: Mapping[str, Mapping[str, float]]

    def key_set(self) -> frozenset:
        return frozenset(self.counters) | frozenset(self.gauges) \
            | frozenset(self.histograms)

    def as_dict(self) -> Dict:
        return {"clock": self.clock, "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": {k: dict(v)
                               for k, v in self.histograms.items()},
                "tenants": {k: dict(v) for k, v in self.tenants.items()}}


class MetricsRegistry:
    """Counters/gauges/histograms over the frozen key set, snapshotted per
    sync window. ``windows`` holds one gauge snapshot per decode boundary
    (tagged with clock + replica slot) — the measured-occupancy history
    :func:`detect_drift` consumes."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.hists: Dict[str, List[float]] = {}
        self.tenants: Dict[str, Dict] = {}
        self.windows: List[Dict] = []
        self.reset()

    def reset(self) -> None:
        self.counters = {k: 0 for k in COUNTER_KEYS}
        self.gauges = {k: 0.0 for k in GAUGE_KEYS}
        self.hists = {k: [] for k in HISTOGRAM_KEYS}
        self.tenants = {}
        self.windows = []

    # ------------------------------------------------------------- writers
    def count(self, key: str, n: float = 1) -> None:
        if key not in self.counters:
            raise KeyError(f"undeclared counter {key!r} — the metric key "
                           "set is frozen (telemetry.COUNTER_KEYS)")
        self.counters[key] += n

    def gauge(self, key: str, value: float) -> None:
        if key not in self.gauges:
            raise KeyError(f"undeclared gauge {key!r} — the metric key set "
                           "is frozen (telemetry.GAUGE_KEYS)")
        self.gauges[key] = float(value)

    def observe(self, key: str, value: float) -> None:
        if key not in self.hists:
            raise KeyError(f"undeclared histogram {key!r} — the metric key "
                           "set is frozen (telemetry.HISTOGRAM_KEYS)")
        self.hists[key].append(float(value))

    def _tenant(self, tenant: Optional[str]) -> Dict:
        t = tenant if tenant is not None else "default"
        if t not in self.tenants:
            self.tenants[t] = {
                **{k: 0 for k in TENANT_COUNTER_KEYS},
                **{k: [] for k in TENANT_HISTOGRAM_KEYS}}
        return self.tenants[t]

    def tenant_count(self, tenant: Optional[str], key: str,
                     n: float = 1) -> None:
        if key not in TENANT_COUNTER_KEYS:
            raise KeyError(f"undeclared tenant counter {key!r}")
        self._tenant(tenant)[key] += n

    def tenant_observe(self, tenant: Optional[str], key: str,
                       value: float) -> None:
        if key not in TENANT_HISTOGRAM_KEYS:
            raise KeyError(f"undeclared tenant histogram {key!r}")
        self._tenant(tenant)[key].append(float(value))

    def end_window(self, clock: float, slot: int = -1) -> None:
        """Close one sync window: archive the current gauges (the drift
        detector's per-window measurement record)."""
        self.gauges["clock"] = float(clock)
        self.windows.append({"clock": float(clock), "slot": int(slot),
                             **self.gauges})

    # ------------------------------------------------------------- readers
    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant goodput + admission-wait percentiles, in steps —
        the measurement half of SLO-aware scheduling."""
        out: Dict[str, Dict[str, float]] = {}
        for t in sorted(self.tenants):
            rec = self.tenants[t]
            waits = _hist_summary(rec["admission_wait_steps"])
            out[t] = {"ok_requests": rec["ok_requests"],
                      "goodput_tokens": rec["ok_tokens"],
                      "admission_wait_p50_steps": waits["p50"],
                      "admission_wait_p99_steps": waits["p99"],
                      "admission_wait_mean_steps": waits["mean"]}
        return out

    def snapshot(self, clock: Optional[float] = None) -> MetricsSnapshot:
        return MetricsSnapshot(
            clock=float(self.gauges["clock"] if clock is None else clock),
            counters=dict(self.counters), gauges=dict(self.gauges),
            histograms={k: _hist_summary(v) for k, v in self.hists.items()},
            tenants=self.tenant_summary())


# ------------------------------------------------------------------- bundle
class Telemetry:
    """The bundle one serving entry point owns: a tracer + a metrics
    registry (+ the last drift report). Shared across a ReplicaSet's
    schedulers (each tags its slot); the facade resets it per call."""

    def __init__(self, enabled: bool = True):
        self.tracer = Tracer(enabled=enabled)
        self.metrics = MetricsRegistry()
        self.last_drift: Optional[DriftReport] = None

    def reset(self) -> None:
        self.tracer.reset()
        self.metrics.reset()
        self.last_drift = None

    def detect_drift(self, plan, threshold: float = 0.5) -> "DriftReport":
        self.last_drift = detect_drift(plan, self.metrics,
                                       threshold=threshold)
        return self.last_drift


# ------------------------------------------------------------ drift report
CONFIRMED = "CONFIRMED"
WITHIN = "within"


@dataclasses.dataclass(frozen=True)
class DriftFinding:
    """One measured-vs-predicted comparison against a plan Decision."""
    decision: str        # Decision.name ("attention", "capacity", ...)
    metric: str
    predicted: float
    measured: float
    ratio: float         # measured / predicted
    threshold: float     # relative divergence that flips the verdict
    verdict: str         # CONFIRMED | within
    why: str

    @property
    def confirmed(self) -> bool:
        return self.verdict == CONFIRMED

    def render(self) -> str:
        return (f"[{self.verdict}] {self.decision}.{self.metric}: "
                f"predicted {self.predicted:g}, measured {self.measured:g} "
                f"(x{self.ratio:.2f}, threshold +/-{self.threshold:.0%}) — "
                f"{self.why}")


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Per-run drift verdict: every compared decision with its
    measured-vs-predicted numbers; ``confirmed`` names the divergent ones."""
    clock: float
    windows: int
    threshold: float
    findings: Tuple[DriftFinding, ...]

    @property
    def confirmed(self) -> Tuple[DriftFinding, ...]:
        return tuple(f for f in self.findings if f.confirmed)

    @property
    def clean(self) -> bool:
        return not self.confirmed

    def for_decision(self, name: str) -> Tuple[DriftFinding, ...]:
        return tuple(f for f in self.findings if f.decision == name)

    def summary(self) -> Dict:
        return {"windows": self.windows, "compared": len(self.findings),
                "confirmed": [f"{f.decision}.{f.metric}"
                              for f in self.confirmed]}

    def render(self) -> str:
        head = (f"DriftReport @ clock {self.clock:g} ({self.windows} "
                f"window(s), threshold {self.threshold:.0%}): "
                f"{len(self.confirmed)} CONFIRMED / "
                f"{len(self.findings)} compared")
        return "\n".join([head] + [f"  {f.render()}" for f in self.findings])


def _verdict(ratio: float, threshold: float) -> str:
    if ratio <= 0:
        return CONFIRMED
    lo, hi = 1.0 / (1.0 + threshold), 1.0 + threshold
    return WITHIN if lo <= ratio <= hi else CONFIRMED


def detect_drift(plan, metrics: MetricsRegistry,
                 threshold: float = 0.5) -> DriftReport:
    """Diff measured run proxies against ``plan.decisions[*].numbers``.

    Comparisons (each skipped when its prediction or measurement is absent):

    * ``attention.resident_tokens_per_row`` — page-rounded mean resident
      tokens per live row (window gauges) vs ``expected_resident_tokens``:
      the occupancy assumption behind paged-vs-contiguous.
    * ``capacity.mean_finished_len`` — mean finished total length vs
      ``expected_mean_len`` (plans resolved by ``plan_serve``).
    * ``kv_quant.hbm_step_bytes`` — estimated per-step HBM traffic (weight
      stream + cache stream scaled by measured occupancy) vs the decision's
      expected-occupancy estimate.
    * ``kv_quant.requant_events`` — any forced fp->int8 requant under a
      plan that resolved fp pages is measured proof the occupancy
      prediction was low (always CONFIRMED when it fires).
    * ``mlp.decode_m`` — the fused/two-call route at the measured mean
      decode width vs at the provisioned ``rows``: CONFIRMED when the
      measured width lands on the other side of the crossover.
    * ``prefill.pad_ratio`` — measured padded/real prefill tokens vs the
      tier ladder's worst-case bound (2.0 for pow2 tiers, 1.0 exact).
    * ``mesh.allgather_bytes_per_token`` — measured collective bytes per
      emitted token (``collective_allgather_bytes`` / ``tokens_emitted``)
      vs the mesh decision's per-token model (sharded plans only).
    """
    decisions = {d.name: d for d in getattr(plan, "decisions", ())}
    findings: List[DriftFinding] = []
    windows = [w for w in metrics.windows if w.get("active_rows", 0) > 0]
    c = metrics.counters
    clock = metrics.gauges.get("clock", 0.0)

    def add(decision, metric, predicted, measured, why,
            verdict=None) -> None:
        pred = float(predicted)
        meas = float(measured)
        ratio = meas / pred if pred else math.inf
        findings.append(DriftFinding(
            decision=decision, metric=metric, predicted=pred, measured=meas,
            ratio=ratio, threshold=threshold,
            verdict=verdict or _verdict(ratio, threshold), why=why))

    mean_resident_per_row = mean_resident_total = None
    if windows:
        mean_resident_per_row = sum(
            w["resident_tokens"] / max(w["active_rows"], 1)
            for w in windows) / len(windows)
        mean_resident_total = sum(
            w["resident_tokens"] for w in windows) / len(windows)

    # ---- attention: measured occupancy vs the paging assumption ----
    attn = decisions.get("attention")
    if attn is not None and mean_resident_per_row is not None \
            and "expected_resident_tokens" in attn.numbers \
            and getattr(plan, "paged", False):
        ps = max(int(getattr(plan, "page_size", 1)), 1)
        measured = math.ceil(mean_resident_per_row / ps) * ps
        add("attention", "resident_tokens_per_row",
            attn.numbers["expected_resident_tokens"], measured,
            "mean page-rounded resident tokens per live row across "
            f"{len(windows)} decode window(s) — the occupancy the "
            "paged-vs-contiguous rule was resolved from")

    # ---- capacity: finished lengths vs the expected mean ----
    cap = decisions.get("capacity")
    lens = metrics.hists.get("finished_len_tokens", [])
    if cap is not None and lens and "expected_mean_len" in cap.numbers:
        add("capacity", "mean_finished_len",
            cap.numbers["expected_mean_len"], sum(lens) / len(lens),
            f"mean finished prompt+output length over {len(lens)} "
            "request(s) vs the expected_len_dist mean the pool was "
            "provisioned for")

    # ---- kv_quant: per-step HBM traffic estimate at measured occupancy --
    kv = decisions.get("kv_quant")
    if kv is not None and mean_resident_total is not None \
            and "weight_stream_bytes" in kv.numbers \
            and "cache_stream_bytes" in kv.numbers:
        w_b = kv.numbers["weight_stream_bytes"]
        c_b = kv.numbers["cache_stream_bytes"]
        cap_tokens = max(plan.rows * plan.cache_len, 1)
        exp_tok = attn.numbers.get("expected_resident_tokens",
                                   plan.cache_len) if attn is not None \
            else plan.cache_len
        pred_frac = min(exp_tok * plan.rows / cap_tokens, 1.0)
        meas_frac = min(mean_resident_total / cap_tokens, 1.0)
        add("kv_quant", "hbm_step_bytes",
            w_b + c_b * pred_frac, w_b + c_b * meas_frac,
            "decode-step HBM estimate: weight stream + cache stream scaled "
            f"by occupancy (predicted {pred_frac:.2f}, measured "
            f"{meas_frac:.2f} of the full pool)")
    if kv is not None and c.get("requant_events", 0) > 0 \
            and getattr(plan, "kv_quant", None) == "fp" \
            or (kv is not None and kv.choice == "fp"
                and c.get("requant_events", 0) > 0):
        add("kv_quant", "requant_events", 0.0, c["requant_events"],
            "the plan resolved fp pages but measured pool pressure forced "
            "the int8 degrade rung — the occupancy prediction ran low",
            verdict=CONFIRMED)

    # ---- mlp: fused/two-call crossover at the measured decode width ----
    mlp = decisions.get("mlp")
    if mlp is not None and windows and hasattr(plan, "mlp_route"):
        mean_active = sum(w["active_rows"] for w in windows) / len(windows)
        m_meas = max(int(round(mean_active)), 1)
        route_plan = plan.mlp_route(plan.rows)
        route_meas = plan.mlp_route(m_meas)
        add("mlp", "decode_m", plan.rows, mean_active,
            f"mean live decode width; route at provisioned rows = "
            f"{route_plan}, at measured width = {route_meas}",
            verdict=CONFIRMED if route_meas != route_plan else WITHIN)

    # ---- prefill: tier-pad waste vs the ladder's worst case ----
    pre = decisions.get("prefill")
    if pre is not None and c.get("prefill_real_tokens", 0) > 0:
        bound = 1.0 if getattr(plan, "prefill_exact", False) else 2.0
        ratio = c["prefill_padded_tokens"] / c["prefill_real_tokens"]
        add("prefill", "pad_ratio", bound, ratio,
            "measured padded/real prefill tokens vs the tier ladder's "
            "worst-case pad bound",
            verdict=CONFIRMED if ratio > bound + 1e-9 else WITHIN)

    # ---- mesh: measured collective bytes/token vs the per-token model ---
    mesh = decisions.get("mesh")
    if mesh is not None and c.get("tokens_emitted", 0) > 0 \
            and mesh.numbers.get("allgather_bytes_per_token", 0) > 0:
        add("mesh", "allgather_bytes_per_token",
            mesh.numbers["allgather_bytes_per_token"],
            c.get("collective_allgather_bytes", 0)
            / max(c["tokens_emitted"], 1),
            "measured collective all-gather bytes per emitted token vs the "
            "mesh decision's model — divergence means the mesh moves more "
            "than token-sized traffic per step")

    return DriftReport(clock=float(clock), windows=len(windows),
                       threshold=threshold, findings=tuple(findings))
