"""The multi-replica fleet: lockstep replicas, heartbeats, deterministic
failover, autoscaling and feedback re-planning (the port's counterpart of
``repro.serve.replica``).

One ``ContinuousBatchingScheduler`` is one failure domain. :class:`ReplicaSet`
puts N of them, each with its own page pool, step graph and sampler seed,
behind one front door (``repro_torch.serve.LLM(..., replicas=N)``) and keeps
every request's outcome when a replica is lost:

* **One virtual clock.** Replicas run through the scheduler's
  boundary-stepped generator (``start_gen`` / ``("tick", G)``): every live
  replica processes the boundary at clock G before any sees G+T, and none
  jumps ahead of it. Placement, failure detection and failover key off G,
  never the wall clock, so two same-seed runs resolve the same.
* **Supervision.** A replica's heartbeat is the virtual steps since it last
  answered a tick, audited every window by a per-slot
  ``runtime.fault_tolerance.StragglerDetector`` with a hard
  ``max_silent_windows`` ceiling behind it, and ``guard.audit_pool`` sweeps
  each pool every window. Kills are seen at once; stalls and pool
  corruption are detected.
* **Failover.** A failed replica's generator is closed as a dead process
  would leave it (no finalization); its unfinished requests are harvested
  from the scheduler's ``_live`` lists and re-routed in (arrival, rid)
  order. Active requests migrate by recompute (the resume prompt is
  ``prompt + out``); each has a migration budget, paced by
  ``backoff_delay``, past which it resolves ``failed``. Every submitted rid
  ends in exactly one ``RequestOutcome``, and the final merge raises on a
  double resolution.
* **Feedback re-planning.** Finished lengths feed
  ``core.plan.replan_from_lengths``, measured draft acceptance
  ``core.plan.replan_spec_k``; a replica swaps to the new plan at a drain
  boundary only.
* **Autoscaling.** Queue depth per live replica against high and low
  watermarks, with patience: bursts spawn replicas, idleness retires
  drained ones.

Two things differ from the reference. Each replica's sampler seed is
``numpy.random.SeedSequence([seed, slot, generation])``'s first word where
the reference folds slot and generation into a JAX key: a survivor's
stream never depends on whether another replica died. And a replica owns
device memory (its pool, decode state and step graph): a kill, a
retirement and a plan swap release it (``ContinuousBatchingScheduler.
release``), while the host side stays readable for the harvest and the
merge, so dead replicas and respawns add no memory on the card.

Replica-level chaos (``serve.chaos.ReplicaChaosConfig``) schedules kills,
stalls and pool corruption on the same clock.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import plan as plan_lib
from repro_torch.core.eyexam import H100_SXM, DeviceRates
from repro_torch.runtime.fault_tolerance import (StragglerDetector,
                                                 backoff_delay)
from repro_torch.serve import chaos as chaos_mod
from repro_torch.serve import guard as guard_mod
from repro_torch.serve import telemetry as telemetry_mod
from repro_torch.serve.router import Router, RouterConfig
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         StreamRequest)

# replica lifecycle states
LIVE = "live"
DEAD = "dead"              # killed (chaos, or the supervisor on a fault)
RETIRED = "retired"        # drained and stopped (scale-down, run end)


@dataclasses.dataclass
class SupervisorConfig:
    """Failure detection, thresholds in sync windows. The straggler
    detector needs 5 healthy observations before its median means
    anything; ``max_silent_windows`` catches replicas stalled earlier."""
    heartbeat_factor: float = 3.0     # StragglerDetector flag multiplier
    heartbeat_patience: int = 2       # consecutive flags -> stalled
    max_silent_windows: int = 8       # hard heartbeat ceiling
    audit_every_window: bool = True   # guard.audit_pool per replica/window


@dataclasses.dataclass
class AutoscaleConfig:
    """Queue-depth autoscaling with hysteresis (depths per live replica)."""
    min_replicas: int = 1
    max_replicas: int = 4
    high_depth: float = 6.0           # scale up above this
    low_depth: float = 1.0            # scale down below this
    patience_windows: int = 3         # watermark must hold this long


@dataclasses.dataclass
class ReplanConfig:
    """Re-plan once the measured mean finished length is more than
    ``drift_threshold`` (relative) from the plan's assumed occupancy, over
    at least ``min_samples`` finished requests; swaps happen at a replica's
    drain boundary only."""
    min_samples: int = 8
    drift_threshold: float = 0.3


class Replica:
    """One scheduler, its boundary-stepped generator and its liveness.

    ``slot`` is fleet-unique and never reused (chaos schedules, detectors
    and router affinity key off it). ``generation`` counts plan swaps; the
    local step counter restarts with each, the non-monotonic input
    ``StragglerDetector.observe`` tolerates."""

    def __init__(self, slot: int, cfg, params, plan, *, eos_id: int,
                 temperature: float, guard,
                 telemetry: Optional[telemetry_mod.Telemetry] = None,
                 device=None, graphs: bool = True):
        self.slot = slot
        self.cfg = cfg
        self.params = params
        self.eos_id = eos_id
        self.temperature = temperature
        self.guard = guard
        self.telemetry = telemetry   # the fleet's (events tagged by slot)
        self.device = device
        self.graphs = graphs
        self.state = LIVE
        self.failed_over = False     # failover executed (exactly once)
        self.fail_reason = ""
        self.generation = 0
        self.local_step = 0          # boundaries processed this generation
        self.last_response: float = 0.0   # clock of the last answered tick
        self.last_status: Optional[Dict] = None
        self.done_accum: List[StreamRequest] = []   # earlier generations
        self.stalled_by_chaos = False
        self._gen = None
        self.scheduler = self._scheduler(plan)

    def _scheduler(self, plan) -> ContinuousBatchingScheduler:
        return ContinuousBatchingScheduler(
            self.cfg, self.params, plan, eos_id=self.eos_id,
            temperature=self.temperature, device=self.device,
            graphs=self.graphs, guard=self.guard, telemetry=self.telemetry,
            slot=self.slot)

    # ------------------------------------------------------------ lifecycle
    def start(self, seed: int, chaos=None, at_clock: float = 0.0,
              sync_every: int = 1) -> None:
        self._gen = self.scheduler.start_gen([], seed=seed, chaos=chaos)
        # a fresh replica counts as having just answered (a spawn is a sync)
        self.last_response = at_clock - sync_every
        self.local_step = 0
        self.last_status = None

    def tick(self, clock: float) -> Optional[Dict]:
        """One boundary at the shared clock. Returns the status dict, or
        None when the replica's own pool audit raised (it is then DEAD, for
        the supervisor to fail over)."""
        try:
            self.last_status = self._gen.send(("tick", clock))
        except guard_mod.PoolAuditError as e:
            self._gen = None         # the generator died raising
            self.state = DEAD
            self.last_status = None
            self.fail_reason = f"pool audit failed in-run: {e}"
            return None
        self.last_response = clock
        self.local_step += 1
        return self.last_status

    def stop(self) -> List[StreamRequest]:
        """Finalize a drained run, release the device memory, return the
        run's done list."""
        try:
            self._gen.send(("stop", None))
        except StopIteration as e:
            return e.value
        finally:
            self._gen = None
            self.scheduler.release()
        raise RuntimeError("scheduler generator did not finalize on stop")

    def kill(self) -> None:
        """Abandon the run as a dead process would: the generator unwinds
        without finalization (no outcome delivered, the live lists left to
        harvest) and the device memory is released."""
        if self._gen is not None:
            self._gen.close()
            self._gen = None
        self.scheduler.release()

    # ------------------------------------------------------------- queries
    def queue_depth(self) -> int:
        live = self.scheduler._live
        if live is None:
            return 0
        return len(live["pending"]) + len(live["waiting"]) \
            + len(live["active"])

    def heartbeat(self, clock: float) -> float:
        """Virtual steps since this replica last answered a tick."""
        return clock - self.last_response

    def harvest_unfinished(self) -> List[StreamRequest]:
        """The requests this replica's death stranded (no outcome), in
        (arrival, rid) order: the failover's re-route order."""
        live = self.scheduler._live
        if live is None:
            return []
        stranded = list(live["pending"]) + list(live["waiting"]) \
            + list(live["active"].values())
        stranded = [r for r in stranded if r.outcome is None]
        return sorted(stranded, key=lambda r: (r.arrival, r.rid))

    def collect_done(self) -> List[StreamRequest]:
        """Every request this replica resolved, over its plan generations."""
        out = list(self.done_accum)
        if self.scheduler._live is not None:
            out.extend(self.scheduler._live["done"])
        return out

    # ----------------------------------------------------------- plan swap
    def swap_plan(self, plan, seed: int, chaos=None,
                  at_clock: float = 0.0) -> None:
        """Swap in a re-resolved plan at a drain boundary: finalize the
        drained run (releasing its memory), build the scheduler on the new
        plan, start it. The local step counter restarts."""
        self.done_accum.extend(self.stop())
        self.generation += 1
        self.scheduler = self._scheduler(plan)
        self.start(seed, chaos=chaos, at_clock=at_clock,
                   sync_every=self.scheduler.sync_every)


class ReplicaSupervisor:
    """The per-window liveness audit of the fleet: each live replica's
    heartbeat (in windows) goes to its slot's :class:`StragglerDetector`
    (about 1.0 when healthy, growing when it stalls, flagged past ``factor``
    times the median, persistent past ``patience``); ``max_silent_windows``
    backs it up, and ``guard.audit_pool`` catches pool corruption in the
    window it appears. Returns reasons and changes nothing: failover is the
    ReplicaSet's."""

    def __init__(self, cfg: Optional[SupervisorConfig] = None):
        self.cfg = cfg or SupervisorConfig()
        self._detectors: Dict[int, StragglerDetector] = {}

    def detector(self, slot: int) -> StragglerDetector:
        if slot not in self._detectors:
            self._detectors[slot] = StragglerDetector(
                self.cfg.heartbeat_factor, self.cfg.heartbeat_patience)
        return self._detectors[slot]

    def audit(self, replicas: List[Replica], clock: float,
              sync_every: int) -> List[tuple]:
        """One window: [(replica, reason), ...] for every replica to fail
        over, in the given order."""
        failures = []
        for rep in replicas:
            if rep.state == DEAD:
                failures.append(
                    (rep, rep.fail_reason or "replica died (killed)"))
                continue
            hb_windows = rep.heartbeat(clock) / max(sync_every, 1)
            det = self.detector(rep.slot)
            det.observe(rep.local_step, hb_windows)
            if det.persistent:
                failures.append((rep, f"heartbeat stalled: silent for "
                                      f"{hb_windows:.0f} windows (straggler "
                                      f"strikes {det.strikes})"))
                continue
            if hb_windows > self.cfg.max_silent_windows:
                failures.append((rep, f"heartbeat stalled: silent for "
                                      f"{hb_windows:.0f} windows (hard "
                                      "ceiling "
                                      f"{self.cfg.max_silent_windows})"))
                continue
            if self.cfg.audit_every_window and rep.scheduler.paged \
                    and rep.scheduler.pager is not None:
                violations = guard_mod.audit_pool(rep.scheduler.pager)
                if violations:
                    failures.append(
                        (rep, f"pool audit failed ({len(violations)} "
                              f"violation(s)): {violations[0]}"))
        return failures


class ReplicaSet:
    """N lockstep scheduler replicas behind one :meth:`run`.

    Each window at clock G runs, in this order (each stage deterministic in
    G and the seed):

    1. due replica chaos (kill, stall, pool corruption);
    2. supervision and failover (harvest, re-route in (arrival, rid) order,
       budgets checked);
    3. autoscaling on measured queue depth;
    4. re-planning at drain boundaries (measured lengths, then measured
       draft acceptance);
    5. dispatch of due arrivals, per-tenant fair order, router placed;
    6. a tick of every responsive replica with ("tick", G);
    7. the finished-length feedback;

    then G += sync_every, until every request holds an outcome. The guard is
    always on (a guard-less fleet would raise at the first overload), and
    the fleet's ``telemetry`` is shared by every replica's scheduler and
    reset once per run. ``device`` and ``graphs`` are the schedulers'; the
    replicas share ``params``. ``rates`` divides the re-planned MLP
    roofline's seconds."""

    def __init__(self, cfg, params, plan=None, *, replicas: int = 2,
                 eos_id: int = 1, temperature: float = 0.0,
                 guard: Optional[guard_mod.GuardConfig] = None,
                 router: Optional[RouterConfig] = None,
                 supervisor: Optional[SupervisorConfig] = None,
                 autoscale: Optional[AutoscaleConfig] = None,
                 replan: Optional[ReplanConfig] = None,
                 migration_budget: int = 3,
                 migrate_backoff_steps: float = 0.0,
                 max_rounds: int = 10_000,
                 telemetry: Optional[telemetry_mod.Telemetry] = None,
                 device=None, graphs: bool = True,
                 rates: DeviceRates = H100_SXM):
        if replicas < 1:
            raise ValueError(
                f"replicas must be >= 1, got {replicas}: the control plane "
                "needs at least one scheduler replica to place requests on")
        if plan is None:
            plan = plan_lib.plan_serve(
                cfg, hbm_budget_bytes=1 << 30, expected_batch=4,
                expected_len_dist={"mean": 256, "max": 512}, rates=rates)
        self.cfg = cfg
        self.params = params
        self.plan = plan                  # the template for spawns
        self.eos_id = eos_id
        self.temperature = temperature
        self.guard = guard or guard_mod.GuardConfig()
        self.sync_every = plan.sync_every
        self.router = Router(router, page_size=plan.page_size)
        self.supervisor = ReplicaSupervisor(supervisor)
        self.autoscale = autoscale
        self.replan = replan
        self.migration_budget = migration_budget
        self.migrate_backoff_steps = migrate_backoff_steps
        self.max_rounds = max_rounds
        self.n_replicas = replicas
        self.device = device
        self.graphs = graphs
        self.rates = rates
        self.telemetry = telemetry if telemetry is not None \
            else telemetry_mod.Telemetry()
        self._all: List[Replica] = []     # every replica of the run
        self._next_slot = 0
        self.phase_stats: Dict = {}

    # ------------------------------------------------------------- helpers
    def _live(self) -> List[Replica]:
        return [rep for rep in self._all if rep.state == LIVE]

    @staticmethod
    def _seed_for(seed: int, slot: int, generation: int) -> int:
        """A replica generation's sampler seed: independent of the fleet's
        membership, so a survivor's randomness never depends on whether
        another replica died."""
        return int(np.random.SeedSequence(
            [seed, slot, generation]).generate_state(1)[0])

    def _spawn(self, seed: int, chaos: chaos_mod.ReplicaChaosConfig,
               at_clock: float) -> Replica:
        slot = self._next_slot
        self._next_slot += 1
        rep = Replica(slot, self.cfg, self.params, self.plan,
                      eos_id=self.eos_id, temperature=self.temperature,
                      guard=self.guard, telemetry=self.telemetry,
                      device=self.device, graphs=self.graphs)
        rep.start(self._seed_for(seed, slot, 0),
                  chaos=chaos.request_chaos.get(slot),
                  at_clock=at_clock, sync_every=self.sync_every)
        self._all.append(rep)
        self._st["replicas_spawned"] += 1
        return rep

    def _resolve_failed(self, r: StreamRequest, clock: float,
                        reason: str) -> None:
        r.done = True
        r.finished_at = clock
        r.outcome = guard_mod.RequestOutcome(
            "failed", reason, at_step=clock, degraded=tuple(r.degraded))
        self.telemetry.metrics.count("failed")
        self.telemetry.tracer.event("outcome", clock, cat="request",
                                    rid=r.rid, status="failed")
        if r.on_outcome is not None:
            r.on_outcome(r, r.outcome)
        self._failed.append(r)

    def _failover(self, rep: Replica, reason: str, clock: float) -> None:
        """Kill, forget affinity, re-route the stranded requests in
        (arrival, rid) order within their migration budgets."""
        rep.kill()
        rep.state = DEAD
        rep.failed_over = True
        self.router.forget_replica(rep.slot)
        st = self._st
        st["failovers"] += 1
        st["failover_reasons"].setdefault(reason.split(":")[0], 0)
        st["failover_reasons"][reason.split(":")[0]] += 1
        tel = self.telemetry
        tel.metrics.count("failovers")
        tel.tracer.event("failover", clock, cat="window",
                         replica=rep.slot, reason=reason.split(":")[0])
        for r in rep.harvest_unfinished():
            tel.metrics.count("migrations")
            tel.tracer.event("migrate", clock, cat="window", rid=r.rid,
                             from_replica=rep.slot)
            r.migrations += 1
            if r.migrations > self.migration_budget:
                self._resolve_failed(
                    r, clock,
                    f"migration budget ({self.migration_budget}) spent: "
                    f"request lost its host {r.migrations} times "
                    f"(last: {reason}); {len(r.out)} generated tokens kept")
                st["failed_migrations"] += 1
            else:
                self._hold[r.rid] = clock + backoff_delay(
                    r.migrations, self.migrate_backoff_steps)
                self._pendq.append(r)
                st["migrated_requests"] += 1
        self._pendq.sort(key=lambda r: (r.arrival, r.rid))

    def _plan_mean(self) -> float:
        """The occupancy the current plan assumed."""
        for d in self.plan.decisions:
            if "expected_mean_len" in getattr(d, "numbers", {}):
                return float(d.numbers["expected_mean_len"])
        return self.plan.cache_len / 2

    def _retire(self, rep: Replica) -> None:
        """Stop a drained replica (its memory released) and keep its done
        list."""
        rep.done_accum.extend(rep.stop())
        if rep.scheduler._live is not None:
            rep.scheduler._live["done"] = []      # in done_accum now
        rep.state = RETIRED

    def _swap_drained(self, live: List[Replica], new_plan, seed: int,
                      chaos: chaos_mod.ReplicaChaosConfig,
                      clock: float) -> None:
        """Every drained, idle replica not on ``new_plan`` swaps to it."""
        for rep in live:
            if rep.last_status and rep.last_status["drained"] \
                    and rep.queue_depth() == 0 \
                    and rep.scheduler.plan != new_plan:
                rep.swap_plan(
                    new_plan,
                    self._seed_for(seed, rep.slot, rep.generation + 1),
                    chaos=chaos.request_chaos.get(rep.slot), at_clock=clock)
                self._done_seen[rep.slot] = 0

    # ----------------------------------------------------------------- run
    def run(self, requests: List[StreamRequest], seed: int = 0,
            chaos=None) -> List[StreamRequest]:
        """Serve ``requests`` over the fleet; returns them by rid, each with
        its outcome. ``chaos`` takes a ``ReplicaChaosConfig``, or a
        ``ChaosConfig`` that every initial replica's scheduler then runs."""
        if chaos is None:
            chaos = chaos_mod.ReplicaChaosConfig()
        elif isinstance(chaos, chaos_mod.ChaosConfig):
            chaos = chaos_mod.ReplicaChaosConfig(
                request_chaos={s: chaos for s in range(self.n_replicas)})
        reqs = list(requests)
        rids = [r.rid for r in reqs]
        if len(set(rids)) != len(rids):
            raise ValueError(f"request rids must be unique, got {rids}")
        # caller bugs raise before any replica works; re-planning pins
        # cache_len, so the check holds across swaps
        for r in reqs:
            total = len(r.prompt) + r.max_new
            if r.max_new > 0 and total > self.plan.cache_len:
                raise ValueError(
                    f"request {r.rid}: prompt ({len(r.prompt)}) + max_new "
                    f"({r.max_new}) exceeds cache_len "
                    f"({self.plan.cache_len})")
        T = self.sync_every
        st = self._st = self.phase_stats = {
            "replicas": self.n_replicas, "replicas_spawned": 0,
            "failovers": 0, "failover_reasons": {},
            "migrated_requests": 0, "failed_migrations": 0,
            "scale_ups": 0, "scale_downs": 0, "replans": 0,
            "spec_replans": 0, "rounds": 0, "clock_steps": 0.0,
        }
        self._all = []
        self._next_slot = 0
        self.telemetry.reset()
        tel = self.telemetry
        self._failed: List[StreamRequest] = []
        self._pendq = sorted(reqs, key=lambda r: (r.arrival, r.rid))
        self._hold: Dict[int, float] = {}       # rid -> earliest dispatch
        self._finished_lengths: List[int] = []
        self._done_seen: Dict[int, int] = {}    # slot -> done entries seen
        chaos_done = {"kill": set(), "stall": set(), "corrupt": set()}
        up_streak = down_streak = 0
        G = 0.0
        for _ in range(self.n_replicas):
            self._spawn(seed, chaos, at_clock=G)

        rounds = 0
        while True:
            live = self._live()
            # ---- 1. replica chaos due at this clock
            by_slot = {rep.slot: rep for rep in live}
            for slot, step in sorted(chaos.kill_at_step.items()):
                if step <= G + 1e-9 and slot not in chaos_done["kill"] \
                        and slot in by_slot:
                    chaos_done["kill"].add(slot)
                    rep = by_slot[slot]
                    rep.kill()
                    rep.state = DEAD
                    rep.fail_reason = \
                        f"replica died (chaos kill at step {step:g})"
            for slot, step in sorted(chaos.stall_at_step.items()):
                if step <= G + 1e-9 and slot not in chaos_done["stall"] \
                        and slot in by_slot:
                    chaos_done["stall"].add(slot)
                    by_slot[slot].stalled_by_chaos = True
            for slot, step in sorted(chaos.corrupt_pool_at_step.items()):
                if step <= G + 1e-9 and slot not in chaos_done["corrupt"] \
                        and slot in by_slot:
                    pager = by_slot[slot].scheduler.pager
                    if pager is not None:
                        chaos_done["corrupt"].add(slot)
                        pager._refs[0] += 1      # a phantom refcount

            # ---- 2. supervise and fail over
            candidates = [rep for rep in self._all
                          if rep.state != RETIRED and not rep.failed_over]
            for rep, reason in self.supervisor.audit(candidates, G, T):
                self._failover(rep, reason, G)
            live = self._live()
            if not live and any(r.outcome is None for r in reqs):
                # the whole fleet lost with work left: a cold replacement
                # on a fresh slot (chaos schedules never fire again)
                self._spawn(seed, chaos, at_clock=G)
                live = self._live()

            # ---- 3. autoscale (hysteresis on measured queue depth)
            if self.autoscale is not None and live:
                asc = self.autoscale
                arrived = sum(1 for r in self._pendq
                              if r.arrival <= G + 1e-9)
                depth = arrived + sum(rep.queue_depth() for rep in live)
                per = depth / len(live)
                if per > asc.high_depth:
                    up_streak += 1
                    down_streak = 0
                elif per < asc.low_depth:
                    down_streak += 1
                    up_streak = 0
                else:
                    up_streak = down_streak = 0
                if up_streak >= asc.patience_windows \
                        and len(live) < asc.max_replicas:
                    rep = self._spawn(seed, chaos, at_clock=G)
                    st["scale_ups"] += 1
                    tel.metrics.count("scale_ups")
                    tel.tracer.event("scale_up", G, cat="window",
                                     replica=rep.slot)
                    up_streak = 0
                    live = self._live()
                elif down_streak >= asc.patience_windows \
                        and len(live) > asc.min_replicas:
                    drained = [rep for rep in live if rep.last_status
                               and rep.last_status["drained"]
                               and rep.queue_depth() == 0]
                    if drained:
                        rep = max(drained, key=lambda rep: rep.slot)
                        self._retire(rep)
                        self.router.forget_replica(rep.slot)
                        st["scale_downs"] += 1
                        tel.metrics.count("scale_downs")
                        tel.tracer.event("scale_down", G, cat="window",
                                         replica=rep.slot)
                        down_streak = 0
                        live = self._live()

            # ---- 4. feedback re-planning at drain boundaries
            if self.replan is not None \
                    and len(self._finished_lengths) >= self.replan.min_samples:
                measured = statistics.fmean(self._finished_lengths)
                assumed = self._plan_mean()
                if abs(measured - assumed) / max(assumed, 1.0) \
                        > self.replan.drift_threshold:
                    new_plan = plan_lib.replan_from_lengths(
                        self.cfg, self.plan, self._finished_lengths,
                        rates=self.rates)
                    if new_plan != self.plan:
                        self.plan = new_plan    # spawns use it at once
                        st["replans"] += 1
                        tel.metrics.count("replans")
                        tel.tracer.event("replan", G, cat="window",
                                         measured_mean=round(measured, 3))
                    self._swap_drained(live, new_plan, seed, chaos, G)

            # ---- 4b. speculative depth from the measured acceptance
            if self.replan is not None and self.plan.spec_k >= 2:
                drafted = int(tel.metrics.counters.get(
                    "spec_drafted_tokens", 0))
                accepted = int(tel.metrics.counters.get(
                    "spec_accepted_tokens", 0))
                spec_plan = plan_lib.replan_spec_k(
                    self.cfg, self.plan, drafted_tokens=drafted,
                    accepted_tokens=accepted)
                if spec_plan != self.plan:
                    self.plan = spec_plan       # spawns use it at once
                    st["spec_replans"] += 1
                    tel.metrics.count("replans")
                    tel.tracer.event(
                        "spec_replan", G, cat="spec",
                        spec_k=spec_plan.spec_k,
                        measured_rate=round(accepted / max(drafted, 1), 3))
                    self._swap_drained(live, spec_plan, seed, chaos, G)

            # ---- 5. dispatch due arrivals (fair order, router placed)
            due = [r for r in self._pendq if r.arrival <= G + 1e-9
                   and self._hold.get(r.rid, -1.0) <= G + 1e-9]
            if due and live:
                for r in Router.fair_order(due):
                    rep = self.router.place(r, live)
                    r.replica = rep.slot
                    rep.scheduler.inject([r])
                    self._pendq.remove(r)
                    self._hold.pop(r.rid, None)
                tel.tracer.event("dispatch", G, cat="window",
                                 placed=len(due))

            # ---- 6. tick the fleet at G (lockstep)
            for rep in sorted(live, key=lambda rep: rep.slot):
                if rep.stalled_by_chaos:
                    continue            # a hung process does not answer
                rep.tick(G)

            # ---- 7. finished-length feedback
            for rep in self._live():
                slive = rep.scheduler._live
                if slive is None:
                    continue
                seen = self._done_seen.get(rep.slot, 0)
                for r in slive["done"][seen:]:
                    if r.replica is None:
                        r.replica = rep.slot
                    if r.outcome is not None and r.outcome.status == "ok":
                        self._finished_lengths.append(
                            len(r.prompt) + len(r.out))
                self._done_seen[rep.slot] = len(slive["done"])

            tel.tracer.span("window", G, G + T, cat="window",
                            live=len(self._live()),
                            pending=len(self._pendq))
            st["rounds"] = rounds = rounds + 1
            G += T
            st["clock_steps"] = G
            if all(r.outcome is not None for r in reqs):
                break
            if rounds > self.max_rounds:
                raise RuntimeError(
                    f"replica set made no terminal progress within "
                    f"max_rounds ({self.max_rounds}) windows — "
                    "supervision/failover wedged")

        # ---- finalize: stop the live replicas (all drained), merge
        st["replicas_final"] = len(self._live())
        done: List[StreamRequest] = list(self._failed)
        for rep in self._all:
            if rep.state == LIVE:
                self._retire(rep)
            done.extend(rep.collect_done())
        # a request resolves on one replica or here, never twice
        by_rid: Dict[int, StreamRequest] = {}
        for r in done:
            if r.rid in by_rid:
                raise RuntimeError(
                    f"rid {r.rid} resolved on two replicas — exactly-once "
                    "outcome invariant broken")
            by_rid[r.rid] = r
        st["outcomes"] = {k: 0 for k in guard_mod.OUTCOMES}
        for r in done:
            if r.outcome is not None:
                st["outcomes"][r.outcome.status] += 1
        st["router"] = dict(self.router.stats)
        agg_keys = ("decode_chunks", "decode_steps", "prefill_batches",
                    "prefill_prompts", "prefill_real_tokens", "preemptions",
                    "shared_tokens_admitted", "cow_copies",
                    "stalled_boundaries", "step_retries",
                    "clamped_admissions", "idle_steps")
        st["fleet"] = {k: 0 for k in agg_keys}
        for rep in self._all:
            ps = rep.scheduler.phase_stats
            for k in agg_keys:
                st["fleet"][k] += ps.get(k, 0)
        # one drift report over the whole run's windows (fleet members skip
        # their own: partial reports would double-count)
        tel.metrics.gauge("clock", G)
        st["tenants"] = tel.metrics.tenant_summary()
        st["drift"] = tel.detect_drift(self.plan).summary()
        return sorted(done, key=lambda r: r.rid)
