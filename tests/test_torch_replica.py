"""The port's fleet (``repro_torch.serve.replica``) against the reference's.

On ``qwen2.5-3b-reduced`` with the reference's weights bridged as numpy and
the reference fleet tests' plan (rows 3, cache 64, pages of 4, 24 pages,
sync 4; the port's resolved at ``eyexam.TPU_V5E`` rates) and requests,
greedy with ``eos_id=-1``:

* **Parity.** Four runs go through both packages: the fault-free fleet of
  3, a kill of replica 0 at step 8, a permanent stall of replica 0 at step
  12 (2 replicas, arrivals 6 steps apart) and one replica under autoscaling
  and feedback re-planning. Equal, request by request: the outcome
  (status, reason, step, rungs), ``replica``, ``migrations``, the admission,
  first-token and finish steps, and the tokens (or a parting at a reference
  near-tie, ``torch_dense_parity.compare_streams``); run by run: every key
  of the fleet's ``phase_stats`` (failovers and their reasons, migrations,
  router stats, the ``fleet`` counters, outcomes, tenants, drift), the
  metrics snapshot and ``Tracer.signature()``, byte for byte.
* **The port alone.** Every case of ``tests/test_replica.py`` with that
  test's own assertions: survivors of a kill equal the fault-free run,
  same-seed chaos runs equal, exactly-once outcomes over a kill sweep, the
  stall caught by the heartbeat, pool corruption caught by the audit, the
  migration budget, total fleet loss, autoscaling up and down, the
  re-planned pool, prefix affinity against depth-only placement, the front
  door's validation and callbacks, the detector across a plan swap.
* **The scheduler's outside drive.** ``run`` equals ``start_gen`` ticked to
  the end (outcomes, streams, counters, trace), and ``inject`` raises the
  reference's errors.
* **The release.** A killed replica's and a swapped-out scheduler's pool,
  decode state and (stand-in) step graph are gone while ``_live`` still
  harvests; a released scheduler serves again.
* **Planning helpers.** ``replan_from_lengths``, ``_alpha_from_acceptance``
  and ``replan_spec_k`` equal the reference's on a grid, at ``TPU_V5E``.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import plan as rplan
from repro.models import transformer as rtfm
from repro.serve import LLM as RLLM
from repro.serve import replica as rreplica
from repro.serve.chaos import ReplicaChaosConfig as RReplicaChaos
from repro.serve.guard import GuardConfig as RGuard
from repro.serve.scheduler import ContinuousBatchingScheduler as RScheduler
from repro.serve.scheduler import StreamRequest as RRequest

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import eyexam
from repro_torch.core import plan as pplan
from repro_torch.serve import LLM, StreamRequest
from repro_torch.serve import engine as peng
from repro_torch.serve.chaos import ChaosConfig, ReplicaChaosConfig
from repro_torch.serve.guard import GuardConfig
from repro_torch.serve.replica import (DEAD, RETIRED, AutoscaleConfig,
                                       ReplanConfig, Replica, ReplicaSet,
                                       RouterConfig, SupervisorConfig)
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from test_torch_guard import _StandInGraph
from test_torch_plan import PINNED_CASES
from test_torch_spec import PLAN_CASES
from torch_dense_parity import compare_streams

pytestmark = pytest.mark.chaos

ARCH = "qwen2.5-3b-reduced"
V5E = eyexam.TPU_V5E
T = 4
GEOMETRY = dict(rows=3, cache_len=64, page_size=4, num_pages=24,
                sync_every=T)
AUTOSCALE = dict(min_replicas=1, max_replicas=3, high_depth=2.0,
                 low_depth=0.5, patience_windows=2)
REPLAN = dict(min_samples=4, drift_threshold=0.3)
# name -> (replicas, _reqs kwargs, chaos kwargs, whether the run is a
# ReplicaSet under AUTOSCALE and REPLAN rather than the LLM front door)
RUNS = {
    "clean": (3, {}, None, False),
    "kill": (3, {}, dict(kill_at_step={0: 8.0}), False),
    "stall": (2, dict(n=8, spread=6.0), dict(stall_at_step={0: 12.0}),
              False),
    "autoscale_replan": (1, dict(n=10, max_new=8, spread=1.0), None, True),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's fleet runs tiny ops; under the suite's parallel workers
    torch's intra-op threads would only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    rcfg = rget_config(ARCH)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    cfg = get_config(ARCH)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, rparams))
    return types.SimpleNamespace(
        rcfg=rcfg, rparams=rparams, cfg=cfg, params=params,
        rplan=rplan.plan_for_scheduler(rcfg, **GEOMETRY),
        plan=pplan.plan_for_scheduler(cfg, rates=V5E, **GEOMETRY))


def _reqs(cls, n=8, max_new=6, spread=1.0, prefix=()):
    return [cls(rid=i, prompt=list(prefix) + [3 + i % 4, 5, 7],
                max_new=max_new, arrival=float(i) * spread,
                tenant="t%d" % (i % 2))
            for i in range(n)]


def _terminal_check(done, n):
    """Every submitted rid in exactly one terminal outcome, fleet-wide."""
    assert sorted(r.rid for r in done) == list(range(n))
    assert all(r.outcome is not None for r in done)


def _fleet(m, replicas, **kw):
    """The port's ReplicaSet on the CPU, on the reference tests' plan."""
    return ReplicaSet(m.cfg, m.params, m.plan, replicas=replicas, eos_id=-1,
                      device="cpu", rates=V5E, **kw)


def _llm(m, replicas):
    return LLM(m.cfg, m.params, m.plan, eos_id=-1, replicas=replicas,
               device="cpu")


def _run(side, m, name):
    """One of ``RUNS`` through one package: (done, phase_stats, telemetry,
    the ReplicaSet)."""
    replicas, req_kw, chaos_kw, scaled = RUNS[name]
    ref = side == "reference"
    reqs = _reqs(RRequest if ref else StreamRequest, **req_kw)
    chaos = (RReplicaChaos if ref else ReplicaChaosConfig)(**chaos_kw) \
        if chaos_kw else None
    if not scaled:
        if ref:
            llm = RLLM(m.rcfg, m.rparams, m.rplan, eos_id=-1,
                       replicas=replicas)
            done = llm.stream(reqs, chaos=chaos)
            return done, llm.phase_stats, llm.telemetry(), llm._replicaset
        llm = _llm(m, replicas)
        done = llm.stream(reqs, chaos=chaos)
        return done, llm.phase_stats, llm.telemetry(), llm._fleet
    if ref:
        rs = rreplica.ReplicaSet(
            m.rcfg, m.rparams, m.rplan, replicas=replicas, eos_id=-1,
            autoscale=rreplica.AutoscaleConfig(**AUTOSCALE),
            replan=rreplica.ReplanConfig(**REPLAN))
    else:
        rs = _fleet(m, replicas, autoscale=AutoscaleConfig(**AUTOSCALE),
                    replan=ReplanConfig(**REPLAN))
    done = rs.run(reqs, chaos=chaos)
    return done, rs.phase_stats, rs.telemetry, rs


@pytest.fixture(scope="module")
def runs(model):
    """Each side's runs of ``RUNS``, made once per module on first use."""
    cache = {}

    def get(side, name):
        if (side, name) not in cache:
            cache[side, name] = _run(side, model, name)
        return cache[side, name]
    return get


def _outcome(r):
    o = r.outcome
    return (o.status, o.reason, o.at_step, tuple(o.degraded))


# ------------------------------------------------------------------ parity
@pytest.mark.parametrize("name", list(RUNS))
def test_fleet_run_matches_reference(model, runs, name):
    ref, rst, rtel, _ = runs("reference", name)
    got, st, tel, _ = runs("port", name)
    assert [r.rid for r in got] == [r.rid for r in ref]
    for r, p in zip(ref, got):
        assert _outcome(p) == _outcome(r), r.rid
        assert (p.replica, p.migrations, p.admitted_at, p.first_token_at,
                p.finished_at, p.preemptions) == (
            r.replica, r.migrations, r.admitted_at, r.first_token_at,
            r.finished_at, r.preemptions), r.rid
    compare_streams(model.rcfg, model.rparams, [r.prompt for r in ref],
                    [list(p.out) for p in got], [list(r.out) for r in ref])
    assert set(st) == set(rst)
    for key in rst:
        assert st[key] == rst[key], key
    assert tel.tracer.events
    assert tel.tracer.signature() == rtel.tracer.signature()
    assert tel.metrics.snapshot().as_dict() == \
        rtel.metrics.snapshot().as_dict()
    if name == "clean":
        assert st["failovers"] == 0 and st["router"]["placements"] == 8
    elif name in ("kill", "stall"):
        assert st["failovers"] == 1 and st["migrated_requests"] > 0
    else:
        assert st["scale_ups"] >= 1 and st["replans"] >= 1


# --------------------------------------------------------- the port alone
def test_kill_survivors_bit_identical_and_exactly_once(runs):
    base = runs("port", "clean")[0]
    base_out = {r.rid: list(r.out) for r in base}
    assert all(r.outcome.status == "ok" for r in base)
    done, st = runs("port", "kill")[:2]
    _terminal_check(done, 8)
    assert st["failovers"] == 1
    for r in done:
        if r.outcome.status == "ok":
            assert list(r.out) == base_out[r.rid], \
                f"rid {r.rid} diverged after failover"


def test_same_seed_chaos_runs_identical(model):
    out = []
    for _ in range(2):
        llm = _llm(model, 3)
        done = llm.stream(_reqs(StreamRequest), chaos=ReplicaChaosConfig(
            kill_at_step={1: 4.0}))
        out.append(sorted((r.rid, r.outcome.status, tuple(r.out), r.replica,
                           r.migrations) for r in done))
    assert out[0] == out[1]


@pytest.mark.parametrize("n_rep,kill_step", [(2, 0.0), (2, 12.0), (3, 8.0)])
def test_exactly_once_outcomes_under_kill_sweep(model, n_rep, kill_step):
    llm = _llm(model, n_rep)
    done = llm.stream(_reqs(StreamRequest, n=6), chaos=ReplicaChaosConfig(
        kill_at_step={0: kill_step}))
    _terminal_check(done, 6)
    assert llm.phase_stats["failovers"] == 1


def test_permanent_stall_detected_by_heartbeat(runs):
    done, st = runs("port", "stall")[:2]
    _terminal_check(done, 8)
    assert st["failovers"] == 1
    assert any(k.startswith("heartbeat stalled")
               for k in st["failover_reasons"])


def test_pool_corruption_quarantined_by_audit(model):
    llm = _llm(model, 2)
    done = llm.stream(_reqs(StreamRequest), chaos=ReplicaChaosConfig(
        corrupt_pool_at_step={1: 8.0}))
    _terminal_check(done, 8)
    st = llm.phase_stats
    assert st["failovers"] == 1
    assert any(k.startswith("pool audit failed")
               for k in st["failover_reasons"])


def test_migration_budget_exhaustion_resolves_failed(model):
    rs = _fleet(model, 2, migration_budget=0)
    done = rs.run(_reqs(StreamRequest, n=6, max_new=8, spread=0.0),
                  chaos=ReplicaChaosConfig(kill_at_step={0: 4.0}))
    _terminal_check(done, 6)
    st = rs.phase_stats
    assert st["failed_migrations"] >= 1
    failed = [r for r in done if r.outcome.status == "failed"]
    assert failed and all("migration budget" in r.outcome.reason
                          for r in failed)
    assert st["outcomes"]["failed"] == len(failed)
    assert st["outcomes"]["ok"] == 6 - len(failed)


def test_total_fleet_loss_respawns_and_finishes(model):
    rs = _fleet(model, 2)
    done = rs.run(_reqs(StreamRequest, n=4), chaos=ReplicaChaosConfig(
        kill_at_step={0: 4.0, 1: 4.0}))
    _terminal_check(done, 4)
    st = rs.phase_stats
    assert st["failovers"] == 2
    assert st["replicas_spawned"] == 3        # 2 initial + 1 replacement
    assert st["outcomes"]["ok"] == 4


def test_autoscale_up_and_down_with_hysteresis(model):
    rs = _fleet(model, 1, autoscale=AutoscaleConfig(**AUTOSCALE))
    done = rs.run(_reqs(StreamRequest, n=10, max_new=8, spread=0.0))
    _terminal_check(done, 10)
    st = rs.phase_stats
    assert st["scale_ups"] >= 1
    assert st["scale_downs"] >= 1             # drained replicas retired
    assert st["replicas_final"] >= 1


def test_feedback_replan_shrinks_pool_at_drain(model):
    rs = _fleet(model, 1, replan=ReplanConfig(**REPLAN))
    base_pages = rs.plan.num_pages
    done = rs.run(_reqs(StreamRequest, n=10, max_new=6, spread=4.0))
    _terminal_check(done, 10)
    st = rs.phase_stats
    assert st["replans"] >= 1
    assert rs.plan.num_pages < base_pages     # pool resized to measured mean
    assert rs.plan.cache_len == 64            # envelope pinned
    assert st["outcomes"]["ok"] == 10


def test_prefix_affinity_beats_round_robin_on_shared_traffic(model):
    prefixes = [(11, 12, 13, 14, 11, 12, 13, 14),
                (21, 22, 23, 24, 21, 22, 23, 24)]
    shared = {}
    for affinity in (True, False):
        rs = _fleet(model, 3, router=RouterConfig(affinity=affinity))
        reqs = [StreamRequest(
            rid=i, prompt=list(prefixes[i % 2]) + [3 + i % 4, 5, 7],
            max_new=6, arrival=float(i), tenant="t%d" % (i % 2))
            for i in range(12)]
        done = rs.run(reqs)
        _terminal_check(done, 12)
        shared[affinity] = rs.phase_stats["fleet"]["shared_tokens_admitted"]
    assert shared[True] > shared[False]


def test_facade_replicas_validation_names_limit(model):
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        LLM(model.cfg, model.params, model.plan, replicas=0, device="cpu")
    with pytest.raises(ValueError, match="replicas must be >= 1"):
        ReplicaSet(model.cfg, model.params, model.plan, replicas=0,
                   device="cpu")


def test_facade_constructor_callbacks_default_and_override(model):
    tokens, outcomes = [], []
    llm = LLM(model.cfg, model.params, model.plan, eos_id=-1, device="cpu",
              on_token=lambda r, t: tokens.append((r.rid, t)),
              on_outcome=lambda r, o: outcomes.append((r.rid, o.status)))
    done = llm.stream(_reqs(StreamRequest, n=2, max_new=4))
    assert len(tokens) == 8 and len(outcomes) == 2
    assert all(s == "ok" for _, s in outcomes)
    other = []
    llm.stream(_reqs(StreamRequest, n=2, max_new=4),
               on_token=lambda r, t: other.append(t))
    assert len(other) == 8 and len(tokens) == 8
    assert all(r.outcome is not None for r in done)


def test_supervisor_detector_survives_plan_swap_step_restart(model):
    rs = _fleet(model, 1, supervisor=SupervisorConfig(heartbeat_patience=2),
                replan=ReplanConfig(**REPLAN))
    done = rs.run(_reqs(StreamRequest, n=10, max_new=6, spread=4.0))
    _terminal_check(done, 10)
    st = rs.phase_stats
    assert st["replans"] >= 1
    assert st["failovers"] == 0               # swap never looked like death


def test_facade_reuses_its_fleet_and_keeps_generate(model):
    """``LLM(..., replicas=3)`` builds its ReplicaSet once; ``stream`` under
    a ``ChaosConfig`` runs it in every replica's scheduler; ``generate``
    drains on the one engine whatever ``replicas`` is."""
    llm = _llm(model, 3)
    first = llm.stream(_reqs(StreamRequest, n=4))
    fleet = llm._fleet
    again = llm.stream(_reqs(StreamRequest, n=4),
                       chaos=ChaosConfig(step_fail_chunks=(0,)))
    assert llm._fleet is fleet
    assert [r.out for r in again] == [r.out for r in first]
    assert llm.phase_stats["fleet"]["step_retries"] >= 1
    assert llm.telemetry() is fleet.telemetry
    gen = llm.generate([([3, 5, 7], 4)])
    assert len(gen[0].out) == 4 and llm._engine is not None
    assert llm.phase_stats is llm._engine.phase_stats


# ---------------------------------------------- the scheduler's outside drive
def _sched(m, **kw):
    return ContinuousBatchingScheduler(m.cfg, m.params, m.plan, eos_id=-1,
                                       device="cpu", **kw)


WALL = ("prefill_s", "decode_s", "total_wall_s")


@pytest.mark.parametrize("chaos", [None, dict(
    seed=7, ensure_fail_rate=0.3, ensure_fail_max=4, step_fail_chunks=(0,),
    step_fail_attempts=2, nan_rids={0: (2,)})], ids=["clean", "chaos"])
def test_run_equals_start_gen_ticked_to_the_end(model, chaos):
    """Arrivals at multiples of ``sync_every`` while rows are busy: the
    self-paced run and an outside caller's ticks (G += T) take the same
    boundaries."""
    def reqs():
        return [StreamRequest(i, [3 + i, 5, 7], 10, arrival=float(a))
                for i, a in enumerate((0, 0, 0, 4, 4, 8))]
    kw = dict(guard=GuardConfig(audit_every_sync=True))
    self_paced = _sched(model, **kw)
    want = self_paced.run(reqs(), chaos=ChaosConfig(**chaos) if chaos
                          else None)
    assert self_paced._live is None
    driven = _sched(model, **kw)
    gen = driven.start_gen(reqs(), chaos=ChaosConfig(**chaos) if chaos
                           else None)
    G, statuses = 0.0, []
    while True:
        statuses.append(gen.send(("tick", G)))
        G += T
        if statuses[-1]["drained"]:
            break
    with pytest.raises(StopIteration) as stop:
        gen.send(("stop", None))
    got = stop.value.value
    assert [(r.rid, r.out, _outcome(r)) for r in got] == \
        [(r.rid, r.out, _outcome(r)) for r in want]
    assert [s["clock"] for s in statuses] == [T * (i + 1) for i in
                                              range(len(statuses))]
    assert statuses[-1]["done"] == 6
    a, b = self_paced.phase_stats, driven.phase_stats
    assert {k: v for k, v in a.items() if k not in WALL} == \
        {k: v for k, v in b.items() if k not in WALL}
    assert self_paced.telemetry.tracer.signature() == \
        driven.telemetry.tracer.signature()
    assert driven._live["done"] == got       # the loop's own list


def test_inject_raises_the_reference_errors(model):
    rplan_ = rplan.plan_for_scheduler(model.rcfg, **dict(GEOMETRY,
                                                         num_pages=6))
    plan = pplan.plan_for_scheduler(model.cfg, rates=V5E,
                                    **dict(GEOMETRY, num_pages=6))
    ref = RScheduler(model.rcfg, model.rparams, rplan_, eos_id=-1,
                     guard=RGuard())
    mine = ContinuousBatchingScheduler(model.cfg, model.params, plan,
                                       eos_id=-1, device="cpu",
                                       guard=GuardConfig())
    bad = [[(0, [1, 2], 4)],                     # no run in progress
           [(1, [1, 2], 4), (1, [1, 2], 4)],     # twice in one call: fine
           [(1, [3], 4)],                        # rid known to the run
           [(2, [1] * 60, 8)],                   # past cache_len
           [(3, [1] * 20, 10)]]                  # 8 pages of a 6-page pool
    msgs = {"ref": [], "port": []}
    for side, sch, cls in (("ref", ref, RRequest),
                           ("port", mine, StreamRequest)):
        for i, batch in enumerate(bad):
            if i == 1:
                sch.start_gen([])
            try:
                sch.inject([cls(rid, p, n) for rid, p, n in batch])
                msgs[side].append(None)
            except (RuntimeError, ValueError) as e:
                msgs[side].append((type(e).__name__, str(e)))
        msgs[side].append(sorted(r.rid for r in sch._live["pending"]))
    assert msgs["port"] == msgs["ref"]
    assert msgs["port"][0][0] == "RuntimeError" and msgs["port"][1] is None
    assert all(m and m[0] == "ValueError" for m in msgs["port"][2:5])


# ------------------------------------------------------------- the release
def _resident(sch):
    loop = sch._loop
    return loop.state is not None or loop.graph is not None \
        or loop.block_table is not None or loop.nxt is not None


def test_kill_and_swap_release_the_pool_and_graph(model, monkeypatch):
    """Under a stand-in step graph (the body run at capture and replay, as
    ``StepGraph`` does): a replica killed mid-run drops its pool, decode
    state and graph while ``_live`` still harvests its stranded requests in
    (arrival, rid) order; a plan swap releases the old scheduler before the
    new one allocates; a released scheduler serves again, with a new
    capture, the same tokens."""
    monkeypatch.setattr(peng, "StepGraph", _StandInGraph)

    def replica(slot):
        rep = Replica(slot, model.cfg, model.params, model.plan, eos_id=-1,
                      temperature=0.0, guard=GuardConfig(), device="cpu")
        rep.scheduler._loop.use_graph = True
        rep.start(seed=0, sync_every=T)
        return rep
    rep = replica(0)
    assert rep.scheduler._loop.graph is not None
    rep.scheduler.inject(_reqs(StreamRequest, n=6, max_new=12))
    for G in (0.0, 4.0):
        rep.tick(G)
    live = rep.scheduler._live
    assert (len(live["active"]), len(live["waiting"]),
            len(live["pending"])) == (3, 2, 1)
    rep.kill()
    rep.state = DEAD
    assert not _resident(rep.scheduler)
    stranded = rep.harvest_unfinished()
    assert [r.rid for r in stranded] == [0, 1, 2, 3, 4, 5]
    assert any(r.out for r in stranded)     # active rows kept their tokens
    assert rep.scheduler.phase_stats["decode_chunks"] == 2

    rep = replica(1)
    rep.scheduler.inject(_reqs(StreamRequest, n=2, max_new=4))
    G = 0.0
    while not (rep.last_status and rep.last_status["drained"]):
        rep.tick(G)
        G += T
    old = rep.scheduler
    swapped = dataclasses.replace(model.plan, num_pages=12)
    rep.swap_plan(swapped, seed=1, at_clock=G)
    assert not _resident(old) and old.phase_stats["outcomes"]["ok"] == 2
    assert rep.generation == 1 and rep.scheduler.plan == swapped
    assert rep.scheduler._loop.state[0]["blocks"]
    assert len(rep.collect_done()) == 2

    sch = _sched(model)
    sch._loop.use_graph = True
    want = [r.out for r in sch.run(_reqs(StreamRequest, n=3))]
    sch.release()
    assert not _resident(sch)
    assert [r.out for r in sch.run(_reqs(StreamRequest, n=3))] == want
    assert len(sch._loop.captures) == 2


@pytest.mark.parametrize("name", ["kill", "stall", "autoscale_replan"])
def test_fleet_releases_every_replica(runs, name):
    """After a run, dead and retired replicas alike hold no device state,
    and their host-side counters still add up to the fleet's."""
    _, st, _, fleet = runs("port", name)
    assert fleet._all and all(rep.state in (DEAD, RETIRED)
                              and not _resident(rep.scheduler)
                              for rep in fleet._all)
    assert sum(rep.scheduler.phase_stats["decode_chunks"]
               for rep in fleet._all) == st["fleet"]["decode_chunks"] > 0


# -------------------------------------------------------- planning helpers
REPLAN_LENGTHS = ([9, 9, 10, 11], [30, 64, 2, 17, 40],
                  [2000, 100, 50], list(range(1, 300, 7)))


@pytest.mark.parametrize("arch,kw", PLAN_CASES + PINNED_CASES)
def test_replan_from_lengths_matches_reference(arch, kw):
    base = rplan.plan_serve(rget_config(arch), **kw)
    mine = pplan.ServePlan.from_dict(base.as_dict())
    for lengths in REPLAN_LENGTHS:
        want = rplan.replan_from_lengths(rget_config(arch), base, lengths)
        got = pplan.replan_from_lengths(get_config(arch), mine, lengths,
                                        rates=V5E)
        assert got.to_json() == want.to_json(), lengths


def test_alpha_and_replan_spec_k_match_reference():
    for k in (1, 2, 4, 8):
        for rate in (0.0, 0.1, 0.3, 0.55, 0.8, 1.0, 1.7):
            assert pplan._alpha_from_acceptance(rate, k) == \
                rplan._alpha_from_acceptance(rate, k)
    kw = dict(hbm_budget_bytes=8 << 30, expected_batch=1,
              expected_len_dist={"mean": 512, "max": 2048})
    seen = set()
    for arch in ("qwen2.5-3b", "mistral-nemo-12b", ARCH):
        base = rplan.plan_serve(rget_config(arch), **kw)
        for k in (0, 2, 4, 8):
            rbase = dataclasses.replace(base, spec_k=k)
            mine = pplan.ServePlan.from_dict(rbase.as_dict())
            for drafted, accepted in ((10, 9), (64, 64), (200, 190),
                                      (200, 120), (200, 60), (200, 20),
                                      (1000, 999)):
                want = rplan.replan_spec_k(
                    rget_config(arch), rbase, drafted_tokens=drafted,
                    accepted_tokens=accepted)
                got = pplan.replan_spec_k(
                    get_config(arch), mine, drafted_tokens=drafted,
                    accepted_tokens=accepted)
                assert got.to_json() == want.to_json(), (arch, k, drafted,
                                                          accepted)
                assert (got is mine) == (want is rbase)
                seen.add(got.spec_k)
    assert {0, 8} <= seen and len(seen) >= 3     # every branch reached
