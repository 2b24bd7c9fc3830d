"""``repro_torch.serve.LLM``: the port's serving front door.

The counterpart of ``repro.serve.LLM``, with the reference's defaults: the
serving guard on (``GuardConfig()``) and tracing on::

    llm = LLM(cfg, params)                       # on the card, default plan
    print(llm.explain())                         # the plan's rationale
    done = llm.generate([(prompt, max_new), ...])          # drain semantics
    done = llm.stream([(prompt, max_new), ...], on_token=callback)
    llm.telemetry().tracer.signature()           # the call's trace

``generate`` drains a fixed request list on the dense-slot
``engine.DecodeEngine``; ``stream`` serves arriving requests with continuous
batching over the plan's paged (or contiguous) KV layout. Both decode
through ``engine.DecodeLoop``: on the card every decode step is one replay
of a captured CUDA graph (``serve.graphs.StepGraph``) unless
``decode_graphs=False`` asks for the eager step. Under the guard every
streamed request ends with an ``outcome`` and overload walks the plan's
degradation ladder (on the card the int8 rung captures the decode step
again over the requantized pool, mid-run).

``plan`` is a ``core.plan.ServePlan`` (``plan_serve``,
``plan_for_scheduler``, ``plan_for_engine``, or the reference's
``as_dict()`` through ``ServePlan.from_dict``). Without one, ``LLM``
resolves the reference's default, ``plan_serve`` over half of the device's
memory (``rates.hbm_cap``: 40e9 B on an H100) for ``DEFAULT_BATCH`` rows of
``DEFAULT_LEN_DIST`` tokens; ``stream`` serves what it
resolves, copy-on-write prefix sharing (on for a paged plan by default) and
greedy speculative decoding (``spec_k`` >= 2) included; a plan with a
mesh (``plan_serve(..., mesh="tp=2")``) serves its shards one after
another on this device (``mesh``, ``sharding_report``). With
``replicas=N`` (N >= 2) ``stream`` serves through the fleet,
``serve.replica.ReplicaSet``: N schedulers on the one device and the one
copy of the weights, router placement, heartbeat supervision, failover,
autoscaling and re-planning as the reference's; ``generate`` keeps the one
drain engine. The model runs on the card unless ``device="cpu"``
is passed; without a CUDA device and without that request, construction
raises rather than carry on on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core.eyexam import H100_SXM, DeviceRates
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import (DecodeEngine, Request, check_servable,
                                      resolve_device, serving_refusal)
from repro_torch.serve.guard import GuardConfig
from repro_torch.serve import shard as shard_lib
from repro_torch.serve.replica import ReplicaSet
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         StreamRequest)
from repro_torch.serve.telemetry import Telemetry

DEFAULT_LEN_DIST = {"mean": 256, "max": 512}
DEFAULT_BATCH = 8


class LLM:
    """One model and one resolved ServePlan on one device.

    ``params`` is the reference's parameter layout (``transformer.init_params``
    or ``bridge.params_from_numpy``, optionally packed by
    ``serve.sparse.sparsify_mlp_params``). It is moved to ``device`` and every
    dense weight matrix is kept as its bf16 copy, the cast the reference
    repeats on every call.

    ``guard`` works as the reference's: None (the default) serves under
    ``GuardConfig()`` (as does True), False without a guard, a
    ``GuardConfig`` as given.
    ``trace`` is True (spans recorded), False (metrics only) or a shared
    ``Telemetry``; :meth:`telemetry` returns the bundle, reset at every
    call. ``on_token`` and ``on_outcome`` are defaults for requests that
    carry none. ``replicas`` below 1 raises ``ValueError``, as the
    reference's does; from 2 on ``stream`` serves through a
    ``serve.replica.ReplicaSet`` on this plan, guard, telemetry and device
    (built here, allocating nothing; each run spawns its replicas, each
    with its own pool and step graph, over the shared ``params``), and
    ``phase_stats`` / ``telemetry()`` read the fleet's.
    ``rates`` is read only without ``plan``: the default plan's budget is
    half its ``hbm_cap`` and its MLP roofline divides by its rates. The
    scheduler's step graph is captured at
    the first ``stream`` and the drain engine (built at the first
    ``generate``) its own; both are reused across calls.
    ``decode_graphs`` is read only on the card: False runs the eager
    decode step there. A config that the serving loops do not serve
    (vision patches, cross-attention, codebooks: ``engine.check_servable``)
    still gets its plan and its weights on the device, and ``stream`` and
    ``generate`` raise ``ValueError`` before any work, naming the entry
    points that serve it."""

    def __init__(self, cfg, params,
                 plan: Optional[plan_lib.ServePlan] = None, *,
                 rates: DeviceRates = H100_SXM, eos_id: int = 1,
                 temperature: float = 0.0, device=None,
                 guard: Union[GuardConfig, None, bool] = None,
                 replicas: int = 1, decode_graphs: bool = True,
                 on_token: Optional[Callable] = None,
                 on_outcome: Optional[Callable] = None,
                 trace: Union[bool, Telemetry] = True):
        if replicas < 1:
            raise ValueError(
                f"replicas must be >= 1, got {replicas}: serving always "
                "goes through at least one scheduler replica (replicas=1 "
                "is the single-scheduler fast path, replicas>=2 the "
                "fault-tolerant control plane)")
        if plan is None:
            plan = plan_lib.plan_serve(
                cfg, hbm_budget_bytes=int(rates.hbm_cap // 2),
                expected_batch=DEFAULT_BATCH,
                expected_len_dist=dict(DEFAULT_LEN_DIST), rates=rates)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the reference's precision: fp32 products (attention scores,
            # the plain versions) stay fp32, and bf16 products accumulate in
            # fp32 with one rounding at the end, never in bf16 partials
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = False
        if guard is None or guard is True:
            guard = GuardConfig()
        elif guard is False:
            guard = None
        self.guard: Optional[GuardConfig] = guard
        self.on_token = on_token
        self.on_outcome = on_outcome
        self._telemetry = trace if isinstance(trace, Telemetry) \
            else Telemetry(enabled=bool(trace))
        self.cfg = cfg
        self.plan = plan
        self.eos_id = eos_id
        self.temperature = temperature
        self.decode_graphs = decode_graphs
        self.params = tfm.compute_copy(tfm.to_device(params, self.device))
        serve = serving_refusal(cfg) is None
        self._scheduler = ContinuousBatchingScheduler(
            cfg, self.params, plan, eos_id=eos_id, temperature=temperature,
            device=self.device, graphs=decode_graphs, guard=guard,
            telemetry=self._telemetry) if serve and replicas == 1 else None
        self._fleet = ReplicaSet(
            cfg, self.params, plan, replicas=replicas, eos_id=eos_id,
            temperature=temperature, guard=guard, telemetry=self._telemetry,
            device=self.device, graphs=decode_graphs) \
            if serve and replicas > 1 else None
        self._engine: Optional[DecodeEngine] = None
        self._last_run = None                # engine behind the last call

    def explain(self) -> str:
        """The plan's per-decision Eyexam rationale."""
        return self.plan.explain()

    @property
    def mesh(self) -> shard_lib.ServeMesh:
        """The plan's resolved serving mesh (``tp=1 ep=1`` for a one-device
        plan). ``stream`` serves a sharded plan shard by shard on this
        LLM's device (``sharding.tensor_parallel``); ``generate`` (the
        single-device drain engine) refuses it."""
        return shard_lib.ServeMesh.from_plan(self.plan, self.device)

    def sharding_report(self) -> Dict:
        """The mesh and its pool: tp and ep, whether this device's backend
        has a device per shard, single- and per-device KV pool bytes, and,
        after a sharded paged ``stream``, the live per-shard occupancy and
        the lockstep divergence (``serve.shard.sharding_stats``)."""
        pool = self._scheduler.pager if self._scheduler is not None \
            else None
        return shard_lib.sharding_stats(self.cfg, self.plan, pool=pool,
                                        device=self.device)

    def _normalize(self, requests: Sequence, cls,
                   on_token: Optional[Callable] = None) -> List:
        """``cls`` objects (Request or StreamRequest), dicts or (prompt,
        max_new) pairs; rids default to the input position."""
        out = []
        for i, r in enumerate(requests):
            if isinstance(r, cls):
                pass
            elif isinstance(r, (Request, StreamRequest)):
                r = cls(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new)
            elif isinstance(r, dict):
                r = cls(**{"rid": i, **r})
            else:
                prompt, max_new = r
                r = cls(rid=i, prompt=list(prompt), max_new=int(max_new))
            if cls is StreamRequest and on_token is not None \
                    and r.on_token is None:
                r.on_token = on_token
            out.append(r)
        if len({r.rid for r in out}) != len(out):
            raise ValueError("request rids must be unique")
        if not out:
            raise ValueError("empty request list: nothing to serve")
        for r in out:
            if not r.prompt:
                raise ValueError(f"request {r.rid}: empty prompt")
            if len(r.prompt) + max(r.max_new, 0) > self.plan.cache_len:
                raise ValueError(
                    f"request {r.rid}: prompt ({len(r.prompt)}) + max_new "
                    f"({r.max_new}) exceeds the plan's cache_len "
                    f"({self.plan.cache_len})")
        return out

    def generate(self, requests: Sequence, seed: int = 0) -> List[Request]:
        """Drain ``requests`` to completion on the dense-slot
        ``DecodeEngine`` (built at the first call, then reused); returns the
        finished requests ordered by rid, ``r.out`` holding each one's
        tokens and ``r.outcome`` its ``RequestOutcome``."""
        check_servable(self.cfg)
        reqs = self._normalize(requests, Request)
        if self._engine is None:
            self._engine = DecodeEngine(
                self.cfg, self.params, self.plan, eos_id=self.eos_id,
                temperature=self.temperature, device=self.device,
                graphs=self.decode_graphs, telemetry=self._telemetry)
        self._last_run = self._engine
        self._telemetry.reset()            # one trace per call
        done = self._engine.run(reqs, seed=seed)
        return sorted(done, key=lambda r: r.rid)

    def stream(self, requests: Sequence, on_token: Optional[Callable] = None,
               seed: int = 0, on_outcome: Optional[Callable] = None,
               chaos=None) -> List[StreamRequest]:
        """Serve ``requests`` with continuous batching and streaming; returns
        the finished requests ordered by rid (input order for generated
        rids), ``r.out`` holding each one's tokens and, under the guard,
        ``r.outcome`` its terminal status. ``on_token(request, token)`` and
        ``on_outcome(request, outcome)`` apply to requests without their
        own, falling back to the constructor's. ``chaos`` takes a
        ``serve.chaos.ChaosConfig`` for deterministic fault injection or,
        with ``replicas`` >= 2, a ``ReplicaChaosConfig``."""
        check_servable(self.cfg)
        on_token = on_token if on_token is not None else self.on_token
        on_outcome = on_outcome if on_outcome is not None \
            else self.on_outcome
        reqs = self._normalize(requests, StreamRequest, on_token)
        if on_outcome is not None:
            for r in reqs:
                if r.on_outcome is None:
                    r.on_outcome = on_outcome
        if self._fleet is not None:
            self._last_run = self._fleet     # it resets the telemetry itself
            return self._fleet.run(reqs, seed=seed, chaos=chaos)
        self._last_run = self._scheduler
        self._telemetry.reset()            # one trace per call
        done = self._scheduler.run(reqs, seed=seed, chaos=chaos)
        return sorted(done, key=lambda r: r.rid)

    @property
    def phase_stats(self) -> Dict:
        """Phase stats of the most recently run entry point (prefill/decode
        split, paging counters, the guard's outcomes and drift)."""
        return self._last_run.phase_stats if self._last_run is not None \
            else {}

    def telemetry(self) -> Telemetry:
        """The Telemetry bundle of the most recent call: ``.tracer`` (spans
        on the virtual step clock), ``.metrics`` (the frozen-key registry)
        and ``.last_drift`` (the drift report against the plan)."""
        return self._telemetry
