"""``repro_torch.serve.LLM``: the port's serving front door.

The counterpart of ``repro.serve.LLM`` for one replica, with the reference's
defaults: the serving guard on (``GuardConfig()``) and tracing on::

    llm = LLM(cfg, params, plan)                 # on the card
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

``plan`` is a ``core.plan.ServePlan`` (``plan_for_scheduler``,
``plan_for_engine``, or the reference's ``as_dict()`` through
``ServePlan.from_dict``). The model runs on the card unless ``device="cpu"``
is passed; without a CUDA device and without that request, construction
raises rather than carry on on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import DecodeEngine, Request, resolve_device
from repro_torch.serve.guard import GuardConfig
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         StreamRequest)
from repro_torch.serve.telemetry import Telemetry


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
    carry none. ``replicas`` exists to refuse the multi-replica control
    plane, which is not ported. The scheduler's step graph is captured at
    the first ``stream`` and the drain engine (built at the first
    ``generate``) its own; both are reused across calls.
    ``decode_graphs`` is read only on the card: False runs the eager
    decode step there."""

    def __init__(self, cfg, params, plan, *, eos_id: int = 1,
                 temperature: float = 0.0, device=None,
                 guard: Union[GuardConfig, None, bool] = None,
                 replicas: int = 1, decode_graphs: bool = True,
                 on_token: Optional[Callable] = None,
                 on_outcome: Optional[Callable] = None,
                 trace: Union[bool, Telemetry] = True):
        if replicas != 1:
            raise NotImplementedError(
                f"replicas={replicas}: the multi-replica control plane is "
                "not ported yet")
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
        self._scheduler = ContinuousBatchingScheduler(
            cfg, self.params, plan, eos_id=eos_id, temperature=temperature,
            device=self.device, graphs=decode_graphs, guard=guard,
            telemetry=self._telemetry)
        self._engine: Optional[DecodeEngine] = None
        self._last_run = None                # engine behind the last call

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
        ``serve.chaos.ChaosConfig`` for deterministic fault injection."""
        on_token = on_token if on_token is not None else self.on_token
        on_outcome = on_outcome if on_outcome is not None \
            else self.on_outcome
        reqs = self._normalize(requests, StreamRequest, on_token)
        if on_outcome is not None:
            for r in reqs:
                if r.on_outcome is None:
                    r.on_outcome = on_outcome
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
