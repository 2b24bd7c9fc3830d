"""``repro_torch.serve.LLM``: the port's serving front door.

The counterpart of ``repro.serve.LLM`` with ``stream`` only, as the reference
serves with ``guard=False`` and ``replicas=1``::

    llm = LLM(cfg, params, plan)                 # on the card
    done = llm.stream([(prompt, max_new), ...], on_token=callback)

``plan`` is a ``core.plan.ServePlan`` (``plan_for_scheduler``, or the
reference's ``as_dict()`` through ``ServePlan.from_dict``). The model runs on
the card unless ``device="cpu"`` is passed; without a CUDA device and without
that request, construction raises rather than carry on on the CPU.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.models import transformer as tfm
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         StreamRequest, resolve_device)


class LLM:
    """One model and one resolved ServePlan on one device.

    ``params`` is the reference's parameter layout (``transformer.init_params``
    or ``bridge.params_from_numpy``, optionally packed by
    ``serve.sparse.sparsify_mlp_params``). It is moved to ``device`` and every
    dense weight matrix is kept as its bf16 copy, the cast the reference
    repeats on every call. ``guard`` and ``replicas`` exist only to refuse
    what is not ported: the serving guard (outcomes, deadlines, the
    degradation ladder) and the multi-replica control plane."""

    def __init__(self, cfg, params, plan, *, eos_id: int = 1,
                 temperature: float = 0.0, device=None, guard: bool = False,
                 replicas: int = 1):
        if guard:
            raise NotImplementedError(
                "the serving guard (request outcomes, deadlines, the "
                "degradation ladder) is not ported yet")
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
        self.cfg = cfg
        self.plan = plan
        self.params = tfm.compute_copy(tfm.to_device(params, self.device))
        self._scheduler = ContinuousBatchingScheduler(
            cfg, self.params, plan, eos_id=eos_id, temperature=temperature,
            device=self.device)

    def _normalize(self, requests: Sequence,
                   on_token: Optional[Callable]) -> List[StreamRequest]:
        """StreamRequests, dicts or (prompt, max_new) pairs; rids default
        to the input position."""
        out = []
        for i, r in enumerate(requests):
            if not isinstance(r, StreamRequest):
                if isinstance(r, dict):
                    r = StreamRequest(**{"rid": i, **r})
                else:
                    prompt, max_new = r
                    r = StreamRequest(rid=i, prompt=list(prompt),
                                      max_new=int(max_new))
            if on_token is not None and r.on_token is None:
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

    def stream(self, requests: Sequence, on_token: Optional[Callable] = None,
               seed: int = 0) -> List[StreamRequest]:
        """Serve ``requests`` with continuous batching and streaming; returns
        the finished requests ordered by rid (input order for generated
        rids), ``r.out`` holding each one's tokens."""
        reqs = self._normalize(requests, on_token)
        done = self._scheduler.run(reqs, seed=seed)
        return sorted(done, key=lambda r: r.rid)

    @property
    def phase_stats(self) -> Dict:
        """Prefill/decode split and paging counters of the last run."""
        return self._scheduler.phase_stats
