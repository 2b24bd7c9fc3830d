"""One decode step captured as a CUDA graph (port-only).

The reference runs ``sync_every`` decode steps as one jitted ``lax.scan``
whose donated state is updated in place (``repro.serve.engine.DecodeEngine``,
the scheduler's paged chunk). The port's counterpart is :class:`StepGraph`:
the in-place decode step (``serve.engine.make_step_in_place``) captured once
on static buffers and replayed ``sync_every`` times per chunk (under
speculation the body is one round: k drafted candidates, one flattened
verify, the accepted prefix). The buffers are the decode state itself (the
cache, ``last``, ``pos``, ``live``, ``budget``, the draft history
``hist``), the block table of a paged plan, the conditioning sequence
``cond`` of a config with cross-attention, and the step's outputs ``nxt``
and ``emit``; the captured body ends by writing the new ``last``, ``pos``,
``live`` and ``budget`` back into their input buffers, so T replays are
the T-step chunk. A replay costs the host one graph launch
instead of the step's several thousand kernel launches.

Capture is preceded by eager warm-up steps on the capture stream: the
kernel library build, each kernel's ``cudaFuncSetAttribute``, the cached
launch plans, cuBLAS's workspace and the fused MLP's sync words
(``kernels._build.sync_words``, kept per stream) all happen at a first
call, and none of them may happen inside the capture. A capture or replay
error raises; nothing falls back to eager steps.

The kernels' Python wrappers run once, during capture, and not at replay,
so ``kernels.ops.launch_counts()`` would count the capture only. The graph
records the launches its capture made (``tally``), takes them back out of
the counters (the capture launched nothing), and adds them at every replay.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.kernels import ops

WARMUP_STEPS = 2


class StepGraph:
    """``body(params, state, nxt, emit, generator, block_table, cond)``
    captured once; :meth:`replay` runs it on the current stream.

    ``state`` = (cache, last, pos, live, budget, hist) and the other
    tensors (``cond`` (B, T, d) bf16 or None) are the graph's fixed inputs
    and outputs: the caller writes new rows, flags, tables and
    conditioning into them in place between replays and never rebinds
    them. The warm-up steps write garbage into ``state``; the
    caller resets it after construction. ``generator`` (temperature
    sampling) is registered with the graph, so each replay draws the
    numbers the next eager step from the generator's current seed and
    offset would."""

    def __init__(self, body: Callable, params, state, nxt: torch.Tensor,
                 emit: torch.Tensor, *, block_table: Optional[torch.Tensor]
                 = None, generator: Optional[torch.Generator] = None,
                 cond: Optional[torch.Tensor] = None):
        dev = state[1].device
        if dev.type != "cuda":
            raise ValueError("CUDA graphs capture work on the card only")
        args = (params, state, nxt, emit, generator, block_table, cond)
        t0 = time.perf_counter()
        self.stream = torch.cuda.Stream(dev)
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                body(*args)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        before = ops.launch_counts()
        with torch.cuda.graph(self.graph, stream=self.stream):
            body(*args)
        after = ops.launch_counts()
        ops.set_launches(before)
        self.tally = {k: after[k] - before[k] for k in after
                      if after[k] != before[k]}
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        ops.add_launches(self.tally)
