#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: require CUDA (no CPU fallback); print the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compile the port's CUDA kernels from the sources in this checkout
   (one nvcc per source, all started together);
3. kernels: hold each of the six kernels against its plain PyTorch version
   at the shapes the main paths give it (qwen2.5-3b, gemma2-2b,
   mistral-nemo-12b and gemma3-12b widths), with the tolerance stated beside
   each, and time the kernel, the plain version and, where one exists, the
   single PyTorch call that computes the same function (CUDA events around
   the device's work, L2 flushed before each launch). Per model
   (``phase_kernels_model``, ``MODEL_KERNEL_SHAPES``): paged attention at
   the pass's rows and head ratio, fp pages and, for gemma3-12b, int8 pages
   at head_dim 256, against SDPA over gathered pages; the fused MLP at the
   decode rows and the largest prefill batch its plan routes to it,
   against the dense bf16 MLP through cuBLAS; the BCSC GEMM at a long
   prompt's M (and at 48 rows, past the 12 B models' fused-MLP boundary of
   32) against ``torch.matmul`` on the dense bf16 weight, with its plan and
   its bound in bytes and in operations; each also for equal bits on a
   second call. At qwen2.5-3b widths the GEMM is also held against its
   plain version at the edges of its tiles (16 and 48 rows, an odd number
   of block-columns, pads, columns with no block, a K split), the fused MLP
   at M 8 and 64, rs_matmul at M 512 and 8 against ``addmm`` + gelu, the
   GEMV at the up (bias + silu) and down projections against ``addmm`` +
   silu and ``torch.matmul``. The sliding window runs at every served
   model's prefill shapes (gemma3-12b's 1024 window at head_dim 256 with no
   softcap among them, mixtral-8x7b's 4096 window at 32 heads over 8) and
   at head ratios 5, 6 and 10 (llama4, internvl2-26b and recurrentgemma-2b
   heads), causal and in window mode; its chunk mode (llama4's chunked
   attention) at llama4's attention shape (40 heads over 8, S 16384, two
   chunks of 8192: time, plain time, SDPA with a block-diagonal causal
   mask, bound) and where chunk starts fall inside key tiles. At the
   frontend models' shapes (``phase_kernels_frontends``): the ungated
   fused MLP at musicgen-large's widths (tanh-gelu, 2048 -> 8192 -> 2048)
   at M 4 and its plan's fused maximum (128) against the dense bf16
   ``gelu(x·w1)·w2`` through cuBLAS, the GEMM at musicgen's prefill rows
   (M 1024, w1 and w2) against ``torch.matmul``, the fused MLP at
   internvl2-26b's (silu, 6144 -> 16384 -> 6144) at M 4, and the sliding
   window causal at musicgen's 32 / 32 heads of 64 over 4096 positions
   against SDPA with a boolean causal mask. The training kernels
   (``phase_kernels_backward``, ``BACKWARD_SHAPES``): the sliding window's
   log-sum-exp against the plain one, its output the same bits with and
   without it (both timed), and the flash backward kernel's dq, dk, dv
   against its plain version at qwen2.5-3b's causal, gemma2-2b's local
   (softcap, D 256), llama4's chunked and musicgen's (D 64) shapes, timed
   beside the plain version, its bound and SDPA's backward where SDPA
   computes the same function. Their query-offset mode
   (``phase_kernels_seqshard``, ``SEQSHARD_SHAPES``: qwen2.5-3b causal,
   S 2048 in 4 shards of 512, and gemma2-2b local, S 8192 in 8 shards):
   each shard of the query rows against the whole K and V, both kernels
   against their plain versions at the same offset, the shards' forward
   rows, lse and dq bit for bit the whole launch's, their summed dk and
   dv within 1e-5 of it; each shard timed beside the shards' sum and the
   whole launch.
   Paged attention's tensor-parallel shards (``phase_kernels_shards``,
   ``SHARD_KERNEL_SHAPES``): at gemma2-2b's fp and qwen2.5-3b's int8
   decode shapes, two launches over the unsliced pools (``kv_offset``,
   split as for all heads), concatenated, must equal one launch bit for
   bit, also split as the speculative verifier splits (``split_rows``),
   and the plain version at 1e-4; one shard is timed beside its bound, its plain version and SDPA over its gathered
   pages, against the launch over all heads.
   Each kernel's launch configuration (paged attention's split, the
   sliding window's blocks, stages and shared memory, the fused MLP's
   grid, rings and phase-2 split, the GEMV's grid, split and rings,
   rs_matmul's arm and units) is printed beside the compiler's registers
   and spills;
4. serve qwen2.5-3b: full width and depth, random weights from a seed, MLPs
   packed at 0.75 block sparsity. First the first prefill and decode logits
   of the kernel path are held against the plain path; then 12 requests go
   through ``LLM.stream`` on paged fp KV (sliding-window attention, paged
   attention, the fused MLP and the GEMM must have run), then 4 requests on
   int8 KV pages with the two-call MLP route (the GEMV and GEMM arms), then
   8 requests of 64 new tokens through ``LLM.generate`` on
   ``plan_for_engine(slots=8, cache_len=1024)`` (the drain engine's
   contiguous cache); between them the sharded pass (``_sharded_pass``)
   at tp=2 on int8 pages and the GEMV route;
   every serve pass runs under ``LLM``'s defaults, the serving guard
   (``GuardConfig()``) and the tracer;
5. serve qwen2.5-3b guarded (``phase_serve_guarded``, on the model phase 4
   loaded): the fp pass's requests through the default ``LLM`` and a
   guard-less, untraced one (``guard=False, trace=False``) in turns, graphed,
   with equal streams and both rates printed (over the decode spans and
   over each run's wall time), then one more run of each in a profiler
   trace: the card ran one device-to-host copy per decode chunk; a
   pressure pass on ``PRESSURE_PAGES`` pages (rows 8, cache 1024, page 64;
   12 prompts of 130-511 tokens at steps 0/8/16, 32 new tokens) where the
   int8 rung fires at a boundary with live rows: every outcome ok,
   ``kv_quant`` int8 from the printed step on, the graphed run's step
   captured again over the int8 pools (both captures' seconds and the
   pass's peak memory printed), paged attention launching exactly once per
   global layer per decode step on both sides of the rung (plus each
   capture's warm-up), and a fresh eager run giving the same streams with
   one device-to-host copy per chunk; a chaos pass (``audit_every_sync``,
   ``CHAOS``: ensure failures, a transient step fault, a NaN on rid 2):
   every request terminal, no audit violation, survivors equal to the
   clean run, rid 2 failed as non-finite, as many device-to-host copies as
   ``host_syncs``, and the same trace signature from two graphed runs and
   an eager one;
6. serve qwen2.5-3b with prefix sharing and speculation
   (``phase_serve_prefix_spec``, on the same model): ``verify_step`` of 8
   candidates against 8 sequential steps on the kernel path; a sharing
   pass (rows 8, cache 1024, page 64; 12 requests behind one 448-token
   system prompt, the last two the same whole prompt, at steps 0/8/16, 32
   new tokens) with ``share_prefix`` on (the default plan) and off,
   graphed then eager, in turns: equal streams, fewer pages in use at
   peak with sharing, a copy on write; a speculation pass on
   ``plan_serve(expected_batch=1)`` (``SPEC_BUDGET``), whose ``spec``
   rule picks k: prompts {5, 64, 300, 511}, 64 new tokens, graphed and
   eager, against the same plan pinned ``spec_k=0`` (graphed), in turns:
   streams equal or parted only at near-ties (top-2 margin under
   ``NEAR_TIE`` of max |logit|), paged attention once per global layer
   per round, the acceptance rate and decode tokens/s printed; a resume
   pass on ``RESUME_PAGES`` pages with a guard without the int8 rung:
   preemptions, suffix-only resumes through the verifier (the GEMM
   launching in them), streams equal (or parted at near-ties) to a fully
   provisioned run;
7. the front door (``phase_front_door``, on the same model):
   ``LLM(cfg, params)`` with no plan and no other argument must resolve
   ``plan_serve`` over 40e9 B (half the H100's memory) for 8 rows of up to
   512 tokens, paged; its ``explain()`` is printed in full; 8 requests
   (``FRONT_LENS``, ``FRONT_NEW`` new tokens) stream through it graphed,
   eager, graphed: every outcome ok, equal streams, equal launch counts,
   paged attention, the fused MLP and the sliding window launched; the
   plan's Eyexam prediction of the fused MLP at H100 rates is printed
   beside the kernel phase's measured time, and the card's memory beside
   ``H100_SXM.hbm_cap``; then ``ops.bcsc_matmul`` (M ``SPARSE_ROWS``, bare
   and with bias + silu, a forced tile) and ``ops.bcsc_gemv`` at the up
   projection, each against its plain version and dense ``torch.matmul``,
   the GEMV kernel at M <= 8 and the GEMM above;
8. the fleet (``phase_fleet``, on the same model): ``LLM(cfg, params,
   plan, replicas=3)`` over ``plan_for_scheduler(rows 4, cache 1024, page
   64)`` per replica, 12 requests (``FLEET_LENS``, the second six on the
   first six's first page, request i arriving at step i, ``FLEET_NEW`` new
   tokens): one replica against the fleet (equal streams or partings at
   near-ties), the fleet graphed and eager (equal), the card's
   device-to-host copies equal to the replicas' decode chunks, one capture
   per replica, paged attention once per global layer per decode step and
   capture warm-up step; replica 0 killed at ``FLEET_KILL`` (one failover,
   every outcome ok, the never-migrated requests equal to the fault-free
   fleet, the migrated ones equal or parted at near-ties, the allocated
   memory falling by at least the dead replica's own tensors), replica 1
   stalled at ``FLEET_STALL`` (caught by the heartbeat); per-replica pool
   and capture time, the router's affinity hits and the fleet's decode
   rate against one replica's printed;
9. serve gemma2-2b, mistral-nemo-12b and gemma3-12b, each at full width and
   depth after the previous model was freed, with the same logits and
   per-layer checks:
   gemma2-2b (26 layers alternating local and global attention, softcaps):
   6 requests of up to 6000 prompt tokens through ``LLM.stream`` on paged
   fp KV: prefill runs the sliding-window kernel in window mode in the
   local layers, decode past position 4096 wraps the local rings;
   mistral-nemo-12b (40 global layers, an untied head): 12 requests of up
   to 3500 prompt tokens through ``LLM.stream`` (rows 8, cache 4096), then
   8 requests through ``LLM.generate`` on ``plan_for_engine(slots=8,
   cache_len=4096)``;
   gemma3-12b (48 layers, five local of window 1024 to one global,
   qk-norm, two RoPE thetas): 6 requests of up to 7000 prompt tokens
   through ``LLM.stream`` (rows 4, cache 8192), every ring longer than
   1024 wrapping in decode, then 4 requests on int8 KV pages on the
   default MLP route;
   every request must return its budget of in-vocabulary tokens;
   gemma2-2b then serves a sharded pass at tp=2 (``_sharded_pass``: the
   plan of the pass's geometry from ``plan_serve`` with ``mesh="tp=2"``
   and without a mesh, under ``LLM``'s defaults, graphed, in turns: equal
   streams, paged attention once per shard per global layer per decode
   step and everything else as on one device, one device-to-host copy a
   chunk, no lockstep divergence, per-device pool bytes of 1/tp, the
   ``collective_*`` counters equal to ``chunk_collectives``' model, decode
   tokens/s and the graphed step's device ms of both);
   every pass of 4 and 8 runs three times in turns (``_turns``): with the
   decode step captured as a CUDA graph (the first run captures it), with
   the eager step (``decode_graphs=False``), with the graph again. The
   three must give equal streams token for token, and the last run (the
   main path's: launch counts zeroed just before, read just after) the
   eager run's launch counts exactly, with paged attention once per global
   layer per decode step (``core.plan.num_global_layers``), the MLP kernel
   at least once per layer per step and, on the stream passes of 8, the
   sliding window once per layer per prefill batch. Each pass prints
   prefill and decode tokens/s in both modes, the graphed step's device
   time (CUDA events around 16 replays), its kernels' busy time and the
   three pairs of kernels with the most idle time between them (a profiler
   trace of 16 more), the capture time and the peak of device memory;
   each load prints its own peak;
10. serve the recurrent architectures (``phase_serve_recurrent``), after
    gemma3-12b was freed, at full width and depth on the contiguous plans
    their lack of a global layer resolves to (no page pool, no int8 rung,
    exact-length prefill buckets): recurrentgemma-2b (26 layers: 8
    periods of two RG-LRU layers and one local of window 2048, then two
    RG-LRU; MLPs packed at 0.75): the first prefill and decode logits of
    the kernel path against ``impl="plain"`` at 2 x ``RGEMMA_CHECK``
    tokens (past the window), then 8 requests through ``LLM.stream``
    (rows 4, cache 4096; prompts up to 3000, so window-mode prefill and
    ring wrap; two exact-length buckets of two in the second wave) and 4
    through ``LLM.generate`` on ``plan_for_engine(slots=4,
    cache_len=4096)``, each in turns (``_turns``): the sliding window once
    per local layer per prefill batch, the fused MLP at least once per
    layer per decode step, the GEMM three times per layer on each prefill
    batch past ``mlp_fused_m_max``, paged attention never; mamba2-130m (24
    SSD layers, no MLP): 8 requests through ``LLM.stream`` (rows 8, cache
    2048; prompts 5-2000, the primes 509 and 1021 among them) in turns,
    with no port kernel launched, then one prompt of each length prefilled
    alone: its ms, its SSD chunk and the peak of device memory;
11. serve mixtral-8x7b (``phase_serve_moe``), after the recurrent models
    were freed, at full width and ``MIXTRAL_LAYERS`` (6) of its 32 layers
    (all 32 hold 90e9 B of bf16 experts, more than one card): every layer
    sliding-window attention (window 4096) and an MoE MLP of 8 experts,
    top-2, the experts dense bf16 (the reference packs no expert); the
    load's peak; the first prefill and decode logits of the kernel path
    against ``impl="plain"`` at prompts of 300 and 5000 tokens (tier 8192:
    window-mode prefill, the sort dispatch at capacity 2560); 8 requests
    through ``LLM.stream`` (rows 4, cache 8192; prompts of up to 5000
    tokens at steps 0 and 8, so decode wraps the rings) and 4 through
    ``LLM.generate`` on ``plan_for_engine(slots=4, cache_len=8192)``, each
    in turns (``_turns``): the sliding window once per layer per prefill
    batch and no other port kernel (the expert products are torch matrix
    products); the graphed step's device time beside its bound (every
    expert's weights read per step, as the reference's dense decode reads
    them); then its sharded pass at tp=2,ep=4 (``_sharded_pass``, the
    rings' attention in two halves, the experts in four slices);
12. serve the frontend architectures (``phase_serve_frontends``), after
    mixtral was freed, through ``serve.engine.make_generate_fn`` (the
    serving loops do not serve them, as the reference's do not):
    musicgen-large at full width and depth (48 layers; each attention
    layer followed by cross-attention to 64 conditioning embeddings from
    ``models.frontend.synth_cond_embeds``; four codebooks, sinusoidal
    positions, ungated tanh-gelu MLPs packed at 0.75), passes
    ``MUSICGEN_PASSES`` (4 rows x 256 tokens x 4 codebooks, 128 new; 1 x
    4000, 32 new), and internvl2-26b at full width and its published
    ``INTERNVL_LAYERS`` (48) layers, built one layer at a time
    (``serve.sparse.build_sparse_params``: its fp32 tree would not fit the
    card), 256 patches from ``synth_patch_embeds`` before the text, passes
    ``INTERNVL_PASSES`` (4 x 64, 32 new; 1 x 1024, 16 new); each load's
    peak and resident memory; the first pass's prefill and first decode
    logits, kernels against ``impl="plain"`` (5e-2); per pass
    (``_frontend_pass``) a graphed call (which captures the decode step),
    a ``graphs=False`` call and a graphed call that replays: their tokens
    equal bit for bit, the replaying call's launches exactly as the plan's
    routes give them (the sliding window once per layer per prefill at
    head dims 64 and 128, the GEMM 2 (musicgen) or 3 (internvl2) per layer
    per prefill past the fused route, the fused MLP, ungated for musicgen,
    once per layer per decode step, paged attention, the GEMV and
    ``rs_matmul`` never), the device-to-host copies of a fourth call equal
    to its prefill's alone, the greedy streams of the kernel path and the
    plain path equal or parted at near-ties; prefill and decode tokens/s
    graphed and eager, the graphed decode's wall per step beside one
    decode step's device ms (captured as a CUDA graph) and its bound, the
    capture's seconds;
13. train qwen2.5-3b (``phase_train``), after the frontends were freed, at
    published width and depth (36 layers, 3.09e9 fp32 parameters and
    their AdamW state on the card): one forward and backward with the
    kernels against one with ``impl="plain"`` attention (loss within
    1e-3, global grad norm within 1e-2), then ``TRAIN_WARMUP`` +
    ``TRAIN_STEPS`` steps of ``train.loop.make_train_step`` (remat
    ``TRAIN_REMAT``, the reference's AdamW defaults) on one repeated
    synthetic batch of ``TRAIN_SEQ`` tokens: the loss finite and falling,
    tokens/s against the step's bound, the peaks of device memory; the
    timed steps launch the sliding window twice (the forward and its
    recomputation) and the flash backward once per layer per step, no
    other kernel and never a plain version; then one step at remat
    "none" and its peak;
14. train qwen2.5-3b on a mesh (``phase_train_mesh``): the same model on a
    logical ``TrainMesh(data=2, model=4)`` on this card (the plan
    fsdp_tp, ``make_hints``; attention sequence-sharded in 4, since 2 KV
    heads do not divide 4), batch ``MESH_BATCH`` x ``TRAIN_SEQ``, remat
    ``TRAIN_REMAT``: loss and global grad norm against the one-device step
    on the same batch (1e-3 / 1e-2), then the mesh and one-device steps in
    turns (tokens/s, peaks), the mesh step's attention launches exact (4
    shards x 36 layers x 2 forward, 4 x 36 backward) and no plain
    version; then the int8 error-feedback data-parallel step
    (``train.grad_compression``) at data=2 on ``DP_LAYERS`` of the 36
    layers, one repeated sequence a replica (the loss falls over
    ``DP_STEPS`` steps, the residuals finite and nonzero, the payload
    bytes a step); then an elastic round trip (``phase_elastic``): one
    step at data=2 under the Supervisor, whose ``CheckpointManager``
    saves it, and ``runtime.elastic.restore_elastic`` at data=1 (every
    tensor equal, the specs the data=1 plan's);
15. train over processes (``phase_train_dist``, ``sharding.dist``): the
    kernels built once here before any rank starts; qwen2.5-3b at
    published width and ``DIST_LAYERS`` (8) of its 36 layers (the memory
    reckoned and checked against the card first), one ``TRAIN_SEQ`` row a
    replica, ``DIST_STEPS`` steps a side: in this process the compressed
    DP step on ``TrainMesh(data=2)``, the plain step on the whole batch
    and the plain step's two rows' gradients summed in one process
    (losses, grad norms and each state leaf's SHA-256 kept on the host,
    the card freed); then two gloo ranks sharing the card run the
    compressed and the plain DP step (``dist.spawn``): the compressed
    state, each rank's residual slot and the losses equal the one-process
    step's, the plain state equal to the row-split sum's on both ranks,
    its first loss and grad norm within 1e-3 / 1e-2 of the whole batch's,
    every rank's attention launches exact (the forward 2 and the backward
    1 a layer a step) and no plain version;
    then an NCCL group of one in this process, whose plain step equals the
    group-less one bit for bit; with two or more cards, min(cards,
    ``DIST_CARDS``) NCCL ranks, a card each: the compressed step against
    one process's at ``DIST_LAYERS``, and the plain step at full depth
    against each card's whole-batch step in turns (gaps, launches,
    params equal on every card, tokens/s); on one card a line says that
    part did not run. Tokens/s of both sides and every rank's peak;
16. the dry-run's cells (``phase_cells``): qwen2.5-3b at published width
    and depth, its prefill (1 x 32768), decode (16 rows on a 32768-token
    contiguous cache, at its last position) and train (1 x 2048, remat
    "full") cells built by ``launch.cell.build_cell`` on a one-card mesh,
    their arguments materialised on the card from a seed: the arguments'
    bytes equal ``launch.dryrun.run_cell``'s record, one step of each
    launches exactly the sliding window once per layer (prefill), nothing
    (decode), or the sliding window twice and the flash backward once per
    layer (train), the peak of device memory is at least the record's
    arguments + outputs - aliases, the prefill cell's logits at 2048
    tokens within 5e-2 of ``impl="plain"``; each step's ms by CUDA events
    beside the record's roofline time and fraction;
17. report: prefill and decode tokens/s, the wall time of each phase, one
    JSON line describing every kernel, the card's name and power limit,
    then the contract line.

``rs_matmul`` is on no model path (as in the reference), so it launches only
in the kernel phase and reports 0 launches on the main path.

Exits non-zero, printing no result, when there is no CUDA device or when run
outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
SLEEP_CYCLES = 2_000_000           # ~1 ms of device time ahead of each timed call
SEED = 0
ARCH = "qwen2.5-3b"
GEMMA = "gemma2-2b"
# the gemma2 pass: plan geometry, prompt lengths (three arrive at step 0,
# three at step 8), the two prompts of the logits check, tokens per request
GEMMA_PLAN = dict(rows=4, cache_len=8192, page_size=64)
GEMMA_LENS = (7, 300, 1500, 4100, 4700, 6000)
GEMMA_CHECK = (300, 4700)
GEMMA_NEW = 24
# the qwen2.5-3b generate pass (plan_for_engine(slots=8, cache_len=1024))
GENERATE_LENS = (5, 37, 64, 130, 300, 511, 700, 900)
GENERATE_NEW = 64
# the mistral-nemo-12b passes: the stream pass's plan, prompts (four arrive
# at each of steps 0, 8 and 16) and tokens per request; the logits check's
# two prompts; the generate pass's prompts (plan_for_engine(slots=8,
# cache_len=4096)) and tokens per request
NEMO = "mistral-nemo-12b"
NEMO_PLAN = dict(rows=8, cache_len=4096, page_size=64)
NEMO_LENS = (5, 64, 300, 1000, 2000, 3500) * 2
NEMO_NEW = 32
NEMO_CHECK = (300, 1000)
NEMO_GENERATE_LENS = (5, 37, 130, 511, 900, 1500, 2000, 3000)
NEMO_GENERATE_NEW = 32
# the gemma3-12b passes: plan, prompts (three at step 0, three at step 8),
# tokens per request, the logits check's prompts (past the 1024 window);
# then the int8-KV pass's prompts (all at step 0) and tokens per request
GEMMA3 = "gemma3-12b"
GEMMA3_PLAN = dict(rows=4, cache_len=8192, page_size=64)
GEMMA3_LENS = (7, 300, 1000, 1500, 4100, 7000)
GEMMA3_NEW = 24
GEMMA3_CHECK = (300, 1500)
GEMMA3_INT8_LENS = (5, 1100, 3000, 6000)
GEMMA3_INT8_NEW = 8
# the guarded qwen2.5-3b phase: the pressure pass's pool (the int8 rung
# fires at step 16 with 8 live rows, after two graphed chunks), prompts
# (four arrive at each of steps 0, 8 and 16) and tokens per request; the
# chaos pass's prompts, tokens per request and fault schedule
PRESSURE_PAGES = 44
PRESSURE_LENS = (130, 511, 300, 220, 400, 160, 480, 256, 350, 190, 511, 275)
PRESSURE_NEW = 32
CHAOS_LENS = (5, 37, 64, 130, 300, 511, 700, 900)
CHAOS_NEW = 16
CHAOS = dict(seed=7, ensure_fail_rate=0.3, ensure_fail_max=4,
             step_fail_chunks=(1,), step_fail_attempts=2, nan_rids={0: (2,)})
# the prefix-sharing and speculation phase (qwen2.5-3b): the system prefix
# all sharing-pass prompts start with (7 pages of 64), their distinct
# suffixes (the last two prompts are the same whole prompt, so an append
# copies the shared tail page), four arriving at each of steps 0, 8 and 16,
# and tokens per request; the speculation pass's prompts, tokens per request
# and the HBM budget handed to plan_serve; the resume pass's suffixes
# (behind the same prefix, all at step 0), tokens per request and pool
SHARED_PREFIX = 448
SHARED_SUFFIXES = (5, 37, 64, 130, 200, 17, 90, 150, 23, 111, 77, 77)
SHARED_NEW = 32
SPEC_LENS = (5, 64, 300, 511)
SPEC_NEW = 64
SPEC_BUDGET = 8 << 30
RESUME_SUFFIXES = (180, 120, 150, 200, 100, 170, 130, 160)
RESUME_NEW = 32
RESUME_PAGES = 30
# the plan-less front door (``LLM(cfg, params)``, its default plan: 8 rows
# of up to 512 tokens): prompt lengths and new tokens of its pass, and the
# rows of the general sparse entry points at the up projection's widths
FRONT_LENS = (5, 37, 64, 130, 300, 448, 90, 200)
FRONT_NEW = 32
SPARSE_ROWS = (1, 8, 16, 48)
# the fleet phase (qwen2.5-3b, ``LLM(..., replicas=FLEET_REPLICAS)``): each
# replica's plan geometry, the prompt lengths (the second six start with the
# first 64-token page of the first six's prompts where both hold one), new
# tokens per request (request i arrives at step i), the step of the kill
# of replica 0 and of the stall of replica 1
FLEET_REPLICAS = 3
FLEET_PLAN = dict(rows=4, cache_len=1024, page_size=64)
FLEET_LENS = (5, 37, 64, 130, 300, 511) * 2
FLEET_NEW = 32
FLEET_KILL = 16.0
FLEET_STALL = 16.0
# a greedy parting is a near-tie when the top-2 logit margin at it is under
# this share of max |logit| (tests/torch_dense_parity.py's LOGIT_TOL)
NEAR_TIE = 1e-2
# the recurrent phase: recurrentgemma-2b's stream pass (rows, cache; prompts,
# the first four at step 0 and the last four, two exact-length buckets of
# two, at step 8; 3000 is past the 2048 window), its logits check (rows of
# one exact length past the window) and its generate pass (4 slots, prompts
# at step 0); then mamba2-130m's stream pass (all at step 0; 509 and 1021
# are prime, so their SSD prefill runs chunks of 1)
RGEMMA = "recurrentgemma-2b"
RGEMMA_PLAN = dict(rows=4, cache_len=4096)
RGEMMA_LENS = (5, 37, 511, 3000, 64, 300, 64, 300)
RGEMMA_NEW = 32
RGEMMA_CHECK = 2100
RGEMMA_GENERATE_LENS = (5, 64, 511, 3000)
MAMBA = "mamba2-130m"
MAMBA_PLAN = dict(rows=8, cache_len=2048)
MAMBA_LENS = (5, 37, 256, 509, 512, 1021, 1024, 2000)
MAMBA_NEW = 32
# the mixtral-8x7b phase: full width at MIXTRAL_LAYERS of its 32 layers (all
# 32 do not fit one card: 90e9 B of bf16 experts); the stream pass's plan,
# prompts (four at step 0, four at step 8: 5000 is past the 4096 window,
# 8192 its tier) and tokens per request; the logits check's two prompts;
# the generate pass's prompts (plan_for_engine(slots=4, cache_len=8192))
MIXTRAL = "mixtral-8x7b"
MIXTRAL_LAYERS = 6
MIXTRAL_PLAN = dict(rows=4, cache_len=8192)
MIXTRAL_LENS = (5, 37, 300, 511, 2000, 5000, 64, 300)
MIXTRAL_NEW = 32
MIXTRAL_CHECK = (300, 5000)
MIXTRAL_GENERATE_LENS = (5, 300, 2000, 5000)
# the sharded passes (``_sharded_pass``): prompts and new tokens
SHARDED_GEMMA_LENS = (300, 1500, 4100, 6000)
SHARDED_MIXTRAL_LENS = (37, 300, 2000, 5000)
SHARDED_QWEN_LENS = (5, 130, 300, 511, 64, 37, 900, 222)
SHARDED_NEW = 24
# llama4's chunked attention in the kernel phase: its attention heads
# (40 over 8 KV heads of 128) at two chunks of 8192, and a shape whose
# chunk starts (96, 192, 288) fall inside 64-key tiles
LLAMA4_CHUNK = (1, 16384, 40, 8, 128, 8192)
CHUNK_EDGE = (2, 300, 40, 8, 128, 96)
# the frontend phase: musicgen-large at its 48 layers, conditioned on its
# 64 embeddings, internvl2-26b at full width and its published 48 layers
# (built one layer at a time: all 48 in fp32 would be 79.4e9 B at
# initialisation), 256 patches before each prompt; each model's make_generate_fn passes as (rows, prompt tokens
# per row, new tokens per row; a musicgen token is a step of its four
# codebooks), their plan geometry; the kernel phase's musicgen GEMM rows
# (the first pass's prefill, 4 x 256) and sliding-window length
MUSICGEN = "musicgen-large"
MUSICGEN_PLAN = dict(rows=4, cache_len=4096, page_size=64)
MUSICGEN_PASSES = ((4, 256, 128), (1, 4000, 32))
INTERNVL = "internvl2-26b"
INTERNVL_LAYERS = 48
INTERNVL_PLAN = dict(rows=4, cache_len=2048, page_size=64)
INTERNVL_PASSES = ((4, 64, 32), (1, 1024, 16))
MUSICGEN_GEMM_M = 1024
MUSICGEN_SWA_S = 4096
# the serve phases' device; a CPU rehearsal of their control flow sets
# DEVICE = "cpu", the reduced archs and smaller gemma2 geometry
# the training phase (phase_train): qwen2.5-3b at published width and depth,
# one synthetic sequence of TRAIN_SEQ tokens a step (batch 1), repeated;
# TRAIN_WARMUP + TRAIN_STEPS AdamW steps at the reference's defaults, remat
# TRAIN_REMAT; the kernel phase's backward shapes (B, S, H, KV, D, window,
# chunk, softcap): qwen2.5-3b causal, gemma2-2b local, llama4's chunks,
# musicgen's heads of 64
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_SEQ = 2048
TRAIN_WARMUP = 2
TRAIN_STEPS = 5
TRAIN_REMAT = "full"
# phase_train's attention gradients, kernels vs plain, per layer and leaf:
# normwise and elementwise of max. On an H100 the worst of both is qwen's
# bk of layer 0 (1.5e-2, 2.2e-2): the softmax is blind to a key bias but
# for RoPE's rotation, so its gradient is a sum that nearly cancels.
ATTN_GRAD_TOL = (5e-2, 1e-1)
BACKWARD_SHAPES = {
    "qwen2.5-3b causal": (1, 2048, 16, 2, 128, 2048, 0, 0.0),
    "gemma2-2b local": (1, 8192, 8, 4, 256, 4096, 0, 50.0),
    "llama4 chunked": (1, 16384, 40, 8, 128, 16384, 8192, 0.0),
    "musicgen-large causal": (1, 4096, 32, 32, 64, 4096, 0, 0.0),
}
# the query-offset mode (sequence-sharded training attention): (B, S, H,
# KV, D, window, softcap, shards); qwen's is the mesh step's, gemma2's
# local layers shard in 8 (its 4 KV heads do not divide 8)
SEQSHARD_SHAPES = {
    "qwen2.5-3b causal": (2, 2048, 16, 2, 128, 2048, 0.0, 4),
    "gemma2-2b local": (1, 8192, 8, 4, 256, 4096, 50.0, 8),
}
# phase_train_mesh: the mesh, its batch rows (of TRAIN_SEQ tokens), the
# timed steps a side in turns; the compressed DP step's depth (24 of 36
# layers: at data=2 it holds ~26 B a parameter, 80.3e9 B at 36) and steps;
# the elastic round trip's depth (full width)
MESH = dict(data=2, model=4)
MESH_BATCH = 2
MESH_STEPS = 3
DP_LAYERS = 24
DP_STEPS = 4
ELASTIC_LAYERS = 1
# phase_train_dist: data-parallel ranks (``sharding.dist``) at DIST_LAYERS
# of 36 layers (one process's compressed step at data=2 holds ~26 B a
# parameter, a rank ~23 B: 0.93e9 parameters, two ranks 43 GB of one card),
# one TRAIN_SEQ row a rank, DIST_STEPS steps a side (the first untimed); at
# most DIST_CARDS ranks across cards; a collective's and the ranks' time
# limits (s)
DIST_LAYERS = 8
DIST_STEPS = 2
DIST_CARDS = 4
DIST_TIMEOUT_S = 120.0
DIST_JOIN_S = 300.0
# phase_cells: the dry-run's cells of qwen2.5-3b at published width and
# depth on a one-card mesh; (name, kind, seq_len, global_batch)
CELL_ARCH = "qwen2.5-3b"
CELL_SHAPES = (("prefill_32k-b1", "prefill", 32768, 1),
               ("decode_32k-b16", "decode", 32768, 16),
               ("train_2k-b1", "train", 2048, 1))
CELL_CHECK_SEQ = 2048       # the prefill logits against impl="plain"
CELL_REPS = 2               # timed runs a cell, after one warm-up
DEVICE = "cuda"
BLOCK_BYTES = 16 * 16 * 2 + 4      # one packed bf16 block and its row id

KERNELS = (   # name, source, the TPU kernel it replaces
    ("paged_attention", "src/repro_torch/kernels/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:125"),
    ("bcsc_mlp", "src/repro_torch/kernels/csrc/bcsc_mlp.cu",
     "src/repro/kernels/bcsc_mlp.py:219"),
    ("bcsc_matmul", "src/repro_torch/kernels/csrc/bcsc_matmul.cu",
     "src/repro/kernels/bcsc_matmul.py:93"),
    ("bcsc_gemv", "src/repro_torch/kernels/csrc/bcsc_matmul.cu",
     "src/repro/kernels/bcsc_matmul.py:160"),
    ("sliding_window_attention",
     "src/repro_torch/kernels/csrc/local_attention.cu",
     "src/repro/kernels/local_attention.py:82"),
    ("rs_matmul", "src/repro_torch/kernels/csrc/rs_matmul.cu",
     "src/repro/kernels/rs_matmul.py:52"),
    # no TPU kernel: the backward of the reference's flash custom VJP
    ("flash_backward", "src/repro_torch/kernels/csrc/flash_backward.cu",
     "src/repro/models/flash.py:132"),
)


class SmokeFailure(RuntimeError):
    pass


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------------ timing
def time_ms(fn, flush, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each after the L2
    cache was flushed (on the serving path every layer streams other
    weights and pages in between, so a kernel finds its inputs cold).
    Warmed up first; CUDA events. The card is held busy (``_sleep``) while
    the host enqueues the call, so that the events time the device's work
    and not the host's launch overhead, which a call shorter than that
    overhead would otherwise measure."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(n_bytes: float, n_flops: float):
    """Least time on the card: the bytes the function must move over the
    memory rate, against its operations over the bf16 tensor-core peak.
    Returns (ms, "bytes" | "operations")."""
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = n_flops / BF16_FLOP_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def errors(got, want):
    """(max |got - want|, that over max |want|)."""
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / max(float(want.float().abs().max()), 1e-30)


def row_errors(got, want):
    """max over rows (all but the last axis) of max |got - want| over the
    row's max |want|: each row against its own magnitude."""
    diff = (got.float() - want.float()).abs().amax(-1)
    return float((diff / want.float().abs().amax(-1).clamp_min(1e-30)).max())


class Judge:
    """Collects every tolerance check; the run fails if any missed."""

    def __init__(self):
        self.failures = []

    def __call__(self, name, err, tol, why):
        ok = err <= tol
        log(f"  {name}: error {err:.3e} (tolerance {tol:.0e}: {why}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)

    def check(self, name, ok, what):
        log(f"  {name}: {what} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)


# ------------------------------------------------------------------ phases
def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: the port's kernels run on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; {card}")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products stay fp32
    torch.backends.cudnn.allow_tf32 = False
    return card


PTXAS = {}   # kernel name -> (registers, spill line), from the build log


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    log_path = lib.with_suffix(".log")
    if log_path.exists():
        # one line per kernel: its name and template arguments, registers,
        # stack and spills (nvcc -Xptxas -v)
        name = spill = ""
        for line in log_path.read_text().splitlines():
            if line.startswith("=="):
                log(f"  ptxas: {line}")
            elif "Function properties for" in line:
                mangled = line.rsplit(" ", 1)[-1]
                rest = mangled.split("repro", 1)[-1]
                n = re.match(r"\d+", rest)   # the name's length prefix
                base = rest[n.end():n.end() + int(n.group())] if n else rest
                args = re.findall(r"L[ib](\d+)E", mangled)
                name = base + (f"<{', '.join(args)}>" if args else "")
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = re.search(r"Used (\d+) registers", line)
                PTXAS[name] = (regs.group(1) if regs else "?", spill)
                log(f"  ptxas: {name}: {PTXAS[name][0]} registers; {spill}")


def _packed_weight(K, N, sparsity, gen, empty=(), pad=0):
    """A random (K, N) weight block-pruned and packed as the serving path
    packs it. ``empty``: block-columns zeroed and left with no block at all
    (``pack_weight`` would give each an explicit zero block); ``pad``: zero
    blocks appended that repeat the last (row, col), as ``pad_packed``
    makes them."""
    import torch
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import bcsc_matmul as bm
    from repro_torch.serve.sparse import pack_weight, pad_packed
    w = torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5
    w = sp.block_magnitude_prune(w, sparsity, 16, 16)
    if not empty:
        packed = pack_weight(w, 16, 16, torch.bfloat16)
    else:
        for c in empty:
            w[:, 16 * c:16 * (c + 1)] = 0
        m = sp.bcsc_encode(w, 16, 16)
        packed = {"blocks": m.blocks.bfloat16(), "row_ids": m.row_ids,
                  "col_ids": bm.expand_col_ptr(m.col_ptr),
                  "col_ptr": m.col_ptr,
                  "nnzb": torch.tensor(m.blocks.shape[0], dtype=torch.int32,
                                       device=w.device)}
    return pad_packed(packed, packed["blocks"].shape[0] + pad)


def _gemm_line(tag, x, w, N, cu, plain, flush):
    """Time the GEMM, its plain version and ``torch.matmul`` on the dense
    bf16 weight at one shape; returns (record, log line)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import bcsc_matmul as bm
    M, K = x.shape
    nnz = int(w["nnzb"])
    wdense = bm._dense_weight(w["blocks"], w["row_ids"], w["col_ids"], K,
                              N).bfloat16()
    n_bytes = x.numel() * 2 + nnz * BLOCK_BYTES + M * N * 4
    n_flops = 2 * M * 256 * nnz
    rec = dict(ms=time_ms(cu, flush), plain_ms=time_ms(plain, flush),
               library_ms=time_ms(lambda: torch.matmul(x, wdense), flush),
               bound=bound(n_bytes, n_flops),
               shape=f"M {M}, {K} -> {N}, {nnz} blocks")
    bm_, split = bm.gemm_plan(M, K, N, _build.sm_count(0))
    grid = (-(-(N // 16) // bm.GEMM_GROUP), -(-M // bm_), split)
    ms, by = rec["bound"]
    line = (f"bcsc_matmul ({tag}: {rec['shape']}; plan bm {bm_}, split "
            f"{split}, grid {grid[0]} x {grid[1]} x {grid[2]}): "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
            f"torch.matmul (dense bf16) {rec['library_ms']:.4f} ms, bound "
            f"{ms:.4f} ms ({by}; bytes {bound(n_bytes, 0)[0]:.4f}, "
            f"operations {bound(0, n_flops)[0]:.4f})")
    return rec, line


def _split_line(B, KV, MP):
    """The paged-attention kernel's split of a call on this card."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    pages, n_split = pa.split_plan(B, KV, MP, n_sm)
    return (f"paged_attention split: B {B} x KV {KV} x n_split {n_split} = "
            f"{B * KV * n_split} blocks on {n_sm} SMs, pages_per_split "
            f"{pages} (table of {MP} pages), then one combine block per "
            "(row, KV head)")


def _sdpa_over_pages(q, k_pool, v_pool, bt, lengths):
    """Library yardstick for paged attention: the pages gathered to dense
    K/V once, outside the timing, then one SDPA call with a length mask and
    no softcap (SDPA cannot take one). Returns the call to time."""
    import torch
    import torch.nn.functional as F
    B, KV, R, D = q.shape
    ps, MP = k_pool.shape[1], bt.shape[1]
    T = MP * ps
    pages = bt.clamp_min(0).long()
    kd = k_pool[pages].reshape(B, T, KV, D).permute(0, 2, 1, 3)
    vd = v_pool[pages].reshape(B, T, KV, D).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(R, 1).contiguous()
    vd = vd.repeat_interleave(R, 1).contiguous()
    qd = q.reshape(B, KV * R, 1, D)
    mask = (torch.arange(T, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)


def _mlp_line(tag, x, M, packs, counts, ff, act, flush, judge):
    """Hold the fused MLP against its plain version on x (rows M, zero rows
    past M to the kernel's multiple of 8), check that two calls give equal
    bits, and time the kernel, the plain version and the dense bf16 MLP
    through cuBLAS on the decoded weights; returns (record, log line).
    ``packs`` is (gate, up, down), up None for an ungated MLP."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import bcsc_matmul as bm
    from repro_torch.kernels import bcsc_mlp as bmlp
    wg, wu, wd = packs
    Mp, d = x.shape
    n_real = int(counts.sum())

    def trip(p, key):
        return None if p is None else (p["blocks"], p["row_ids"], p[key])

    def cu():
        return bmlp.bcsc_mlp_cuda(
            x, trip(wg, "col_ptr"), trip(wu, "col_ptr"), trip(wd, "col_ptr"),
            counts, d_ff=ff, n_out=d, activation=act)

    def plain():
        return bmlp.bcsc_mlp_plain(
            x, trip(wg, "col_ids"), trip(wu, "col_ids"), trip(wd, "col_ids"),
            counts, d_ff=ff, n_out=d, activation=act)
    got = cu()
    abs_err, rel = errors(got[:M], plain()[:M])
    judge(f"bcsc_mlp[{tag}: M={M}, {act}]", rel, 2e-3,
          "relative to max |out|: an fp32 sum in another order can flip "
          "the bf16 rounding of a hidden value, 2^-8 of it")
    judge.check(f"bcsc_mlp[{tag}: M={M}]: the same bits on a second run",
                bool(torch.equal(got, cu())), "fixed sum order")
    wdense = torch.cat([bm._dense_weight(*trip(p, "col_ids"), d, ff)
                        for p in (wg, wu) if p is not None], 1).bfloat16()
    wdown = bm._dense_weight(*trip(wd, "col_ids"), ff, d).bfloat16()
    xm = x[:M]

    def act_fn(v):
        return F.silu(v) if act == "silu" else F.gelu(v, approximate="tanh")

    def library():
        gu = torch.matmul(xm, wdense)
        h = act_fn(gu) if wu is None else act_fn(gu[:, :ff]) * gu[:, ff:]
        return torch.matmul(h, wdown)
    rec = dict(max_abs_err=abs_err, ms=time_ms(cu, flush),
               plain_ms=time_ms(plain, flush),
               library_ms=time_ms(library, flush),
               bound=bound(M * d * 2 + n_real * BLOCK_BYTES + M * d * 4,
                           2 * M * 256 * n_real),
               shape=f"{tag}: M {M}, {d} -> {ff} -> {d}, {act}"
                     f"{'' if wu is not None else ' (ungated)'}, {n_real} "
                     "real blocks")
    lc = bmlp.launch_config(Mp, ff, d, _build.sm_count(0))
    ms, by = rec["bound"]
    line = (f"bcsc_mlp ({rec['shape']}; launch {lc['grid']} blocks x "
            f"{lc['threads']} threads, {lc['row_tiles']} row tiles of 8, "
            f"{lc['stages']}-slot rings, {lc['smem_bytes']} bytes of shared "
            f"memory a block; phase 1 {lc['phase1_columns']} hidden columns "
            f"over {lc['phase1_pairs']} warp pairs, phase 2 "
            f"{lc['phase2_tasks']} parts, split {lc['split']}): "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, dense bf16 "
            f"MLP (cuBLAS) {rec['library_ms']:.4f} ms, bound {ms:.4f} ms "
            f"({by})")
    return rec, line


def _gemv_line(tag, x, M, w, N, act, bias, flush, judge):
    """Hold the GEMV against its plain version on x (8 rows, zero past M),
    check that two calls give equal bits, and at M 8 time the kernel, its
    plain version and one library call (``addmm`` + the activation, or
    ``torch.matmul``, on the dense bf16 weight); returns (record or None,
    log line)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import bcsc_matmul as bm
    K = x.shape[1]

    def cu():
        return bm.bcsc_gemv_cuda(x, w["blocks"], w["row_ids"], w["col_ptr"],
                                 n_out=N, bias=bias, activation=act)

    def plain():
        return bm.bcsc_gemv_plain(x, w["blocks"], w["row_ids"], w["col_ids"],
                                  n_out=N, bias=bias, activation=act)
    got = cu()
    abs_err, rel = errors(got[:M], plain()[:M])
    what = f"bcsc_gemv[{tag}: M={M}, {act or 'no activation'}]"
    judge(what, rel, 1e-4, "relative to max |out|: fp32 sums of the same "
          "bf16 products in another order")
    judge.check(f"{what}: the same bits on a second run",
                bool(torch.equal(got, cu())), "fixed sum order")
    if M != 8:
        return None, ""
    nnz = int(w["nnzb"])
    wdense = bm._dense_weight(w["blocks"], w["row_ids"], w["col_ids"], K,
                              N).bfloat16()
    if act is None:
        library, lib_name = (lambda: torch.matmul(x, wdense)), "torch.matmul"
    else:
        library, lib_name = (lambda: F.silu(torch.addmm(
            bias.bfloat16(), x, wdense))), "addmm + silu"
    rec = dict(max_abs_err=abs_err, ms=time_ms(cu, flush),
               plain_ms=time_ms(plain, flush),
               library_ms=time_ms(library, flush),
               bound=bound(x.numel() * 2 + nnz * BLOCK_BYTES
                           + (0 if bias is None else N * 4) + 8 * N * 4,
                           2 * 8 * 256 * nnz),
               shape=f"{tag}: M 8, {K} -> {N}, "
                     f"{'bias + ' + act if act else 'no bias or activation'}"
                     f", {nnz} blocks")
    plan = bm.gemv_plan(K, N, _build.sm_count(0))
    regs, spill = PTXAS.get("bcsc_gemv_kernel", ("?", "not in the log"))
    ms, by = rec["bound"]
    line = (f"bcsc_gemv ({rec['shape']}; launch {plan['grid']} blocks x "
            f"{plan['threads']} threads, split {plan['split']} "
            f"({plan['tasks']} parts, one a warp), {plan['stages']}-slot "
            f"rings, {plan['smem_bytes']} bytes of shared memory a block; "
            f"ptxas {regs} registers, {spill}): {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, {lib_name} (dense bf16) "
            f"{rec['library_ms']:.4f} ms, bound {ms:.4f} ms ({by})")
    return rec, line


def phase_kernels(flush, judge, records):
    """Each kernel against its plain version at the shapes the main path
    gives it; fills ``records[name]``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import bcsc_matmul as bm
    from repro_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = get_config(ARCH)
    d, ff = cfg.d_model, cfg.d_ff
    log("kernels: each against its plain version at qwen2.5-3b widths")

    # ---- paged attention: B 8, KV 2, R 8, D 128, ps 64, ragged to 1024
    B, KV, D, ps, MP = 8, cfg.num_kv_heads, cfg.head_dim, 64, 16
    R = cfg.num_heads // KV
    lengths = torch.tensor([1024, 1, 63, 64, 65, 300, 777, 1000],
                           dtype=torch.int32, device=dev)
    P = B * MP
    bt = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    bt = bt.reshape(B, MP).clone()
    for b in range(B):
        bt[b, -(-int(lengths[b]) // ps):] = -1        # never-touched tail
    q = torch.randn(B, KV, R, D, generator=gen, device=dev).bfloat16()
    tokens = int(lengths.sum())
    for mode in ("fp", "int8"):
        if mode == "fp":
            kw = dict(k_pool=torch.randn(P, ps, KV, D, generator=gen,
                                         device=dev).bfloat16(),
                      v_pool=torch.randn(P, ps, KV, D, generator=gen,
                                         device=dev).bfloat16())
            sc = {}
        else:
            kw = dict(k_pool=torch.randint(-127, 128, (P, ps, KV, D),
                                           generator=gen, device=dev,
                                           dtype=torch.int8),
                      v_pool=torch.randint(-127, 128, (P, ps, KV, D),
                                           generator=gen, device=dev,
                                           dtype=torch.int8))
            sc = dict(k_scale=torch.rand(P, KV, generator=gen, device=dev) * 4,
                      v_scale=torch.rand(P, KV, generator=gen, device=dev) * 4)
        args = (q, kw["k_pool"], kw["v_pool"], bt, lengths)
        abs_err, _ = errors(pa.paged_attention_cuda(*args, **sc),
                            pa.paged_attention_plain(*args, **sc))
        torch.cuda.synchronize()
        judge(f"paged_attention[{mode}]", abs_err, 1e-4,
              "absolute on outputs of order 1: fp32 online softmax vs one "
              "masked softmax, sums in another order")
        if mode != "fp":
            continue
        n_bytes = (q.numel() * 2 + 2 * tokens * KV * D * 2 + bt.numel() * 4
                   + B * 4 + B * KV * R * D * 4)
        log("  " + _split_line(B, KV, MP))
        records["paged_attention"] = dict(
            max_abs_err=abs_err,
            ms=time_ms(lambda: pa.paged_attention_cuda(*args), flush),
            plain_ms=time_ms(lambda: pa.paged_attention_plain(*args), flush),
            library_ms=time_ms(_sdpa_over_pages(*args), flush),
            bound=bound(n_bytes, 4 * tokens * KV * R * D),
            shape=f"B {B}, KV {KV}, R {R}, D {D}, ps {ps}, {tokens} tokens")

    for tag, rows, k, start in (("verify, rows 1 x k 8", 1, 8, 511),
                                ("verify, rows 8 x k 8", 8, 8, 300),
                                ("resume, 1 row x 256 suffix", 1, 256, 448)):
        log("  " + _virtual_line(cfg, tag, rows, k, start, gen, flush,
                                 judge))

    # ---- fused MLP: M 8 (the decode step at rows 8) and 64 (the largest
    # prefill batch it takes), K 2048, d_ff 11008, sparsity 0.75
    wg = _packed_weight(d, ff, 0.75, gen)
    wu = _packed_weight(d, ff, 0.75, gen)
    wd = _packed_weight(ff, d, 0.75, gen)
    counts = torch.stack([wg["nnzb"], wu["nnzb"], wd["nnzb"]])
    for M in (8, 64):
        x = torch.randn(M, d, generator=gen, device=dev).bfloat16()
        rec, line = _mlp_line("qwen2.5-3b", x, M, (wg, wu, wd), counts, ff,
                              "silu", flush, judge)
        log(f"  {line}")
        if M == 8:          # the JSON line keeps the decode shape
            records["bcsc_mlp"] = rec

    # ---- GEMM (prefill, M 512: up and down), then its edges: tiles past
    # M, an odd number of block-columns, pads, columns with no block
    why = ("relative to max |out|: tensor-core fp32 accumulation of the "
           "same bf16 products in another order")
    lines = []
    edges = {"M 16": (16, d, ff, {}), "M 48": (48, d, d, {}),
             "N / 16 odd": (64, d, ff + 16, {}),
             "padded pack": (512, d, d, dict(pad=40)),
             "empty columns": (128, d, d, dict(empty=(0, 77, d // 16 - 1))),
             "split K, M 16": (16, ff, d, dict(pad=3))}
    cases = [("up", 512, d, ff, wg), ("down", 512, ff, d, wd)] + [
        (tag, M, K, N, _packed_weight(K, N, 0.75, gen, **kw))
        for tag, (M, K, N, kw) in edges.items()]
    for name, M, K, N, w in cases:
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()

        def cu():
            return bm.bcsc_matmul_cuda(x, w["blocks"], w["row_ids"],
                                       w["col_ptr"], n_out=N)

        def plain():
            return bm.bcsc_matmul_plain(x, w["blocks"], w["row_ids"],
                                        w["col_ids"], n_out=N)
        got = cu()
        abs_err, rel = errors(got, plain())
        torch.cuda.synchronize()
        judge(f"bcsc_matmul[{name}: {M}x{K}->{N}]", rel, 1e-3, why)
        if name in ("up", "down"):
            judge.check(f"bcsc_matmul[{name}]: the same bits on a second run",
                        bool(torch.equal(got, cu())), "fixed sum order")
            rec, line = _gemm_line(f"qwen2.5-3b {name}", x, w, N, cu, plain,
                                   flush)
            lines.append(line)
            if name == "up":    # the JSON line keeps PR 13's shape
                records["bcsc_matmul"] = dict(rec, max_abs_err=abs_err)
        del x, got
    for line in lines:
        log(f"  {line}")
    # ---- GEMV (the int8 pass's two-call MLP at decode): the up projection
    # with bias + silu (M 1 and 8), the down projection bare (M 8)
    bias = torch.randn(ff, generator=gen, device=dev)
    for name, M, K, N, w, act, b in (
            ("up", 1, d, ff, wg, None, None),
            ("up", 8, d, ff, wg, "silu", bias),
            ("down", 8, ff, d, wd, None, None)):
        x = torch.zeros(8, K, device=dev, dtype=torch.bfloat16)
        x[:M] = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        rec, line = _gemv_line(f"qwen2.5-3b {name}", x, M, w, N, act, b,
                               flush, judge)
        if rec is not None:
            log(f"  {line}")
            if name == "up":    # the JSON line keeps the up projection
                records["bcsc_gemv"] = rec


# the paged-attention, fused-MLP and GEMM shapes each served model's pass
# gives the kernels: arch -> (plan geometry, paged-attention row lengths,
# KV formats, fused-MLP rows, GEMM rows)
MODEL_KERNEL_SHAPES = {
    GEMMA: (GEMMA_PLAN, (6000, 7, 4724, 1523), ("fp",), (4, 64), (8192,)),
    NEMO: (NEMO_PLAN, (3532, 5, 332, 1032, 2032, 96, 3000, 1500), ("fp",),
           (8, 32), (4096, 48)),
    GEMMA3: (GEMMA3_PLAN, (7024, 31, 4124, 1524), ("fp", "int8"), (4, 32),
             (8192, 48)),
}


# paged attention's shards: arch, geometry, lengths, pages, tp
SHARD_KERNEL_SHAPES = (
    (GEMMA, GEMMA_PLAN, MODEL_KERNEL_SHAPES[GEMMA][1], "fp", 2),
    (ARCH, dict(rows=8, cache_len=1024, page_size=64),
     (1024, 1, 63, 64, 65, 300, 777, 1000), "int8", 2),
)


def _virtual_line(cfg, tag, rows, k, start, gen, flush, judge):
    """Paged attention at the flattened verifier's shape: ``rows`` real
    rows of 16 pages of 64, each repeated as ``k`` virtual rows of lengths
    start + 1 .. start + k, the split taken as for the real rows
    (``split_rows``), as ``decoding.verify_step`` calls it: held against
    the plain version and timed; the bound reads each page once."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device("cuda")
    KV, D, ps, MP = cfg.num_kv_heads, cfg.head_dim, 64, 16
    R, P = cfg.num_heads // KV, rows * MP
    bt = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    bt = bt.reshape(rows, MP).repeat_interleave(k, dim=0).contiguous()
    lengths = (start + 1 + torch.arange(k, device=dev)).repeat(rows) \
        .to(torch.int32)
    q = torch.randn(rows * k, KV, R, D, generator=gen,
                    device=dev).bfloat16()
    kp, vp = (torch.randn(P, ps, KV, D, generator=gen, device=dev)
              .bfloat16() for _ in range(2))
    args = (q, kp, vp, bt, lengths)

    def cu():
        return pa.paged_attention_cuda(*args, split_rows=rows)

    def plain():
        return pa.paged_attention_plain(*args)
    abs_err, _ = errors(cu(), plain())
    judge(f"paged_attention[{tag}]", abs_err, 1e-4, "absolute on outputs of "
          "order 1: fp32 online softmax vs one masked softmax, sums in "
          "another order")
    tokens = rows * (start + k)
    n_bytes = (q.numel() * 2 + 2 * tokens * KV * D * 2 + bt.numel() * 4
               + rows * k * 4 + q.numel() * 4)
    ms, by = bound(n_bytes, 4 * int(lengths.sum()) * KV * R * D)
    pages, n_split = pa.split_plan(rows, KV, MP, _build.sm_count(0))
    return (f"paged_attention ({tag}: {rows * k} virtual rows, KV {KV}, R "
            f"{R}, D {D}, lengths {start + 1}-{start + k}, split as for "
            f"{rows} rows: {pages} pages x {n_split}): "
            f"{time_ms(cu, flush):.4f} ms, plain {time_ms(plain, flush):.4f}"
            f" ms, SDPA over gathered pages "
            f"{time_ms(_sdpa_over_pages(*args), flush):.4f} ms, bound "
            f"{ms:.4f} ms ({by})")


def _paged_args(cfg, geometry, lengths, kv, gen):
    """Paged attention's inputs at a model's decode shape (its pass's rows,
    ragged lengths, a random block table with never-touched tails), fp or
    int8 pages. Returns ((q, k_pool, v_pool, table, lengths), the scales
    (none for fp), the pools dequantized to bf16, bytes per element)."""
    import torch
    dev = torch.device("cuda")
    KV, D, ps = cfg.num_kv_heads, cfg.head_dim, geometry["page_size"]
    R, MP = cfg.num_heads // KV, geometry["cache_len"] // ps
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    B, P = len(lengths), len(lengths) * MP
    bt = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    bt = bt.reshape(B, MP).clone()
    for b in range(B):
        bt[b, -(-int(lengths[b]) // ps):] = -1
    q = torch.randn(B, KV, R, D, generator=gen, device=dev).bfloat16()
    shape = (P, ps, KV, D)
    if kv == "fp":
        kp = torch.randn(shape, generator=gen, device=dev).bfloat16()
        vp = torch.randn(shape, generator=gen, device=dev).bfloat16()
        return (q, kp, vp, bt, lengths), {}, (kp, vp), 2
    kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                       dtype=torch.int8)
    sc = dict(k_scale=torch.rand(P, KV, generator=gen, device=dev) * 4,
              v_scale=torch.rand(P, KV, generator=gen, device=dev) * 4)
    deq = tuple((p.float() * s[:, None, :, None] / 127).bfloat16()
                for p, s in ((kp, sc["k_scale"]), (vp, sc["v_scale"])))
    return (q, kp, vp, bt, lengths), sc, deq, 1


def _paged_line(cfg, geometry, lengths, kv, gen, flush, judge):
    """Paged attention at a model's decode shape (``_paged_args``): held
    against the plain version, equal bits on a second call, timed against
    the plain version, SDPA over gathered (dequantized) pages and the
    bound; returns the log line."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    args, sc, (kd, vd), elem = _paged_args(cfg, geometry, lengths, kv, gen)
    q, kp, vp, bt, lengths = args
    B, KV, R, D = q.shape
    MP = bt.shape[1]
    cap = cfg.attn_logit_softcap
    log("  " + _split_line(B, KV, MP))

    def cu():
        return pa.paged_attention_cuda(*args, softcap=cap, **sc)

    def plain():
        return pa.paged_attention_plain(*args, softcap=cap, **sc)
    got = cu()
    abs_err, _ = errors(got, plain())
    what = (f"paged_attention[{cfg.name}: {kv}, D {D}, R {R}, B {B}, "
            f"softcap {cap:g}]")
    judge(what, abs_err, 1e-4, "absolute on outputs of order 1: fp32 online "
          "softmax vs one masked softmax, sums in another order")
    judge.check(f"{what}: the same bits on a second run",
                bool(torch.equal(got, cu())), "fixed split and combine order")
    tokens = int(lengths.sum())
    n_bytes = (q.numel() * 2 + 2 * tokens * KV * D * elem + bt.numel() * 4
               + B * 4 + B * KV * R * D * 4
               + (2 * B * MP * KV * 4 if sc else 0))
    ms, by = bound(n_bytes, 4 * tokens * KV * R * D)
    sdpa = _sdpa_over_pages(q, kd, vd, bt, lengths)
    return (f"paged_attention ({cfg.name}: {kv} pages, B {B}, KV {KV}, R "
            f"{R}, D {D}, softcap {cap:g}, {tokens} tokens): "
            f"{time_ms(cu, flush):.4f} ms, plain {time_ms(plain, flush):.4f} "
            f"ms, SDPA over gathered pages (no softcap) "
            f"{time_ms(sdpa, flush):.4f} ms, bound {ms:.4f} ms ({by})")


def _shard_line(cfg, geometry, lengths, kv, tp, gen, flush, judge):
    """Paged attention split over ``tp`` KV-head shards, as a sharded
    decode step launches it: shard s reads heads [s KV/tp, (s + 1) KV/tp)
    of the unsliced pools (``kv_offset``) with the split of the launch over
    all heads. The shards concatenated must equal one launch bit for bit,
    also at the speculative verifier's split (``split_rows`` 1: the rows
    as one real row's virtual rows), and the plain version at 1e-4; one
    shard is timed
    beside its bound, its plain version and SDPA over its gathered pages,
    against the launch over all heads. Returns the log line."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    args, sc, (kd, vd), elem = _paged_args(cfg, geometry, lengths, kv, gen)
    q, kp, vp, bt, lens = args
    B, KV, R, D = q.shape
    per, MP, cap = KV // tp, bt.shape[1], cfg.attn_logit_softcap

    def full(rows=None):
        return pa.paged_attention_cuda(*args, softcap=cap, split_rows=rows,
                                       **sc)

    def shard(s, rows=None):
        qs = q[:, s * per:(s + 1) * per].contiguous()
        return lambda: pa.paged_attention_cuda(
            qs, kp, vp, bt, lens, softcap=cap, kv_offset=s * per,
            split_rows=rows, **sc)
    what = f"paged_attention[{cfg.name}: {kv}, tp {tp} shards]"
    for rows in (None, 1):
        got = torch.cat([shard(s, rows)() for s in range(tp)], dim=1)
        judge.check(f"{what}: the shards concatenated equal one launch bit "
                    f"for bit, split as for {rows or B} rows",
                    bool(torch.equal(got, full(rows))),
                    f"{tp} launches of {per} KV heads vs one of {KV}")
    abs_err, _ = errors(got, pa.paged_attention_plain(*args, softcap=cap,
                                                      **sc))
    judge(what, abs_err, 1e-4, "absolute on outputs of order 1: fp32 online "
          "softmax vs one masked softmax, sums in another order")
    tokens = int(lens.sum())
    n_sm = _build.sm_count(0)

    def bound_of(heads):
        n_bytes = (B * heads * R * D * 2 + 2 * tokens * heads * D * elem
                   + bt.numel() * 4 + B * 4 + B * heads * R * D * 4
                   + (2 * B * MP * heads * 4 if sc else 0))
        return bound(n_bytes, 4 * tokens * heads * R * D)
    (s_ms, s_by), (f_ms, f_by) = bound_of(per), bound_of(KV)
    pages, n_split = pa.split_plan(B, KV, MP, n_sm)
    own = pa.split_plan(B, per, MP, n_sm)
    q0 = q[:, :per].contiguous()       # shard 0: pool heads [0, per)

    def plain0():
        return pa.paged_attention_plain(q0, kp, vp, bt, lens, softcap=cap,
                                        kv_offset=0, **sc)
    sdpa0 = _sdpa_over_pages(q0, kd[:, :, :per], vd[:, :, :per], bt, lens)
    return (f"paged_attention shard ({cfg.name}: {kv} pages, tp {tp}: {per} "
            f"of {KV} KV heads a launch, B {B}, R {R}, D {D}, softcap "
            f"{cap:g}, {tokens} tokens; split as for {KV} heads: {pages} "
            f"pages x {n_split} (its own heads would give {own[0]} x "
            f"{own[1]})): one shard {time_ms(shard(0), flush):.4f} ms (bound "
            f"{s_ms:.4f} ms, {s_by}; plain {time_ms(plain0, flush):.4f} ms; "
            f"SDPA over its gathered pages, no softcap "
            f"{time_ms(sdpa0, flush):.4f} ms), the launch over all heads "
            f"{time_ms(full, flush):.4f} ms (bound {f_ms:.4f} ms, {f_by})")


def phase_kernels_shards(flush, judge):
    """Paged attention's tensor-parallel shards (``_shard_line``) at
    gemma2-2b's fp decode shape (4 KV heads, head_dim 256, softcap) and
    qwen2.5-3b's int8 one (2 KV heads, the serve pass's rows 8, cache
    1024), tp 2 each; returns the log lines."""
    import torch
    from repro_torch.configs import get_config
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    log("kernels: paged attention in tensor-parallel shards")
    lines = [_shard_line(get_config(arch), geometry, lengths, kv, tp, gen,
                         flush, judge)
             for arch, geometry, lengths, kv, tp in SHARD_KERNEL_SHAPES]
    for line in lines:
        log(f"  {line}")
    return lines


def phase_kernels_model(flush, judge, arch):
    """Paged attention, the fused MLP and the GEMM at the shapes ``arch``'s
    pass gives them (``MODEL_KERNEL_SHAPES``), each against its plain
    version with the tolerance used at qwen2.5-3b shapes and for equal bits
    on a second call; returns the log lines of their times (the JSON line
    keeps the qwen2.5-3b shapes)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import bcsc_matmul as bm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cfg = get_config(arch)
    geometry, pa_lengths, formats, mlp_rows, gemm_rows = \
        MODEL_KERNEL_SHAPES[arch]
    d, ff = cfg.d_model, cfg.d_ff
    act = "silu" if cfg.mlp_act == "silu" else "gelu"
    log(f"kernels: paged attention, fused MLP and GEMM at {arch} widths")
    lines = [_paged_line(cfg, geometry, pa_lengths, kv, gen, flush, judge)
             for kv in formats]

    # ---- fused MLP (decode at the pass's rows, and the largest prefill
    # batch the plan routes to it)
    wg = _packed_weight(d, ff, 0.75, gen)
    wu = _packed_weight(d, ff, 0.75, gen)
    wd = _packed_weight(ff, d, 0.75, gen)
    counts = torch.stack([wg["nnzb"], wu["nnzb"], wd["nnzb"]])
    for M in mlp_rows:
        # the kernel takes rows in eights: fewer come zero-padded, as
        # kernels.ops pads them
        x = torch.zeros(-(-M // 8) * 8, d, device=dev, dtype=torch.bfloat16)
        x[:M] = torch.randn(M, d, generator=gen, device=dev).bfloat16()
        lines.append(_mlp_line(arch, x, M, (wg, wu, wd), counts, ff, act,
                               flush, judge)[1])

    # ---- GEMM at the prefill's M (one long prompt's tier; 48 rows, the
    # first multiple of 16 past a fused-MLP boundary of 32)
    for M in gemm_rows:
        for name, K, N, w in (("up", d, ff, wg), ("down", ff, d, wd)):
            x = torch.randn(M, K, generator=gen, device=dev).bfloat16()

            def cu():
                return bm.bcsc_matmul_cuda(x, w["blocks"], w["row_ids"],
                                           w["col_ptr"], n_out=N)

            def plain():
                return bm.bcsc_matmul_plain(x, w["blocks"], w["row_ids"],
                                            w["col_ids"], n_out=N)
            got = cu()
            what = f"bcsc_matmul[{arch}: {M}x{K}->{N}]"
            judge(what, errors(got, plain())[1], 1e-3,
                  "relative to max |out|: tensor-core fp32 accumulation of "
                  "the same bf16 products in another order")
            judge.check(f"{what}: the same bits on a second run",
                        bool(torch.equal(got, cu())), "fixed sum order")
            lines.append(_gemm_line(f"{arch} {name}", x, w, N, cu, plain,
                                    flush)[1])
            del x, got
    for line in lines:
        log(f"  {line}")
    return lines


def band_pairs(S: int, window: int) -> int:
    """(query, key) pairs of a causal window over S positions."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


# head ratios R = H / KV that do not divide the kernel's 64-row tile, at the
# head counts and head dims of the reference's configs: (H, KV, D)
SWA_RATIOS = {"llama4 40/8": (40, 8, 128), "internvl2-26b 48/8": (48, 8, 128),
              "recurrentgemma-2b 10/1": (10, 1, 256)}


def _swa_ratios(flush, judge):
    """The sliding-window kernel at R 5, 6 and 10 (tiles with dead rows),
    causal and in window mode, S and the window not multiples of the
    64-key tile, against its plain version; times the kernel."""
    import torch
    from repro_torch.kernels import local_attention as swa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    B, S = 1, 2000
    for tag, (H, KV, D) in SWA_RATIOS.items():
        q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()
        lc = swa.launch_config(B, S, H, KV, D)
        for window, cap in ((S, 0.0), (1000, 50.0)):
            def cu(window=window, cap=cap):
                return swa.sliding_window_attention_cuda(
                    q, k, v, window=window, softcap=cap)
            want = swa.sliding_window_attention_plain(q, k, v, window=window,
                                                      softcap=cap)
            mode = "causal" if window >= S else f"window {window}"
            judge(f"sliding_window_attention[{tag}, R {H // KV}, {mode}, "
                  f"softcap {cap:g}]", errors(cu(), want)[1], 1e-3,
                  "relative to max |out|: keys walked in another order than "
                  "flash's, tensor-core sums in their own")
            pairs = band_pairs(S, window)
            ms, by = bound(2 * B * S * H * D + 2 * 2 * B * S * KV * D
                           + 4 * B * S * H * D, 4 * B * pairs * H * D)
            log(f"  sliding_window_attention ({tag}: B {B}, S {S}, H {H}, "
                f"KV {KV}, D {D}, {mode}, softcap {cap:g}; {lc['blocks']} "
                f"blocks, tiles of {lc['per_tile']} positions x {H // KV} "
                f"heads, {lc['dead_rows']} dead rows of 64): "
                f"{time_ms(cu, flush):.4f} ms, bound {ms:.4f} ms ({by})")
            del want
        del q, k, v


def chunk_pairs(S: int, chunk: int) -> int:
    """(query, key) pairs of causal attention within chunks of ``chunk``
    positions over S positions."""
    full, rest = divmod(S, chunk)
    return full * chunk * (chunk + 1) // 2 + rest * (rest + 1) // 2


def _swa_chunks(flush, judge, records):
    """The sliding-window kernel's chunk mode (llama4's chunked attention):
    at llama4's attention shape (``LLAMA4_CHUNK``) held against the plain
    version, timed beside the plain version and SDPA with a boolean
    block-diagonal causal mask, its bound in operations; at ``CHUNK_EDGE``,
    whose chunk starts fall inside key tiles, held against the plain
    version. Records the llama4 line as ``records["chunked_attention"]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import local_attention as swa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    why = ("per (position, head) row, relative to that row's max |out|: "
           "keys walked in another order than flash's, so p rounds to bf16 "
           "against another running max, 2^-9 of each term")
    for tag, (B, S, H, KV, D, c) in (("llama4 chunked", LLAMA4_CHUNK),
                                     ("chunk starts inside key tiles",
                                      CHUNK_EDGE)):
        q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()

        def cu():
            return swa.sliding_window_attention_cuda(q, k, v, window=S,
                                                     chunk=c)

        def plain():
            return swa.sliding_window_attention_plain(q, k, v, window=S,
                                                      chunk=c)
        got, want = cu(), plain()
        judge(f"sliding_window_attention[{tag}: S {S}, chunk {c}, R "
              f"{H // KV}]", row_errors(got, want), 1e-2, why)
        if tag != "llama4 chunked":
            del got, want, q, k, v
            continue
        pairs = chunk_pairs(S, c)
        rec = dict(max_abs_err=errors(got, want)[0], ms=time_ms(cu, flush),
                   plain_ms=time_ms(plain, flush),
                   bound=bound(2 * B * S * H * D + 2 * 2 * B * S * KV * D
                               + 4 * B * S * H * D, 4 * B * pairs * H * D),
                   shape=f"{tag}: B {B}, S {S}, H {H}, KV {KV}, D {D}, "
                         f"chunk {c}, {pairs} pairs per head")
        del got, want
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] // c == pos[:, None] // c)
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(H // KV, 1)
        vt = v.transpose(1, 2).repeat_interleave(H // KV, 1)
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), flush)
        ms, by = rec["bound"]
        log(f"  sliding_window_attention {rec['shape']}: {rec['ms']:.4f} "
            f"ms, plain {rec['plain_ms']:.4f} ms, SDPA (block-diagonal "
            f"causal mask) {rec['library_ms']:.4f} ms, bound {ms:.4f} ms "
            f"({by})")
        records["chunked_attention"] = rec
        del q, k, v, qt, kt, vt, mask


def phase_kernels_dense(flush, judge, records):
    """Sliding-window attention at the prefill shapes of the served models
    (gemma2-2b and gemma3-12b local and global, qwen2.5-3b and
    mistral-nemo-12b causal), each also for equal bits on a second call,
    and rs_matmul at the GeGLU up-projection's widths."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import local_attention as swa
    from repro_torch.kernels import rs_matmul as rs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    log("kernels: sliding-window attention (R 2, 4 and 8 as served, R 5, "
        "6 and 10 as the reference's other configs need) and rs_matmul")
    for tag, (B, S, H, KV, D, window, cap) in {
            "gemma2-2b local": (1, 8192, 8, 4, 256, 4096, 50.0),
            "gemma2-2b global": (1, 8192, 8, 4, 256, 8192, 50.0),
            "qwen2.5-3b causal": (2, 512, 16, 2, 128, 512, 0.0),
            "gemma3-12b local": (1, 8192, 16, 8, 256, 1024, 0.0),
            "gemma3-12b global": (1, 8192, 16, 8, 256, 8192, 0.0),
            "mistral-nemo-12b causal": (1, 4096, 32, 8, 128, 4096,
                                        0.0),
            "mixtral-8x7b local": (1, 8192, 32, 8, 128, 4096,
                                   0.0)}.items():
        q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()
        lc = swa.launch_config(B, S, H, KV, D)
        log(f"  sliding_window_attention launch ({tag}): {lc['blocks']} "
            f"blocks of {lc['threads']} threads (two 64-row warpgroups), "
            f"{lc['stages']} K/V stages of {lc['key_tile']} keys, "
            f"{lc['smem_bytes']} bytes of shared memory")

        def cu(window=window):
            return swa.sliding_window_attention_cuda(q, k, v, window=window,
                                                     softcap=cap)

        def plain():
            return swa.sliding_window_attention_plain(q, k, v, window=window,
                                                      softcap=cap)
        got, want = cu(), plain()
        abs_err = errors(got, want)[0]
        why = ("per (position, head) row, relative to that row's max |out|: "
               "keys walked in another order than flash's, so p rounds to "
               "bf16 against another running max, 2^-9 of each term")
        judge(f"sliding_window_attention[{tag}]", row_errors(got, want),
              1e-2, why)
        judge.check(f"sliding_window_attention[{tag}]: the same bits on a "
                    "second run", bool(torch.equal(got, cu())),
                    "fixed key order")
        if window < S:
            # the check must see a band one key short at the window's edge
            off = row_errors(cu(window - 1), want)
            judge.check(f"sliding_window_attention[{tag}]: a window one key "
                        "short is caught", off > 1e-2,
                        f"error {off:.3e} > 1e-2")
        del got, want
        pairs = band_pairs(S, window)
        n_bytes = 2 * B * S * H * D + 2 * 2 * B * S * KV * D + 4 * B * S * H * D
        rec = dict(max_abs_err=abs_err, ms=time_ms(cu, flush),
                   plain_ms=time_ms(plain, flush),
                   bound=bound(n_bytes, 4 * B * pairs * H * D),
                   shape=f"{tag}: B {B}, S {S}, H {H}, KV {KV}, D {D}, "
                         f"window {window}, softcap {cap}, {pairs} pairs "
                         "per head")
        # library yardstick: SDPA with a boolean band mask over K/V
        # repeated to every head; SDPA cannot take the softcap
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) \
            & (pos[:, None] - pos[None, :] < window)
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(H // KV, 1)
        vt = v.transpose(1, 2).repeat_interleave(H // KV, 1)
        rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band), flush)
        ms, by = rec["bound"]
        log(f"  {rec['shape']}: {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, SDPA (no softcap) "
            f"{rec['library_ms']:.4f} ms, bound {ms:.4f} ms ({by})")
        if tag == "gemma2-2b local":
            records["sliding_window_attention"] = rec
        del q, k, v, qt, kt, vt, band

    _swa_ratios(flush, judge)
    _swa_chunks(flush, judge, records)

    K, N = 2304, 9216
    w = (torch.randn(K, N, generator=gen, device=dev) / K ** 0.5).bfloat16()
    bias = torch.randn(N, generator=gen, device=dev)
    for M in (512, 8):
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()

        def cu():
            return rs.rs_matmul_cuda(x, w, bias=bias, activation="gelu")

        def plain():
            return rs.rs_matmul_plain(x, w, bias=bias, activation="gelu")
        got = cu()
        abs_err, rel = errors(got, plain())
        judge(f"rs_matmul[M={M}]", rel, 1e-3,
              "relative to max |out|: fp32 tensor-core accumulation of the "
              "same bf16 products in another order")
        judge.check(f"rs_matmul[M={M}]: the same bits on a second run",
                    bool(torch.equal(got, cu())), "fixed sum order")
        lc = rs.launch_config(M, K, N, _build.sm_count(0))
        log(f"  rs_matmul launch (M {M}): {lc['arm']} arm, {lc['units']} "
            f"units of {lc['unit']} over {lc['grid']} persistent blocks of "
            f"{lc['threads']} threads, {lc['stages']}-stage TMA ring, "
            f"{lc['smem_bytes']} bytes of shared memory"
            + (f", then {lc['k_parts']} K parts added in order by a second "
               "kernel" if lc["k_parts"] > 1 else "")
            + (f", the last round's {lc['split_tiles']} tiles split in K into "
               f"{lc['split_parts']} parts added in order by a second kernel"
               if lc.get("split_parts", 1) > 1 else ""))
        rec = dict(max_abs_err=abs_err, ms=time_ms(cu, flush),
                   plain_ms=time_ms(plain, flush),
                   library_ms=time_ms(lambda: F.gelu(torch.addmm(
                       bias.bfloat16(), x, w), approximate="tanh"), flush),
                   bound=bound(2 * M * K + 2 * K * N + 4 * N + 4 * M * N,
                               2 * M * K * N),
                   shape=f"M {M}, {K} -> {N}, bias + tanh-gelu")
        ms, by = rec["bound"]
        log(f"  rs_matmul {rec['shape']}: {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, addmm+gelu {rec['library_ms']:.4f} "
            f"ms, bound {ms:.4f} ms ({by})")
        if M == 512:
            records["rs_matmul"] = rec


def _sdpa_backward_ms(q, k, v, dout, window: int, chunk: int, flush):
    """ms of ``scaled_dot_product_attention``'s backward alone (the
    forward's graph kept) for the same attention as the flash backward:
    causal through ``is_causal`` and ``enable_gqa``; chunk mode through a
    block-diagonal causal boolean mask on K and V repeated to the query
    heads inside the graph (the same mask as ``_swa_chunks``; the repeat's
    backward sums dk and dv back to the KV heads)."""
    import torch
    import torch.nn.functional as F
    S, H, KV = q.shape[1], q.shape[2], k.shape[2]
    if window < S:
        raise ValueError("SDPA has no sliding-window mode here; the "
                         "backward shapes give a window only with a softcap")
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    if chunk:
        pos = torch.arange(S, device=q.device)
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] // chunk == pos[:, None] // chunk)
        o = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(H // KV, 1),
            vt.repeat_interleave(H // KV, 1), attn_mask=mask)
    else:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
    do = dout.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), do, retain_graph=True), flush)


def phase_kernels_backward(flush, judge, records):
    """The flash backward kernel and the forward's log-sum-exp against their
    plain versions at ``BACKWARD_SHAPES``: the lse (1e-5 of max |lse|), the
    forward's output with and without the lse pointer (the same bits, and
    both timed), dq, dk and dv as a share of each one's max |value|; the
    backward's ms per launch, plain ms, bound (the band's 10·D flops a pair
    and head against q, k, v, out16, dout and lse read and fp32 dq, dk, dv
    written once) and, without a softcap, SDPA's backward alone (the
    forward's graph kept; ``_sdpa_backward_ms``). Records the qwen2.5-3b
    line as ``records["flash_backward"]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_backward as fb
    from repro_torch.kernels import local_attention as swa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    log("kernels: the flash backward and the forward's log-sum-exp")
    for tag, (B, S, H, KV, D, window, chunk, cap) in BACKWARD_SHAPES.items():
        q, k, v = (torch.randn(B, S, n, D, generator=gen,
                               device=dev).bfloat16() for n in (H, KV, KV))
        dout = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        kw = dict(window=window, chunk=chunk, softcap=cap)
        out, lse = swa.sliding_window_attention_cuda(q, k, v, return_lse=True,
                                                     **kw)
        _, want_lse = swa.sliding_window_attention_plain(
            q, k, v, return_lse=True, **kw)
        judge(f"log-sum-exp[{tag}]", errors(lse, want_lse)[1], 1e-5,
              "relative to max |lse|: ex2 and log against exp and log")
        judge.check(f"sliding_window_attention[{tag}]: the same bits with "
                    "and without the lse", bool(torch.equal(
                        out, swa.sliding_window_attention_cuda(q, k, v,
                                                               **kw))),
                    "the lse write touches nothing else")
        del want_lse
        fwd_ms = time_ms(lambda: swa.sliding_window_attention_cuda(
            q, k, v, **kw), flush)
        fwd_lse_ms = time_ms(lambda: swa.sliding_window_attention_cuda(
            q, k, v, return_lse=True, **kw), flush)
        out16 = out.bfloat16()
        del out
        args = (q, k, v, out16, lse, dout)

        def cu():
            return fb.flash_backward_cuda(*args, **kw)

        def plain():
            return fb.flash_backward_plain(*args, **kw)
        got, want = cu(), plain()
        worst = 0.0
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            rel = errors(g, w)[1]
            worst = max(worst, errors(g, w)[0])
            judge(f"flash_backward[{tag}] {name}", rel, 2e-3,
                  "relative to max |value|: ex2 and tanhf move a bf16 "
                  "rounding of p or ds by one step, fp32 sums in another "
                  "order")
        judge.check(f"flash_backward[{tag}]: the same bits on a second run",
                    all(torch.equal(a, b) for a, b in zip(got, cu())),
                    "no atomics")
        del got, want
        lc = fb.launch_config(B, S, H, KV, D, window=window, chunk=chunk,
                              sms=_build.sm_count(0))
        flops = fb.band_flops(S, window, chunk, H, D, B)
        n_bytes = 2 * (3 * B * S * H * D + 2 * B * S * KV * D) \
            + 4 * B * S * H + 4 * (B * S * H * D + 2 * B * S * KV * D)
        rec = dict(max_abs_err=worst, ms=time_ms(cu, flush),
                   plain_ms=time_ms(plain, flush, reps=3),
                   bound=bound(n_bytes, flops), library_ms=None,
                   shape=f"{tag}: B {B}, S {S}, H {H}, KV {KV}, D {D}, "
                         f"window {window}, chunk {chunk}, softcap {cap:g}; "
                         f"{flops:.4g} flops (10·D a pair and head)")
        if cap == 0.0:
            rec["library_ms"] = _sdpa_backward_ms(q, k, v, dout, window,
                                                  chunk, flush)
        ms, by = rec["bound"]
        lib = "none (softcap)" if rec["library_ms"] is None \
            else f"{rec['library_ms']:.4f} ms"
        log(f"  flash_backward {rec['shape']}: {rec['ms']:.4f} ms "
            f"(dq: {lc['dq_blocks']} blocks of {lc['dq_threads']} threads, "
            f"{lc['dq_wgs']} consumer warpgroup(s), {lc['dq_tile']} "
            f"positions a block, {lc['dq_stages']} K/V stages, "
            f"{lc['dq_smem_bytes']} bytes of shared memory; dk/dv: "
            f"{lc['dkv_blocks']} blocks of {lc['dkv_threads']} threads, "
            f"{lc['groups']} head group(s), columns split "
            f"{lc['dkv_split']}, {lc['dkv_stages']} Q/dO stages, "
            f"{lc['dkv_smem_bytes']} bytes), plain {rec['plain_ms']:.4f} "
            f"ms, SDPA backward {lib}, bound {ms:.4f} ms ({by}); forward "
            f"{fwd_ms:.4f} ms without the lse, {fwd_lse_ms:.4f} ms with it")
        if tag == "qwen2.5-3b causal":
            records["flash_backward"] = rec
        del q, k, v, dout, out16, lse, args


def phase_kernels_seqshard(flush, judge, records):
    """The sliding window (with its lse) and the flash backward in their
    query-offset mode at ``SEQSHARD_SHAPES``: each shard of the query rows
    (``q_offset``) against the whole K and V. Per shard, both kernels
    against their plain versions at the same offset (out 1e-3, lse 1e-5,
    dq, dk, dv 2e-3, each of the whole launch's max |value|); the shards'
    forward rows, lse and dq bit for bit the whole launch's (each shard's
    rows a multiple of both kernels' query tiles); their dk and dv shares
    summed in shard order within 1e-5 of the whole launch's max. Times each
    shard's forward (with the lse) and backward, their sums and the whole
    launches, with bounds from the shard's band (``band_pairs``). Records
    the lines under ``records["seqshard"]``."""
    import torch
    from repro_torch.kernels import flash_backward as fb
    from repro_torch.kernels import local_attention as swa
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    log("kernels: the query-offset mode (sequence-sharded attention)")
    lines = []
    for tag, (B, S, H, KV, D, window, cap, n) in SEQSHARD_SHAPES.items():
        q, k, v = (torch.randn(B, S, m, D, generator=gen,
                               device=dev).bfloat16() for m in (H, KV, KV))
        dout = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        kw = dict(window=window, chunk=0, softcap=cap)
        out, lse = swa.sliding_window_attention_cuda(q, k, v, return_lse=True,
                                                     **kw)
        out16 = out.bfloat16()
        whole = fb.flash_backward_cuda(q, k, v, out16, lse, dout, **kw)
        tops = [float(t.abs().max()) for t in (out, lse) + whole]
        L = S // n
        worst = dict(fwd=0.0, lse=0.0, bwd=0.0)
        same = dict(out=True, lse=True, dq=True)
        dk, dv = torch.zeros_like(whole[1]), torch.zeros_like(whole[2])
        shard_ms = []
        for i in range(n):
            rows, off = slice(i * L, (i + 1) * L), i * L
            qi = q[:, rows].contiguous()
            args = (qi, k, v, out16[:, rows].contiguous(),
                    lse[:, rows].contiguous(), dout[:, rows].contiguous())
            o_i, l_i = swa.sliding_window_attention_cuda(
                qi, k, v, return_lse=True, q_offset=off, **kw)
            po, pl = swa.sliding_window_attention_plain(
                qi, k, v, return_lse=True, q_offset=off, **kw)
            got = fb.flash_backward_cuda(*args, q_offset=off, **kw)
            want = fb.flash_backward_plain(*args, q_offset=off, **kw)
            worst["fwd"] = max(worst["fwd"], errors(o_i, po)[0] / tops[0])
            worst["lse"] = max(worst["lse"], errors(l_i, pl)[0] / tops[1])
            for g, w, top in zip(got, want, tops[2:]):
                worst["bwd"] = max(worst["bwd"], errors(g, w)[0] / top)
            same["out"] &= bool(torch.equal(o_i, out[:, rows]))
            same["lse"] &= bool(torch.equal(l_i, lse[:, rows]))
            same["dq"] &= bool(torch.equal(got[0], whole[0][:, rows]))
            dk += got[1]
            dv += got[2]
            del po, pl, want
            fwd_ms = time_ms(lambda: swa.sliding_window_attention_cuda(
                qi, k, v, return_lse=True, q_offset=off, **kw), flush)
            bwd_ms = time_ms(lambda: fb.flash_backward_cuda(
                *args, q_offset=off, **kw), flush)
            shard_ms.append((fwd_ms, bwd_ms, fb.band_pairs(
                S, window, 0, off, L)))
        judge(f"seqshard[{tag}] forward, kernel vs plain at each offset",
              worst["fwd"], 1e-3, "of the whole launch's max |out|: the "
              "kernel's key order and tensor-core sums")
        judge(f"seqshard[{tag}] lse, kernel vs plain", worst["lse"], 1e-5,
              "of max |lse|: ex2 and log against exp and log")
        judge(f"seqshard[{tag}] dq, dk, dv, kernel vs plain", worst["bwd"],
              2e-3, "of the whole launch's max |value|: bf16 roundings of "
              "p and ds, fp32 sums in another order")
        judge.check(f"seqshard[{tag}]: the shards' out, lse and dq are the "
                    f"whole launch's bits", all(same.values()), f"{same}")
        sums = max(errors(dk, whole[1])[0] / tops[3],
                   errors(dv, whole[2])[0] / tops[4])
        judge(f"seqshard[{tag}] the shards' summed dk, dv vs the whole "
              "launch", sums, 1e-5, "of max |value|: the same fp32 shares "
              "summed in shard order, not within one block")
        whole_fwd = time_ms(lambda: swa.sliding_window_attention_cuda(
            q, k, v, return_lse=True, **kw), flush)
        whole_bwd = time_ms(lambda: fb.flash_backward_cuda(
            q, k, v, out16, lse, dout, **kw), flush)
        per = ", ".join(f"{a:.4f} / {b:.4f}" for a, b, _ in shard_ms)
        fwd_sum = sum(a for a, _, _ in shard_ms)
        bwd_sum = sum(b for _, b, _ in shard_ms)
        # each shard's bound: its band's 4·D (forward) and 10·D (backward)
        # flops a pair and head at the bf16 peak
        bounds = [(4 * D * pairs * H * B / BF16_FLOP_PER_S * 1e3,
                   10 * D * pairs * H * B / BF16_FLOP_PER_S * 1e3)
                  for _, _, pairs in shard_ms]
        line = (f"{tag} (B {B}, S {S}, {H} / {KV} heads of {D}, window "
                f"{window}, softcap {cap:g}) in {n} shards of {L}: forward "
                f"with lse / backward ms per shard {per}; shards' sums "
                f"{fwd_sum:.4f} / {bwd_sum:.4f} against the whole launch "
                f"{whole_fwd:.4f} / {whole_bwd:.4f}; bounds of the shards "
                f"(operations) {sum(b[0] for b in bounds):.4f} / "
                f"{sum(b[1] for b in bounds):.4f}")
        log(f"  {line}")
        lines.append(line)
        del q, k, v, dout, out, out16, lse, whole, dk, dv
    records["seqshard"] = lines


def _train_flops(cfg, tokens: int) -> float:
    """A train step's least operations: 6 x params x tokens, plus the
    attention band's 12·D flops a (query, key) pair and head (QKᵀ and PV
    forward; dP, dV, dQ and dK backward) in every attention layer."""
    from repro_torch.kernels import flash_backward as fb
    band = fb.band_flops(tokens, tokens, 0, cfg.num_heads, cfg.head_dim) \
        // 10 * 12
    return 6.0 * cfg.param_count() * tokens + band * cfg.num_layers


def _peak_gib() -> float:
    """The peak of device memory allocated since the last ``_reset_peak``,
    in GiB (nan off the card)."""
    import torch
    if DEVICE != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2**30


def _grad_norm(params, batch, cfg, impl):
    """The loss, the global gradient norm and the attention leaves'
    gradients (``blocks/<slot>/attn/<leaf>``, stacked over the layers) of
    one forward and backward (remat ``TRAIN_REMAT``), with no update."""
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt_lib
    loss, _, grads = train_loop.value_and_grad(
        train_loop.make_loss_fn(cfg, TRAIN_REMAT, impl=impl), params, batch)
    attn = {f"{slot}/{name}": g for slot, block in grads["blocks"].items()
            for name, g in block["attn"].items()}
    return float(loss), float(opt_lib.global_norm(grads)), attn


def _attn_grad_errors(got, want):
    """Over every layer of every attention leaf: the worst normwise error
    |got - want| / |want| and the worst elementwise error as a share of
    the layer's max |want|, each with its leaf and layer."""
    fro, top = (0.0, ""), (0.0, "")
    for name, g in got.items():
        for layer, (a, b) in enumerate(zip(g, want[name])):
            d = a - b
            where = f"{name}[{layer}]"
            fro = max(fro, (float(d.norm() / b.norm()), where))
            top = max(top, (float(d.abs().max() / b.abs().max()), where))
    return fro, top


def phase_train(judge):
    """qwen2.5-3b at published width and depth trained for ``TRAIN_WARMUP``
    + ``TRAIN_STEPS`` AdamW steps (``train.loop.make_train_step``, the
    reference's optimizer defaults, remat ``TRAIN_REMAT``) on one repeated
    synthetic batch of ``TRAIN_SEQ`` tokens (``data.pipeline``): the loss
    finite and falling, tokens/s over the timed steps against the step's
    bound, load and step peaks of device memory. Before the steps, one
    forward and backward with the kernels and one with ``impl="plain"``
    attention from the same params: the loss within 1e-3 relative, the
    global gradient norm within 1e-2, and each layer of each attention
    leaf's gradient within ``ATTN_GRAD_TOL`` (normwise, and elementwise as
    a share of its max). The timed steps are the main path:
    each attention layer launches the forward kernel twice a step (the
    forward, and its recomputation under the remat) and the backward
    kernel once; the plain versions never run. Last, one step at remat
    "none" and its peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as data_lib
    from repro_torch.kernels import ops
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt_lib
    _free()
    cfg = get_config(TRAIN_ARCH)
    log(f"train {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_count():.4g} "
        f"parameters; batch 1 x {TRAIN_SEQ} tokens, remat {TRAIN_REMAT}")
    _reset_peak()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params, opt = train_loop.init_train_state(cfg, gen, DEVICE)
    sync()
    log("  " + _memory("params and AdamW state (fp32), load peak"))
    batch = data_lib.to_torch(data_lib.synth_batch(data_lib.DataConfig(
        seq_len=TRAIN_SEQ, global_batch=1, vocab_size=cfg.vocab_size,
        seed=SEED), 0), DEVICE)

    loss_k, norm_k, attn_k = _grad_norm(params, batch, cfg, None)
    loss_p, norm_p, attn_p = _grad_norm(params, batch, cfg, "plain")
    judge("train: loss, kernels vs plain attention",
          abs(loss_k - loss_p) / abs(loss_p), 1e-3,
          "relative; bf16 roundings of p and of the attention output")
    judge("train: global grad norm, kernels vs plain attention",
          abs(norm_k - norm_p) / norm_p, 1e-2,
          "relative; the backward kernel's bf16 roundings of p and ds")
    (fro, fro_at), (top, top_at) = _attn_grad_errors(attn_k, attn_p)
    del attn_k, attn_p
    judge(f"train: attention gradients, kernels vs plain attention, worst "
          f"layer and leaf normwise ({fro_at})", fro, ATTN_GRAD_TOL[0],
          "|kernels - plain| / |plain| per layer of every attn leaf: bf16 "
          "roundings of p and ds the layers below carry forward")
    judge(f"train: attention gradients, kernels vs plain attention, worst "
          f"layer and leaf elementwise ({top_at})", top, ATTN_GRAD_TOL[1],
          "relative to the layer's max |value|: the same roundings")
    log(f"  kernels: loss {loss_k:.6f}, grad norm {norm_k:.6f}; plain "
        f"attention: loss {loss_p:.6f}, grad norm {norm_p:.6f}")

    step = train_loop.make_train_step(cfg, opt_lib.OptimizerConfig(),
                                      remat_policy=TRAIN_REMAT)
    losses, times = [], []
    _reset_peak()
    plain = _PlainCalls()

    def run(i):
        nonlocal params, opt
        sync()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        log(f"  step {i}: loss {losses[-1]:.6f}, loss_total "
            f"{float(m['loss_total']):.6f}, grad_norm "
            f"{float(m['grad_norm']):.6f}, lr {float(m['lr']):.4e}, "
            f"{1e3 * times[-1]:.1f} ms")
    for i in range(TRAIN_WARMUP):
        run(i)
    ops.reset_launches()           # the main path: the timed steps
    with plain:
        for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
            run(i)
    counts = ops.launch_counts()
    peak = _peak_gib()
    judge.check("train: loss finite", all(map(math.isfinite, losses)),
                f"losses {[round(x, 4) for x in losses]}")
    judge.check("train: the loss falls on the repeated batch",
                losses[-1] < losses[0],
                f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    layers = cfg.num_layers
    fwd_per = 2 if TRAIN_REMAT == "full" else 1
    want = {name: 0 for name in counts}
    want["sliding_window_attention"] = fwd_per * layers * TRAIN_STEPS
    want["flash_backward"] = layers * TRAIN_STEPS
    judge.check("train: launches", counts == want,
                f"{counts} (want the forward {fwd_per} and the backward 1 "
                f"per layer per step, nothing else)")
    judge.check("train: the plain versions never ran",
                plain.calls == {"forward": 0, "backward": 0},
                f"{plain.calls}")
    step_s = sum(times[TRAIN_WARMUP:]) / TRAIN_STEPS
    flops = _train_flops(cfg, TRAIN_SEQ)
    bound_s = flops / BF16_FLOP_PER_S
    rate = TRAIN_SEQ / step_s
    log(f"  {TRAIN_STEPS} timed steps: {1e3 * step_s:.1f} ms a step, "
        f"{rate:.1f} tokens/s; bound {1e3 * bound_s:.2f} ms "
        f"({flops:.4g} flops at {BF16_FLOP_PER_S:.4g} FLOP/s: "
        f"{bound_s / step_s:.3f} of it); step peak {peak:.2f} GiB "
        f"(remat {TRAIN_REMAT})")

    step_none = train_loop.make_train_step(cfg, opt_lib.OptimizerConfig(),
                                           remat_policy="none")
    _reset_peak()
    params, opt, m = step_none(params, opt, batch)
    sync()
    peak_none = _peak_gib()
    judge.check("train: a step at remat none", math.isfinite(
        float(m["loss"])), f"loss {float(m['loss']):.6f}")
    log(f"  step peaks: remat {TRAIN_REMAT} {peak:.2f} GiB, remat none "
        f"{peak_none:.2f} GiB")
    lines = [f"train {cfg.name} (batch 1 x {TRAIN_SEQ}, remat "
             f"{TRAIN_REMAT}): {rate:.1f} tokens/s, {1e3 * step_s:.1f} ms a "
             f"step against a {1e3 * bound_s:.2f} ms bound, peak {peak:.2f} "
             f"GiB (remat none {peak_none:.2f} GiB), loss {losses[0]:.4f} -> "
             f"{losses[-1]:.4f}"]
    del params, opt, batch, step, step_none
    return counts, lines


class _PlainCalls:
    """Counts calls of the two attention kernels' plain versions while
    active: the main path must never take them."""

    def __enter__(self):
        from repro_torch.kernels import flash_backward as fb
        from repro_torch.kernels import local_attention as swa
        self.calls = {"forward": 0, "backward": 0}
        self.saved = []
        for mod, name, kind in (
                (swa, "sliding_window_attention_plain", "forward"),
                (fb, "flash_backward_plain", "backward")):
            real = getattr(mod, name)
            self.saved.append((mod, name, real))
            setattr(mod, name, self._counted(real, kind))
        return self

    def _counted(self, real, kind):
        def counted(*a, **kw):
            self.calls[kind] += 1
            return real(*a, **kw)
        return counted

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def _attention_launches(counts, forward: int, backward: int) -> bool:
    """``counts`` is exactly ``forward`` sliding-window and ``backward``
    flash-backward launches, and nothing else."""
    want = {name: 0 for name in counts}
    want["sliding_window_attention"] = forward
    want["flash_backward"] = backward
    return counts == want


def _train_batch(cfg, rows: int, seq: int):
    """The synthetic batch of step 0 (``data.pipeline``) on the card."""
    from repro_torch.data import pipeline as data_lib
    return data_lib.to_torch(data_lib.synth_batch(data_lib.DataConfig(
        seq_len=seq, global_batch=rows, vocab_size=cfg.vocab_size,
        seed=SEED), 0), DEVICE)


def phase_train_mesh(judge):
    """qwen2.5-3b at published width and depth on a logical
    ``TrainMesh(**MESH)`` on this card: the reference's plan (fsdp_tp) and
    ``make_hints``, under which attention runs sequence-sharded (2 KV heads
    do not divide the model axis), batch ``MESH_BATCH`` x ``TRAIN_SEQ``,
    remat ``TRAIN_REMAT``. One forward and backward with the hints against
    one without, from the same params and batch: the loss within 1e-3
    relative, the global grad norm within 1e-2. Then the mesh and the
    one-device step in turns (a warm-up each, ``MESH_STEPS`` timed each,
    mesh first): tokens/s over each side's steps, each step's peak, and
    its launches, exact (a mesh step: the forward kernel shards x layers x
    2 under remat "full", the backward shards x layers; a one-device step
    the same at one shard), the plain versions never run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import planner
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.sharding import autoshard
    from repro_torch.sharding.mesh import TrainMesh, mesh_desc
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt_lib
    _free()
    cfg = get_config(TRAIN_ARCH)
    mesh = TrainMesh(device=DEVICE, **MESH)
    plan = planner.plan_model(cfg, planner.ShapeConfig(
        "mesh", "train", TRAIN_SEQ, MESH_BATCH), mesh_desc(mesh))
    hints = autoshard.make_hints(plan, mesh, MESH_BATCH)
    with layers.hints_context(hints):
        shards = layers.seq_shards(TRAIN_SEQ, cfg.num_heads,
                                   cfg.num_kv_heads)
    log(f"train {cfg.name} on {mesh} (backed by devices: {mesh.backed}): "
        f"batch {MESH_BATCH} x {TRAIN_SEQ}, remat {TRAIN_REMAT}; plan "
        f"{plan.describe().splitlines()[0]}; hints act {hints.act}, logits "
        f"{hints.logits}; attention in {shards} sequence shards")
    judge.check("train mesh: the plan and the attention shards",
                plan.param_rule == "fsdp_tp" and shards == mesh.model,
                f"param_rule {plan.param_rule}, {shards} shards")
    _reset_peak()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params, opt = train_loop.init_train_state(cfg, gen, DEVICE)
    batch = _train_batch(cfg, MESH_BATCH, TRAIN_SEQ)
    sync()
    log("  " + _memory("params and AdamW state (fp32), load peak"))

    def stats(h):
        loss, _, grads = train_loop.value_and_grad(
            train_loop.make_loss_fn(cfg, TRAIN_REMAT, h), params, batch)
        return float(loss), float(opt_lib.global_norm(grads))
    loss_1, norm_1 = stats(None)
    loss_m, norm_m = stats(hints)
    gaps = (abs(loss_m - loss_1) / abs(loss_1), abs(norm_m - norm_1) / norm_1)
    judge("train mesh: loss, mesh vs one device", gaps[0], 1e-3,
          "relative; the shards' dK / dV sums and the same batch")
    judge("train mesh: global grad norm, mesh vs one device", gaps[1], 1e-2,
          "relative; bf16 roundings of the summed dK / dV")
    log(f"  one device: loss {loss_1:.6f}, grad norm {norm_1:.6f}; mesh: "
        f"loss {loss_m:.6f}, grad norm {norm_m:.6f}")

    steps = {"one device": train_loop.make_train_step(
        cfg, opt_lib.OptimizerConfig(), remat_policy=TRAIN_REMAT),
        "mesh": train_loop.make_train_step(
        cfg, opt_lib.OptimizerConfig(), remat_policy=TRAIN_REMAT,
        hints=hints)}
    per = {"one device": 1, "mesh": shards}
    order = ["one device", "mesh"] + ["mesh", "one device",
                                      "one device", "mesh"] * MESH_STEPS
    order = order[:2 + 2 * MESH_STEPS]
    times = {k: [] for k in steps}
    peaks = {k: 0.0 for k in steps}
    total = None
    losses = []
    ok = True
    with _PlainCalls() as plain:
        for i, side in enumerate(order):
            ops.reset_launches()
            _reset_peak()
            sync()
            t0 = time.perf_counter()
            params, opt, m = steps[side](params, opt, batch)
            sync()
            dt = time.perf_counter() - t0
            counts = ops.launch_counts()
            n = per[side] * cfg.num_layers
            fwd_per = 2 if TRAIN_REMAT == "full" else 1
            ok &= _attention_launches(counts, fwd_per * n, n)
            losses.append(float(m["loss"]))
            if i >= 2:                  # the timed steps: the main path
                times[side].append(dt)
                peaks[side] = max(peaks[side], _peak_gib())
                total = counts if total is None else {
                    k: total[k] + counts[k] for k in total}
            log(f"  step {i} ({side}): loss {losses[-1]:.6f}, grad_norm "
                f"{float(m['grad_norm']):.6f}, {1e3 * dt:.1f} ms, "
                f"{counts['sliding_window_attention']} / "
                f"{counts['flash_backward']} attention launches")
    judge.check("train mesh: launches", ok,
                f"the forward kernel 2 x shards x {cfg.num_layers} and the "
                f"backward shards x {cfg.num_layers} a step ({shards} shards "
                "on the mesh, 1 on one device), nothing else")
    judge.check("train mesh: the plain versions never ran",
                plain.calls == {"forward": 0, "backward": 0},
                f"{plain.calls}")
    judge.check("train mesh: the loss falls on the repeated batch",
                all(map(math.isfinite, losses)) and losses[-1] < losses[0],
                f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    tokens = MESH_BATCH * TRAIN_SEQ
    rate = {k: tokens * len(v) / sum(v) for k, v in times.items()}
    line = (f"train {cfg.name} on data={mesh.data}, model={mesh.model} "
            f"(one card; batch {MESH_BATCH} x {TRAIN_SEQ}, remat "
            f"{TRAIN_REMAT}): {rate['mesh']:.1f} tokens/s against "
            f"{rate['one device']:.1f} on one device ("
            f"{rate['mesh'] / rate['one device']:.3f}x; steps "
            f"{', '.join(f'{1e3 * t:.1f}' for t in times['mesh'])} against "
            f"{', '.join(f'{1e3 * t:.1f}' for t in times['one device'])} "
            f"ms, in turns); peaks {peaks['mesh']:.2f} / "
            f"{peaks['one device']:.2f} GiB; loss gap {gaps[0]:.3e}, grad "
            f"norm gap {gaps[1]:.3e}")
    log(f"  {line}")
    del params, opt, batch, steps
    return total, [line]


def phase_train_compressed(judge):
    """The int8 error-feedback data-parallel step
    (``train.grad_compression.make_compressed_dp_train_step``) at data=2:
    qwen2.5-3b at published width and ``DP_LAYERS`` of its 36 layers (at
    data=2 the step holds ~26 B a parameter: params 4, moments 8, two
    residual buffers 8, one replica's fp32 grads 4, two int8 payloads 2),
    one repeated ``TRAIN_SEQ``-token sequence a replica, ``DP_STEPS``
    steps, remat ``TRAIN_REMAT``: the loss finite and falling, the
    residuals finite and nonzero in every leaf, each step's attention
    launches exact (2 replicas x layers x 2 forward, 2 x layers backward),
    the payload bytes a step (n_dp x (numel + 4 a leaf)) and the peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.sharding.mesh import TrainMesh
    from repro_torch.train import grad_compression as gc
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt_lib
    _free()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=DP_LAYERS)
    mesh = TrainMesh(data=2, device=DEVICE)
    _reset_peak()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params, opt = train_loop.init_train_state(cfg, gen, DEVICE)
    ef = gc.init_error_feedback(mesh, params)
    batch = _train_batch(cfg, mesh.dp, TRAIN_SEQ)
    sync()
    n_params = sum(p.numel() for p in opt_lib.leaves(params))
    log(f"train {cfg.name}, {DP_LAYERS} of 36 layers ({n_params:.4g} "
        f"parameters), compressed data-parallel step at data={mesh.data}: "
        f"one {TRAIN_SEQ}-token sequence a replica, remat {TRAIN_REMAT}")
    log("  " + _memory("params, AdamW state and residuals, load peak"))
    step = gc.make_compressed_dp_train_step(
        mesh, train_loop.make_loss_fn(cfg, TRAIN_REMAT),
        opt_lib.OptimizerConfig())
    losses, times, total, ok = [], [], None, True
    fwd_per = 2 if TRAIN_REMAT == "full" else 1
    _reset_peak()
    with _PlainCalls() as plain:
        for i in range(DP_STEPS):
            ops.reset_launches()
            sync()
            t0 = time.perf_counter()
            params, opt, ef, m = step(params, opt, batch, ef)
            sync()
            times.append(time.perf_counter() - t0)
            counts = ops.launch_counts()
            n = mesh.dp * DP_LAYERS
            ok &= _attention_launches(counts, fwd_per * n, n)
            total = counts if total is None else {
                k: total[k] + counts[k] for k in total}
            losses.append(float(m["loss"]))
            log(f"  step {i}: loss {losses[-1]:.6f}, grad_norm "
                f"{float(m['grad_norm']):.6f}, {1e3 * times[-1]:.1f} ms")
    peak = _peak_gib()
    judge.check("train compressed: the loss falls on the repeated batch",
                all(map(math.isfinite, losses)) and losses[-1] < losses[0],
                f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    bad = [i for i, e in enumerate(opt_lib.leaves(ef))
           if not bool(torch.isfinite(e).all()) or float(e.abs().max()) == 0]
    judge.check("train compressed: residuals finite and nonzero", not bad,
                f"{len(list(opt_lib.leaves(ef)))} leaves, bad {bad}")
    judge.check("train compressed: launches", ok,
                f"the forward kernel {fwd_per} x {mesh.dp} replicas x "
                f"{DP_LAYERS} layers and the backward {mesh.dp} x "
                f"{DP_LAYERS} a step, nothing else")
    judge.check("train compressed: the plain versions never ran",
                plain.calls == {"forward": 0, "backward": 0},
                f"{plain.calls}")
    payload = gc.payload_bytes(params, mesh.dp)
    tokens = mesh.dp * TRAIN_SEQ
    line = (f"train {cfg.name} ({DP_LAYERS} of 36 layers), int8 "
            f"error-feedback DP at data={mesh.data} (one card): "
            f"{tokens * DP_STEPS / sum(times):.1f} tokens/s over "
            f"{DP_STEPS} steps ({', '.join(f'{1e3 * t:.1f}' for t in times)}"
            f" ms), peak {peak:.2f} GiB, payload {payload} B a step "
            f"(against {mesh.dp * 4 * n_params} B of fp32 gradients), loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    log(f"  {line}")
    del params, opt, ef, batch, step
    return total, [line]


def phase_elastic(judge):
    """An elastic round trip at full width and ``ELASTIC_LAYERS`` layers:
    one step at data=2 (its hints) under the Supervisor, whose
    ``CheckpointManager`` saves the state, then
    ``runtime.elastic.restore_elastic`` at data=1 on this card: every
    tensor equal to the live state's, the restored specs the data=1
    plan's (no axis left), where the data=2 plan's name "data"."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import planner
    from repro_torch.kernels import ops
    from repro_torch.runtime import elastic
    from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                                     Supervisor)
    from repro_torch.sharding import autoshard
    from repro_torch.sharding.mesh import TrainMesh, mesh_desc
    from repro_torch.sharding.specs import mesh_axis_sizes
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt_lib
    _free()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              num_layers=ELASTIC_LAYERS)
    shape = planner.ShapeConfig("elastic", "train", TRAIN_SEQ, 2)
    wide, one = TrainMesh(data=2, device=DEVICE), TrainMesh(device=DEVICE)
    plan = planner.plan_model(cfg, shape, mesh_desc(wide))
    step_fn = train_loop.make_train_step(
        cfg, opt_lib.OptimizerConfig(), remat_policy=TRAIN_REMAT,
        hints=autoshard.make_hints(plan, wide, 2))
    live = {}

    def wrapped(state, batch):
        params, opt, m = step_fn(*state, batch)
        live["state"] = (params, opt)
        return (params, opt), m

    def init():
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        return train_loop.init_train_state(cfg, gen, DEVICE)
    batch = _train_batch(cfg, 2, TRAIN_SEQ)
    ckdir = tempfile.mkdtemp(prefix="elastic-")
    try:
        sup = Supervisor(FaultToleranceConfig(checkpoint_dir=ckdir,
                                              checkpoint_every=1),
                         step_fn=wrapped, data_fn=lambda step: batch,
                         init_state_fn=init)
        ops.reset_launches()
        t0 = time.perf_counter()
        sup.run(1)
        sync()
        counts = ops.launch_counts()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, manifest = elastic.restore_elastic(
            sup.ckpt, train_loop.abstract_train_state(cfg), cfg, shape, one)
        sync()
        restore_s = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(ckdir) for f in fs)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    got = list(opt_lib.leaves(state[0])) + list(opt_lib.leaves(
        state[1].mu)) + list(opt_lib.leaves(state[1].nu)) + [state[1].step]
    want = list(opt_lib.leaves(live["state"][0])) + list(opt_lib.leaves(
        live["state"][1].mu)) + list(opt_lib.leaves(
            live["state"][1].nu)) + [live["state"][1].step]
    judge.check("elastic: every restored tensor equals the saved state",
                len(got) == len(want) and all(
                    a.device.type == DEVICE and torch.equal(a, b.to(a.device))
                    for a, b in zip(got, want)),
                f"{len(got)} tensors, step {manifest['step']}")
    p_specs = manifest["specs"][0]
    abstract = train_loop.abstract_train_state(cfg)[0]
    want_one = autoshard.param_specs(abstract, planner.plan_model(
        cfg, shape, mesh_desc(one)), mesh_axis_sizes(one))
    want_wide = autoshard.param_specs(abstract, plan, mesh_axis_sizes(wide))
    def cut(tree):          # the specs that cut a dimension
        return sum(any(e is not None for e in spec)
                   for spec in opt_lib.leaves(tree))
    judge.check("elastic: the specs are the data=1 re-plan's",
                p_specs == want_one and cut(p_specs) == 0
                and cut(want_wide) > 0,
                f"{len(list(opt_lib.leaves(p_specs)))} param specs, none "
                f"cut at data=1; the data=2 plan cuts {cut(want_wide)}")
    line = (f"elastic round trip, {cfg.name} at {ELASTIC_LAYERS} layer(s): "
            f"one step at data=2 and its checkpoint ({n_bytes} B) in "
            f"{save_s:.1f} s, restore_elastic at data=1 in {restore_s:.1f} "
            "s, every tensor equal")
    log(f"  {line}")
    del state, live
    return counts, [line]


def _digests(tensors):
    """The SHA-256 of each tensor's bytes, in threads (hashlib lets go of
    the interpreter lock while it hashes). A tensor on the card reaches
    the host in chunks through a pinned buffer a thread (a pageable copy
    is slower)."""
    import hashlib
    import threading
    from concurrent.futures import ThreadPoolExecutor
    import torch
    chunk = 64 << 20
    local = threading.local()

    def one(t):
        flat = t.detach().reshape(-1).contiguous().view(torch.uint8)
        h = hashlib.sha256()
        if flat.device.type != "cuda":
            h.update(flat.numpy())
            return h.hexdigest()
        if not hasattr(local, "buf"):
            local.buf = torch.empty(chunk, dtype=torch.uint8,
                                    pin_memory=True)
        for i in range(0, flat.numel(), chunk):
            part = local.buf[:min(chunk, flat.numel() - i)]
            part.copy_(flat[i:i + chunk])
            h.update(part.numpy())
        return h.hexdigest()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return list(ex.map(one, tensors))


def _ms(times) -> str:
    return ", ".join(f"{1e3 * t:.1f}" for t in times)


def _gib(values) -> str:
    return ", ".join(f"{v:.2f}" for v in values)


def _dist_sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _dist_reset_peak(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _dist_peak(device) -> float:
    """The peak of ``device``'s memory since ``_dist_reset_peak``, GiB
    (nan off the card)."""
    import torch
    if torch.device(device).type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated(device) / 2**30


def _dist_step(kind: str, mesh, cfg, conf):
    """The step of ``kind`` as step(params, opt, batch, ef) -> (params,
    opt, ef, metrics): "compressed" the int8 error-feedback DP step on
    ``mesh``; "plain" ``make_train_step`` on ``mesh`` (over its ranks on a
    process mesh); "whole" ``make_train_step`` on the whole batch in this
    process; "split" the plain step's ``mesh.dp`` replicas one after
    another in this process: each replica's rows' gradients through the
    same kernels, summed in replica order and divided by n_dp, then AdamW
    (at two replicas the sum the ranks' all-reduce makes, bit for bit: a
    sum of two operands has one order)."""
    from repro_torch.data import pipeline as data_lib
    from repro_torch.train import grad_compression as gc
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt_lib
    opt_cfg = opt_lib.OptimizerConfig()
    loss_fn = train_loop.make_loss_fn(cfg, conf["remat"])
    if kind == "compressed":
        return gc.make_compressed_dp_train_step(mesh, loss_fn, opt_cfg)
    if kind == "split":
        def split(params, opt, batch, ef):
            grads, losses = None, []
            for r in range(mesh.dp):
                loss, _, g = train_loop.value_and_grad(
                    loss_fn, params, data_lib.replica_rows(batch, r, mesh.dp))
                losses.append(float(loss))
                if grads is None:
                    grads = g
                    continue
                for acc, part in zip(opt_lib.leaves(grads),
                                     opt_lib.leaves(g)):
                    acc.add_(part)
                del g
            for acc in opt_lib.leaves(grads):
                acc.div_(mesh.dp)
            params, opt, om = opt_lib.adamw_update(opt_cfg, params, grads,
                                                   opt)
            return params, opt, ef, {**om,
                                     "loss_total": sum(losses) / mesh.dp}
        return split
    inner = train_loop.make_train_step(
        cfg, opt_cfg, remat_policy=conf["remat"],
        mesh=mesh if kind == "plain" else None)

    def plain(params, opt, batch, ef):
        params, opt, m = inner(params, opt, batch)
        return params, opt, ef, m
    return plain


def _dist_side(mesh, conf, turns, probe: bool = False):
    """The steps ``turns`` (kinds of ``_dist_step``, in that order on one
    state) on ``mesh`` (a process mesh, or one process's), from the seeded
    state of ``conf["arch"]`` at ``conf["layers"]`` layers, on the step-0
    batch of ``conf["rows"]`` rows of ``conf["seq"]`` tokens. By kind:
    each step's loss, grad norm and host time (synchronised; a kind's
    first step is its warm-up); the launches and plain-version calls of
    all of them, the peak of device memory, and the SHA-256 of every state
    leaf (params, moments, the step) and of each residual slot. ``probe``:
    the whole batch's loss and grad norm from the seeded params first (a
    forward and backward, not counted)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as data_lib
    from repro_torch.kernels import ops
    from repro_torch.train import grad_compression as gc
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt_lib
    device = torch.device(mesh.device)
    cfg = dataclasses.replace(get_config(conf["arch"]),
                              num_layers=conf["layers"])
    gen = torch.Generator(device=device).manual_seed(conf["seed"])
    params, opt = train_loop.init_train_state(cfg, gen, device)
    batch = data_lib.to_torch(data_lib.synth_batch(data_lib.DataConfig(
        seq_len=conf["seq"], global_batch=conf["rows"],
        vocab_size=cfg.vocab_size, seed=conf["seed"]), 0), device)
    steps = {k: _dist_step(k, mesh, cfg, conf) for k in dict.fromkeys(turns)}
    ef = (gc.init_error_feedback(mesh, params) if "compressed" in steps
          else None)
    out = {key: {k: [] for k in steps} for key in ("losses", "norms",
                                                  "times")}
    if probe:
        loss, _, grads = train_loop.value_and_grad(
            train_loop.make_loss_fn(cfg, conf["remat"]), params, batch)
        out["probe"] = (float(loss), float(opt_lib.global_norm(grads)))
        del grads
    _dist_reset_peak(device)
    ops.reset_launches()
    with _PlainCalls() as plain:
        for kind in turns:
            _dist_sync(device)
            t0 = time.perf_counter()
            params, opt, ef, m = steps[kind](params, opt, batch, ef)
            _dist_sync(device)
            out["times"][kind].append(time.perf_counter() - t0)
            out["losses"][kind].append(float(m["loss_total"]))
            out["norms"][kind].append(float(m["grad_norm"]))
    out["counts"] = ops.launch_counts()
    out["plain"] = dict(plain.calls)
    out["peak"] = _dist_peak(device)
    out["digests"] = _digests(list(opt_lib.leaves(params))
                              + list(opt_lib.leaves(opt.mu))
                              + list(opt_lib.leaves(opt.nu)) + [opt.step])
    if ef is not None:
        efs = list(opt_lib.leaves(ef))
        out["ef"] = [_digests([e[r] for e in efs])
                     for r in range(efs[0].shape[0])]
    del params, opt, ef, batch, steps
    return out


def _dist_rank(group, sides):
    """A rank of ``phase_train_dist``: ``_dist_side(mesh, conf, turns,
    probe)`` of each (name, conf, turns, probe) of ``sides`` on its
    process mesh, by name, the state freed between."""
    import gc as pygc
    import torch
    from repro_torch.sharding.mesh import make_local_mesh
    mesh = make_local_mesh(group=group)
    out = {"rank": group.rank, "device": str(group.device)}
    for name, conf, turns, probe in sides:
        out[name] = _dist_side(mesh, conf, turns, probe)
        pygc.collect()
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _dist_tokens_s(side, kind, conf) -> float:
    """Tokens a second over ``kind``'s timed steps (all but its first)."""
    timed = side["times"][kind][1:]
    return conf["rows"] * conf["seq"] * len(timed) / sum(timed)


def _dist_checks(judge, tag, one, ranks, conf):
    """The checks of two ranks against one process: the compressed step's
    state and each rank's residual slot equal the one-process step's
    SHA-256 for SHA-256, its losses equal; the plain DP state equal on
    every rank to the row-split sum's in one process (``_dist_step``
    "split") by SHA-256, the first loss and grad norm within 1e-3 / 1e-2
    of the whole-batch step's (``phase_train``'s gaps); on every rank the
    attention kernels launched exactly (one row a rank: the forward
    ``fwd`` and the backward once a layer a step) and no plain version."""
    fwd = 2 if conf["remat"] == "full" else 1
    layers, steps = conf["layers"], conf["steps"]
    c1 = one["compressed"]
    judge.check(f"{tag}: compressed DP state, every rank vs one process",
                all(r["compressed"]["digests"] == c1["digests"]
                    for r in ranks),
                f"{len(c1['digests'])} leaves (params, moments, step) by "
                "SHA-256")
    judge.check(f"{tag}: compressed DP residual, rank r vs slot r",
                all(r["compressed"]["ef"][0] == c1["ef"][i]
                    for i, r in enumerate(ranks)), f"{len(ranks)} ranks")
    judge.check(f"{tag}: compressed DP losses equal",
                all(r["compressed"]["losses"] == c1["losses"]
                    for r in ranks), f"{c1['losses']['compressed']}")
    judge.check(f"{tag}: plain DP state, every rank vs the row-split sum",
                all(r["plain"]["digests"] == one["split"]["digests"]
                    for r in ranks),
                f"{len(ranks)} rows' gradients summed in one process, "
                f"{steps} steps; {len(one['split']['digests'])} leaves by "
                "SHA-256")
    w = one["whole"]
    for r in ranks:
        pr = r["plain"]
        judge(f"{tag}: plain DP rank {r['rank']}, loss vs whole batch",
              abs(pr["losses"]["plain"][0] - w["losses"]["whole"][0])
              / abs(w["losses"]["whole"][0]), 1e-3,
              "relative; the rows' means summed in another order")
        judge(f"{tag}: plain DP rank {r['rank']}, grad norm vs whole batch",
              abs(pr["norms"]["plain"][0] - w["norms"]["whole"][0])
              / w["norms"]["whole"][0], 1e-2,
              "relative; bf16 roundings at another batch shape")
    ok = all(_attention_launches(r[k]["counts"], fwd * layers * steps,
                                 layers * steps)
             and r[k]["plain"] == {"forward": 0, "backward": 0}
             for r in ranks for k in ("compressed", "plain"))
    judge.check(f"{tag}: launches on every rank", ok,
                f"the forward {fwd} x {layers} layers and the backward "
                f"{layers} a step, {steps} steps, nothing else, no plain "
                "version")


def _dist_sum(ranks, names):
    """The ranks' launches over the sides ``names``, summed."""
    total = None
    for r in ranks:
        for k in names:
            c = r[k]["counts"]
            total = dict(c) if total is None else {
                n: total[n] + c[n] for n in total}
    return total


def phase_train_dist(judge):
    """Data-parallel training over processes (``sharding.dist``):
    qwen2.5-3b at published width and ``DIST_LAYERS`` of its 36 layers,
    one ``TRAIN_SEQ``-token row a replica, ``DIST_STEPS`` steps, remat
    ``TRAIN_REMAT``. (1) One process: the compressed DP step on
    ``TrainMesh(data=2)``, the plain step on the whole batch and the plain
    step's row-split sum, their losses, grad norms and per-leaf SHA-256
    kept on the host, the card freed. (2) Two gloo ranks sharing this card
    run the compressed and the plain DP step: the compressed state and
    each rank's residual equal the one-process step's, the plain state
    equal to the row-split sum's, its loss and grad norm within 1e-3 /
    1e-2 of the whole batch's, every rank's attention launches exact, no
    plain version. (3) An NCCL group of one in this process: the plain
    step equal to the group-less one bit for bit. (4) With two or more
    cards, min(cards, ``DIST_CARDS``) NCCL ranks, one a card: the
    compressed step at ``DIST_LAYERS`` against one process's, then the
    plain step at full depth against each card's whole-batch step, in
    turns, with tokens/s; on one card a line says it did not run. Every
    figure printed beside each rank's peak; each rate rests on the steps
    after a side's first (``DIST_STEPS`` - 1)."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.sharding import dist
    from repro_torch.sharding.mesh import TrainMesh, make_local_mesh
    _free()
    cuda = DEVICE == "cuda"
    if cuda:
        _build.build()          # the ranks load this library, built once
    cfg = get_config(TRAIN_ARCH)
    n = dataclasses.replace(cfg, num_layers=DIST_LAYERS).param_count()
    conf = dict(arch=TRAIN_ARCH, layers=DIST_LAYERS, seq=TRAIN_SEQ, rows=2,
                steps=DIST_STEPS, remat=TRAIN_REMAT, seed=SEED)
    # fp32 params 4 B, moments 8, residual slots 4 each, the replica's
    # gradients 4, its int8 payload 1 and the gathered ones 1 each
    one_b, rank_b = (4 + 8 + 2 * 4 + 4 + 2) * n, (4 + 8 + 4 + 4 + 1 + 2) * n
    have = (torch.cuda.get_device_properties(0).total_memory if cuda
            else float("inf"))
    judge.check("train dist: the reckoning fits the card",
                2 * rank_b < have and one_b < have,
                f"{n:.4g} parameters at {DIST_LAYERS} layers: one process "
                f"{one_b / 1e9:.1f} GB, two ranks 2 x {rank_b / 1e9:.1f} GB "
                f"before activations, against {have / 1e9:.1f} GB")
    t0 = time.perf_counter()
    steps = conf["steps"]
    pair = TrainMesh(data=2, device=DEVICE)
    one = {"compressed": _dist_side(pair, conf, ["compressed"] * steps),
           "whole": _dist_side(TrainMesh(device=DEVICE), conf,
                               ["whole"] * steps),
           "split": _dist_side(pair, conf, ["split"] * steps)}
    _free()
    t1 = time.perf_counter()
    ranks = dist.spawn(
        _dist_rank, 2, [(k, conf, [k] * steps, False)
                        for k in ("compressed", "plain")],
        device="cuda:0" if cuda else "cpu", backend="gloo",
        timeout_s=DIST_TIMEOUT_S, join_timeout_s=DIST_JOIN_S)
    t2 = time.perf_counter()
    _dist_checks(judge, "train dist (2 gloo ranks, one card)", one, ranks,
                 conf)
    launches = _dist_sum(ranks, ("compressed", "plain"))

    with tempfile.TemporaryDirectory(prefix="dist-one-") as tmp:
        group = dist.init(0, 1, 0, device="cuda:0" if cuda else "cpu",
                          store=torch.distributed.FileStore(
                              os.path.join(tmp, "store"), 1))
        try:
            alone = _dist_side(make_local_mesh(group=group), conf,
                               ["plain"] * steps)
        finally:
            dist.destroy()
    judge.check(f"train dist: a {group.backend} group of one vs no group",
                alone["digests"] == one["whole"]["digests"]
                and alone["losses"]["plain"] == one["whole"]["losses"][
                    "whole"], "the plain step's state by SHA-256 and its "
                "losses")
    launches = {k: launches[k] + alone["counts"][k] for k in launches}
    _free()
    lines = []
    for kind, mine in (("compressed", "compressed"), ("plain", "whole")):
        a, b = one[mine], [r[kind] for r in ranks]
        lines.append(
            f"train dist {cfg.name} ({DIST_LAYERS} of {cfg.num_layers} "
            f"layers, {kind}, 2 x {TRAIN_SEQ} tokens a step): one process "
            f"{_dist_tokens_s(a, mine, conf):.1f} tokens/s (peak "
            f"{a['peak']:.2f} GiB), two gloo ranks on one card "
            f"{_dist_tokens_s(b[0], kind, conf):.1f} tokens/s (peaks "
            f"{_gib(r['peak'] for r in b)} GiB; steps "
            f"{_ms(b[0]['times'][kind])} against {_ms(a['times'][mine])} "
            "ms)")
    lines.append(f"train dist phases: one process {t1 - t0:.1f} s, two "
                 f"ranks {t2 - t1:.1f} s (process start included); each "
                 f"rate over {steps - 1} timed step(s) after a side's "
                 "first")
    cards = torch.cuda.device_count() if cuda else 0
    if cards >= 2:
        more, counts = _dist_cards(judge, min(cards, DIST_CARDS), conf)
        lines += more
        launches = {k: launches[k] + counts[k] for k in launches}
    else:
        lines.append(f"train dist across cards: not run ({cards} card(s); "
                     "it needs two)")
    for line in lines:
        log(f"  {line}")
    return launches, lines


def _dist_turns(steps: int):
    """``_dist_cards``' order at full depth: one plain DP step ("plain")
    and one whole-batch step ("whole", each card the same work, so the
    params stay equal) untimed, then ``steps`` of each in turns."""
    order = ["plain", "whole"] + ["whole", "plain", "plain",
                                  "whole"] * steps
    return order[:2 + 2 * steps]


def _dist_cards(judge, world: int, conf):
    """``phase_train_dist``'s part (4): ``world`` NCCL ranks, one a card
    (``_dist_rank``): the compressed step at ``conf``'s depth, then the
    plain DP step against each card's whole-batch step in turns at full
    depth, the first DP step's loss and grad norm against a whole-batch
    forward and backward from the same params."""
    from repro_torch.configs import get_config
    from repro_torch.sharding import dist
    from repro_torch.sharding.mesh import TrainMesh
    steps = conf["steps"]
    wide = dict(conf, rows=world)
    one = _dist_side(TrainMesh(data=world, device=DEVICE), wide,
                     ["compressed"] * steps)
    _free()
    full = dict(wide, layers=get_config(TRAIN_ARCH).num_layers)
    turns = _dist_turns(steps)
    ranks = dist.spawn(_dist_rank, world,
                       [("compressed", wide, ["compressed"] * steps, False),
                        ("turns", full, turns, True)], device=DEVICE,
                       timeout_s=DIST_TIMEOUT_S, join_timeout_s=DIST_JOIN_S)
    tag = (f"train dist ({world} {dist.default_backend(DEVICE)} ranks, a "
           "card each)")
    judge.check(f"{tag}: compressed DP state, every rank vs one process",
                all(r["compressed"]["digests"] == one["digests"]
                    and r["compressed"]["ef"][0] == one["ef"][i]
                    and r["compressed"]["losses"] == one["losses"]
                    for i, r in enumerate(ranks)),
                "params, moments, step, residual slot by SHA-256; losses")
    fwd = 2 if conf["remat"] == "full" else 1
    ok = all(_attention_launches(r["compressed"]["counts"],
                                 fwd * wide["layers"] * steps,
                                 wide["layers"] * steps)
             and _attention_launches(r["turns"]["counts"],
                                     fwd * full["layers"] * len(turns),
                                     full["layers"] * len(turns))
             and r["compressed"]["plain"] == r["turns"]["plain"] ==
             {"forward": 0, "backward": 0} for r in ranks)
    judge.check(f"{tag}: launches on every rank", ok,
                "exact on both steps, no plain version")
    for r in ranks:
        t = r["turns"]
        judge(f"{tag}: plain DP rank {r['rank']} at {full['layers']} layers, "
              "loss vs one card",
              abs(t["losses"]["plain"][0] - t["probe"][0])
              / abs(t["probe"][0]), 1e-3,
              "relative; the rows' means summed in another order")
        judge(f"{tag}: plain DP rank {r['rank']}, grad norm vs one card",
              abs(t["norms"]["plain"][0] - t["probe"][1]) / t["probe"][1],
              1e-2, "relative; bf16 roundings")
    judge.check(f"{tag}: plain DP state equal on every card",
                all(r["turns"]["digests"] == ranks[0]["turns"]["digests"]
                    for r in ranks), "by SHA-256, after the turns")
    t = ranks[0]["turns"]
    rate = {k: _dist_tokens_s(t, k, full) for k in ("plain", "whole")}
    line = (f"train dist {TRAIN_ARCH} ({full['layers']} layers, plain DP, "
            f"{world} x {conf['seq']} tokens a step): {world} cards "
            f"{rate['plain']:.1f} tokens/s against one card "
            f"{rate['whole']:.1f} ({rate['plain'] / rate['whole']:.3f}x; "
            f"steps {_ms(t['times']['plain'])} against "
            f"{_ms(t['times']['whole'])} ms, in turns, the first of each a "
            f"warm-up); peaks {_gib(r['turns']['peak'] for r in ranks)} GiB; "
            f"compressed at {wide['layers']} layers "
            f"{_dist_tokens_s(ranks[0]['compressed'], 'compressed', wide):.1f}"
            f" tokens/s against one process "
            f"{_dist_tokens_s(one, 'compressed', wide):.1f} (peaks "
            f"{_gib(r['compressed']['peak'] for r in ranks)} GiB)")
    counts = _dist_sum(ranks, ("compressed", "turns"))
    return [line], counts


def _cell_args(cell, gen, params):
    """A cell's arguments on the card: ``params`` where the cell takes
    them (the model's own init from the seeded generator), AdamW's zero
    state beside them in a train cell, every other leaf drawn from
    ``gen`` as its meta stand-in's shape and dtype says: token ids below
    the vocabulary, floats from N(0, 1), a decode cell's position the last
    of its cache."""
    import torch
    from repro_torch.train import optimizer as opt_lib

    def draw(t):
        if t.dtype == torch.int32:
            if t.dim() == 0:
                return torch.tensor(cell.shape.seq_len - 1,
                                    dtype=torch.int32, device=DEVICE)
            return torch.randint(0, cell.cfg.vocab_size, tuple(t.shape),
                                 generator=gen, device=DEVICE,
                                 dtype=torch.int32)
        return torch.empty(tuple(t.shape), dtype=t.dtype,
                           device=DEVICE).normal_(generator=gen)

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return draw(t)
    if cell.kind == "train":
        return params, opt_lib.init_adamw(params), tree(
            cell.abstract_args[2])
    return (params,) + tuple(tree(a) for a in cell.abstract_args[1:])


def _tensor_bytes(tree) -> int:
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    return sum(_tensor_bytes(v) for v in tree)


def _cell_launches(cfg, kind: str):
    """The port kernels one step of a cell launches: the sliding window
    once per layer in a prefill; in a train step at remat "full" twice
    (the forward and its recomputation, with the lse) and the flash
    backward once; nothing in decode (contiguous cache, dense MLPs)."""
    from repro_torch.kernels import ops
    want = {name: 0 for name in ops.KERNELS}
    if kind == "prefill":
        want["sliding_window_attention"] = cfg.num_layers
    elif kind == "train":
        want["sliding_window_attention"] = 2 * cfg.num_layers
        want["flash_backward"] = cfg.num_layers
    return want


def _cell_attention(judge, cfg):
    """The sliding-window kernel as the prefill cell's main path calls it,
    on one layer's attention at the cell's shape (B 1, every one of its
    positions, ``cfg``'s heads; causal, its softcap): its output, and its
    output and log-sum-exp where it also writes that, against the plain
    version on the same inputs. Faults that show only at a long sequence
    (an index past 2^14 positions, a running max over hundreds of key
    tiles, a grid dimension) show here."""
    import torch
    from repro_torch.kernels import local_attention as swa
    _, kind, S, B = CELL_SHAPES[0]
    assert kind == "prefill"
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    q, k, v = (torch.randn(B, S, n, D, generator=gen, device=DEVICE)
               .bfloat16() for n in (H, KV, KV))
    kw = dict(window=S, softcap=cfg.attn_logit_softcap)
    want, want_lse = swa.sliding_window_attention_plain(
        q, k, v, return_lse=True, **kw)
    if DEVICE == "cuda":
        got = swa.sliding_window_attention_cuda(q, k, v, **kw)
        got_l, lse = swa.sliding_window_attention_cuda(q, k, v,
                                                       return_lse=True, **kw)
    else:                  # a CPU rehearsal: the wrappers' plain route
        got = swa.sliding_window_attention_plain(q, k, v, **kw)
        got_l, lse = want, want_lse
    tag = f"cells: sliding_window_attention at B {B}, S {S}, {H}/{KV} heads"
    why = ("relative to max |out|: keys walked in another order than "
           "flash's, tensor-core sums in their own")
    judge(f"{tag}, D {D}, causal", errors(got, want)[1], 1e-3, why)
    judge(f"{tag}, with the lse: out", errors(got_l, want)[1], 1e-3, why)
    judge(f"{tag}, with the lse: lse", errors(lse, want_lse)[1], 1e-3,
          "relative to max |lse|: the same sums' roundings")
    del q, k, v, want, want_lse, got, got_l, lse


def _cell_ms(fn, args, reps: int) -> float:
    """Mean ms of ``reps`` runs of the step after one warm-up run, CUDA
    events around each (a train step's host gaps count: the step is
    host-bound)."""
    import torch
    fn(*args)
    sync()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_cells(judge):
    """The dry-run's cells run on the card: ``CELL_ARCH`` at published
    width and depth, each cell of ``CELL_SHAPES`` built by
    ``launch.cell.build_cell`` on a one-card ``TrainMesh(1, 1)`` and its
    arguments materialised on the card from a seeded generator
    (``_cell_args``). Checks, per cell: the materialised arguments' bytes
    equal ``launch.dryrun.run_cell``'s ``argument_size_in_bytes`` for the
    same cell and mesh; one step (the main path: counts zeroed just before
    it, read just after) launches exactly ``_cell_launches``; the peak of
    device memory over it is at least the record's arguments + outputs -
    aliases. The sliding-window kernel at the prefill cell's attention
    shape (``_cell_attention``: its whole length, as the main path calls
    it) agrees with its plain version. The prefill cell built at
    ``CELL_CHECK_SEQ`` gives last-position logits within 5e-2 of max
    |logit| of ``impl="plain"`` (a plain prefill of all the layers at the
    cell's full length would take minutes; one plain attention call at
    it, about a second). Each cell's step time (``_cell_ms``) is printed
    beside the record's ``t_total`` and roofline fraction and the measured
    temporaries (the peak less the arguments): readings, not gates."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.cell import build_cell
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import decoding
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.mesh import TrainMesh
    _free()
    cfg = get_config(CELL_ARCH)
    mesh, meta = TrainMesh(1, 1, device=DEVICE), TrainMesh(1, 1,
                                                           device="meta")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = tfm.init_params(cfg, gen, DEVICE)
    log(f"cells {cfg.name}: {cfg.num_layers} layers, "
        f"{_tensor_bytes(params)} B of fp32 params, one-card mesh")

    check = build_cell(CELL_ARCH, ShapeConfig(
        f"prefill_{CELL_CHECK_SEQ}-b1", "prefill", CELL_CHECK_SEQ, 1), mesh)
    args = _cell_args(check, gen, params)
    with torch.no_grad():          # the real vocabulary: pads are -2e38
        got = check.fn(*args)[0][..., :cfg.vocab_size]
        want = decoding.prefill(params, args[1]["tokens"], cfg,
                                CELL_CHECK_SEQ, impl="plain",
                                hints=check.hints)[0][..., :cfg.vocab_size]
    judge.check("cells: prefill logits finite", bool(
        torch.isfinite(got).all() and torch.isfinite(want).all()),
        f"{tuple(got.shape)}, max |logit| {float(want.abs().max()):.4g}")
    judge(f"cells: prefill logits at {CELL_CHECK_SEQ}, kernels vs plain",
          errors(got, want)[1], 5e-2, "of max |logit|: bf16 roundings "
          f"of p in the sliding window, carried through {cfg.num_layers} "
          "layers")
    del args, got, want
    _cell_attention(judge, cfg)

    total = {name: 0 for name in ops.KERNELS}
    lines = []
    for name, kind, seq, batch in CELL_SHAPES:
        shape = ShapeConfig(name, kind, seq, batch)
        rec = run_cell(CELL_ARCH, shape, remat_policy=TRAIN_REMAT,
                       microbatches=1, mesh=meta)
        if rec["status"] != "ok":
            raise SmokeFailure(f"cell {name}: {rec.get('error')}")
        mem = rec["memory"]
        cell = build_cell(CELL_ARCH, shape, mesh, remat_policy=TRAIN_REMAT,
                          microbatches=1)
        if kind == "train":           # the step updates its params
            params = None
            _free()
            gen = torch.Generator(device=DEVICE).manual_seed(SEED)
            params = tfm.init_params(cfg, gen, DEVICE)
        args = _cell_args(cell, gen, params)
        n_bytes = _tensor_bytes(args)
        judge.check(f"cells: {name} argument bytes", n_bytes ==
                    mem["argument_size_in_bytes"], f"{n_bytes} B on the "
                    f"card, {mem['argument_size_in_bytes']:.0f} B in the "
                    "dry-run record")
        grad = torch.enable_grad() if kind == "train" else torch.no_grad()
        with grad:
            sync()
            _reset_peak()
            ops.reset_launches()       # the main path: one step of the cell
            cell.fn(*args)
            sync()
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" \
                else float("nan")
            want = _cell_launches(cfg, kind)
            judge.check(f"cells: {name} launches", counts == want,
                        f"{counts} (want {want})")
            total = {k: total[k] + counts[k] for k in total}
            floor = (mem["argument_size_in_bytes"]
                     + mem["output_size_in_bytes"]
                     - mem["alias_size_in_bytes"])
            judge.check(f"cells: {name} peak memory", DEVICE != "cuda"
                        or peak >= floor, f"{peak:.0f} B >= arguments + "
                        f"outputs - aliases {floor:.0f} B")
            ms = _cell_ms(cell.fn, args, CELL_REPS) if DEVICE == "cuda" \
                else float("nan")
        t_total = max(rec["t_compute_s"], rec["t_memory_s"],
                      rec["t_collective_s"])
        measured = rec["model_flops_per_chip"] / (ms / 1e3) \
            / BF16_FLOP_PER_S
        line = (f"cell {cfg.name} {name} ({kind}, {batch} x {seq}): "
                f"{ms:.3f} ms a step (CUDA events, {CELL_REPS} after a "
                f"warm-up) against the record's t_total "
                f"{1e3 * t_total:.3f} ms ({rec['bound']}; roofline "
                f"fraction {rec['roofline_fraction']:.4f}, measured "
                f"{measured:.4f}); {rec['flops_per_chip']:.4g} flops, "
                f"{rec['model_flops_per_chip']:.4g} model flops; "
                f"arguments {mem['argument_size_in_bytes']:.0f} B, peak "
                f"{peak / 2**30:.2f} GiB, temporaries "
                f"{(peak - n_bytes) / 2**30:.2f} GiB")
        log(f"  {line}")
        lines.append(line)
        del args, cell
    del params
    return total, lines


def phase_kernels_frontends(flush, judge):
    """The three kernels of the frontend models' path at their shapes,
    each against its plain version (the tolerances of the other models'
    lines) and for equal bits on a second call, timed beside its plain
    version, its library call and its bound: the ungated fused MLP at
    musicgen-large's widths (tanh-gelu, 2048 -> 8192 -> 2048) at its
    decode rows and at its plan's fused maximum, against the dense bf16
    ``gelu(x·w1)·w2`` through cuBLAS; the GEMM at musicgen's prefill rows
    (``MUSICGEN_GEMM_M``), w1 and w2, against ``torch.matmul``; the fused
    MLP at internvl2-26b's (silu, 6144 -> 16384 -> 6144) at 4 rows; the
    sliding window causal at musicgen's 32 / 32 heads of 64 over
    ``MUSICGEN_SWA_S`` positions, against SDPA with a boolean causal mask.
    Returns the log lines."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.plan import plan_for_scheduler
    from repro_torch.kernels import bcsc_matmul as bm
    from repro_torch.kernels import local_attention as swa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    log(f"kernels: fused MLP, GEMM and sliding window at {MUSICGEN} and "
        f"{INTERNVL} widths")
    lines = []

    def rows(M, d):
        # the kernel takes rows in eights: fewer come zero-padded
        x = torch.zeros(-(-M // 8) * 8, d, device=dev, dtype=torch.bfloat16)
        x[:M] = torch.randn(M, d, generator=gen, device=dev).bfloat16()
        return x

    mg = get_config(MUSICGEN)
    d, ff = mg.d_model, mg.d_ff
    fused = plan_for_scheduler(mg, **MUSICGEN_PLAN).mlp_fused_m_max
    w1 = _packed_weight(d, ff, 0.75, gen)
    w2 = _packed_weight(ff, d, 0.75, gen)
    counts = torch.stack([w1["nnzb"], torch.zeros_like(w1["nnzb"]),
                          w2["nnzb"]])
    for M in (MUSICGEN_PASSES[0][0], fused):
        lines.append(_mlp_line(MUSICGEN, rows(M, d), M, (w1, None, w2),
                               counts, ff, "gelu", flush, judge)[1])
    for name, K, N, w in (("w1", d, ff, w1), ("w2", ff, d, w2)):
        x = torch.randn(MUSICGEN_GEMM_M, K, generator=gen,
                        device=dev).bfloat16()

        def cu():
            return bm.bcsc_matmul_cuda(x, w["blocks"], w["row_ids"],
                                       w["col_ptr"], n_out=N)

        def plain():
            return bm.bcsc_matmul_plain(x, w["blocks"], w["row_ids"],
                                        w["col_ids"], n_out=N)
        got = cu()
        what = f"bcsc_matmul[{MUSICGEN} {name}: {MUSICGEN_GEMM_M}x{K}->{N}]"
        judge(what, errors(got, plain())[1], 1e-3, "relative to max |out|: "
              "tensor-core fp32 accumulation of the same bf16 products in "
              "another order")
        judge.check(f"{what}: the same bits on a second run",
                    bool(torch.equal(got, cu())), "fixed sum order")
        lines.append(_gemm_line(f"{MUSICGEN} {name}", x, w, N, cu, plain,
                                flush)[1])
        del x, got
    vl = get_config(INTERNVL)
    d, ff = vl.d_model, vl.d_ff
    packs = tuple(_packed_weight(K, N, 0.75, gen)
                  for K, N in ((d, ff), (d, ff), (ff, d)))
    counts = torch.stack([p["nnzb"] for p in packs])
    M = INTERNVL_PASSES[0][0]
    lines.append(_mlp_line(INTERNVL, rows(M, d), M, packs, counts, ff,
                           "silu", flush, judge)[1])
    del packs, w1, w2

    B, S = 1, MUSICGEN_SWA_S
    H, KV, D = mg.num_heads, mg.num_kv_heads, mg.head_dim
    q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()

    def cu_swa():
        return swa.sliding_window_attention_cuda(q, k, v, window=S)

    def plain_swa():
        return swa.sliding_window_attention_plain(q, k, v, window=S)
    got, want = cu_swa(), plain_swa()
    tag = f"{MUSICGEN} causal"
    judge(f"sliding_window_attention[{tag}: H {H}, KV {KV}, D {D}]",
          row_errors(got, want), 1e-2, "per (position, head) row, relative "
          "to that row's max |out|: keys walked in another order than "
          "flash's, so p rounds to bf16 against another running max, 2^-9 "
          "of each term")
    judge.check(f"sliding_window_attention[{tag}]: the same bits on a "
                "second run", bool(torch.equal(got, cu_swa())),
                "fixed key order")
    del got, want
    pos = torch.arange(S, device=dev)
    causal = pos[None, :] <= pos[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = band_pairs(S, S)
    ms, by = bound(2 * B * S * H * D + 2 * 2 * B * S * KV * D
                   + 4 * B * S * H * D, 4 * B * pairs * H * D)
    lc = swa.launch_config(B, S, H, KV, D)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=causal), flush)
    lines.append(
        f"sliding_window_attention ({tag}: B {B}, S {S}, H {H}, KV {KV}, D "
        f"{D}, {pairs} pairs per head; {lc['blocks']} blocks of "
        f"{lc['threads']} threads, {lc['stages']} K/V stages of "
        f"{lc['key_tile']} keys, {lc['smem_bytes']} bytes of shared "
        f"memory): {time_ms(cu_swa, flush):.4f} ms, plain "
        f"{time_ms(plain_swa, flush):.4f} ms, SDPA (boolean causal mask) "
        f"{sdpa_ms:.4f} ms, bound {ms:.4f} ms ({by})")
    for line in lines:
        log(f"  {line}")
    return lines


def _check_logits(llm, judge, lengths=(37, 64), tier=64):
    """The first prefill (two prompts at ``tier``: the GEMM arm, prefill
    attention) and decode (M 2: the fused MLP, paged attention, local
    rings) logits of the kernel path against ``impl="plain"`` on the same
    weights and tokens."""
    import torch
    from repro_torch.models import decoding
    cfg, plan, dev = llm.cfg, llm.plan, llm.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, tier), generator=gen,
                         device=dev)
    MP = plan.max_pages
    bt = torch.arange(2 * MP, dtype=torch.int32, device=dev).reshape(2, MP)
    out, nxt = {}, None
    for impl in (None, "plain"):
        cache = decoding.init_paged_cache(cfg, 2, plan.cache_len, 2 * MP,
                                          plan.page_size, "fp", device=dev)
        pp = decoding.PagedPrefill(cache=cache, block_table_rows=bt,
                                   slots=torch.arange(2, device=dev))
        logits, cache = decoding.prefill_batched(
            llm.params, toks, lengths, cfg, plan.cache_len, plan=plan,
            paged=pp, impl=impl)
        if nxt is None:
            nxt = logits[:, -1].argmax(-1)[:, None]
        step, _ = decoding.serve_step(llm.params, cache, nxt, lengths.long(),
                                      cfg, plan=plan, block_table=bt,
                                      impl=impl)
        out[impl] = (logits[..., :cfg.vocab_size], step[..., :cfg.vocab_size])
    sync()
    for i, what in enumerate(("prefill", "decode")):
        got, want = out[None][i], out["plain"][i]
        ok = bool(torch.isfinite(got).all())
        judge.check(f"{what} logits finite", ok, f"{tuple(got.shape)}")
        judge(f"{cfg.name} {what} logits, kernels vs plain",
              errors(got, want)[1], 5e-2,
              f"relative to max |logit| after {cfg.num_layers} layers: sums "
              "in another order flip bf16 roundings, which the layers carry "
              "forward")


def _layer_errors(llm, judge, lengths=(37, 64), tier=64):
    """Where the logits gap of ``_check_logits`` comes from, layer by layer,
    on the same two prompts: the prefill, then the decode step after it.

    Teacher-forced: each layer's attention and MLP take the plain path's
    residual stream as input under both impls, so their difference is that
    sublayer's own (its kernels against their plain versions at the model's
    real activations). Free-running: the two paths' residual streams after
    each layer, each fed by its own, which is how the sublayers' own
    differences add up through the depth. Each error is normwise, |a - b| /
    |b| over the real positions. Returns the log lines."""
    import torch
    from repro_torch.models import decoding as dec
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rms_norm
    cfg, plan, dev, params = llm.cfg, llm.plan, llm.device, llm.params
    eps, cache_len = cfg.norm_eps, plan.cache_len
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, tier), generator=gen,
                         device=dev)
    real = torch.arange(tier, device=dev)[None, :] < lens[:, None].long()
    one = torch.ones(2, 1, dtype=torch.bool, device=dev)   # (B, 1) steps

    def rel(a, b, mask=real):
        a, b = a.float()[mask], b.float()[mask]
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    both = (None, "plain")
    pos = torch.arange(tier, device=dev)[None, :].expand(2, tier)
    x_p = x_k = tfm.embed_tokens(params, toks, cfg)
    pre = []
    for i in range(tfm.num_scan_periods(cfg)):
        for name, kind in tfm.slot_names(cfg):
            p = tfm.layer(params["blocks"][name], i)
            h = rms_norm(x_p, p["pre_norm"], eps)
            a = {impl: dec._attn_prefill(p["attn"], h, kind, pos, cfg,
                                         cache_len, lens, impl=impl)[0]
                 for impl in both}
            x2 = tfm.residual(x_p, a["plain"], p, "post_norm", cfg)
            h2 = rms_norm(x2, p["pre_norm_mlp"], eps)
            m = {impl: layers.mlp(p["mlp"], h2, cfg, plan, impl=impl)
                 for impl in both}
            x_k, _ = dec._block_prefill(p, x_k, kind, pos, cfg, cache_len,
                                        lens, None, None, plan, None)
            x_p = tfm.residual(x2, m["plain"], p, "post_norm_mlp", cfg)
            pre.append((kind, rel(a[None], a["plain"]),
                        rel(m[None], m["plain"]), rel(x_k, x_p)))
    # each path's logits at the last real positions, with and without the
    # final softcap, which bounds max |logit| but passes a difference in
    # its linear range on at slope ~1
    idx = (lens.long() - 1)[:, None, None].expand(2, 1, cfg.d_model)
    logits = {}
    for tag, x in (("kernels", x_k), ("plain", x_p)):
        h = rms_norm(torch.gather(x, 1, idx), params["final_norm"], eps)
        logits[tag] = [tfm.lm_logits(params, h, c)[..., :cfg.vocab_size]
                       for c in (cfg, dataclasses.replace(
                           cfg, final_logit_softcap=0.0))]
    head = []
    for i, what in enumerate((f"final softcap {cfg.final_logit_softcap:g}",
                              "no final softcap")):
        got, want = logits["kernels"][i], logits["plain"][i]
        head.append(f"{what}: {errors(got, want)[1]:.2e} of max |logit| "
                    f"{float(want.abs().max()):.1f} (std "
                    f"{float(want.std()):.2f}), normwise "
                    f"{rel(got, want, one):.2e}")

    # decode: the plain path's prefill fills the cache; each layer's new
    # K/V is written from the plain stream by the teacher-forced calls,
    # after the free-running call has written and read its own
    MP = plan.max_pages
    bt = torch.arange(2 * MP, dtype=torch.int32, device=dev).reshape(2, MP)
    cache = dec.init_paged_cache(cfg, 2, cache_len, 2 * MP, plan.page_size,
                                 "fp", device=dev)
    logits, cache = dec.prefill_batched(
        params, toks, lens, cfg, cache_len, plan=plan, impl="plain",
        paged=dec.PagedPrefill(cache=cache, block_table_rows=bt,
                               slots=torch.arange(2, device=dev)))
    x_p = x_k = tfm.embed_tokens(params, logits[:, -1].argmax(-1)[:, None],
                                 cfg)
    posv = lens.long()
    dec_rows = []
    for i in range(tfm.num_scan_periods(cfg)):
        for name, kind in tfm.slot_names(cfg):
            p = tfm.layer(params["blocks"][name], i)
            entry = tfm.layer(cache["blocks"][name], i)
            x_k = dec._block_decode(p, x_k, kind, entry, posv, cfg, plan, bt,
                                    None)
            h = rms_norm(x_p, p["pre_norm"], eps)
            a = {impl: dec._attn_decode(p["attn"], h, kind, entry, posv, cfg,
                                        bt, impl) for impl in both}
            x2 = tfm.residual(x_p, a["plain"], p, "post_norm", cfg)
            h2 = rms_norm(x2, p["pre_norm_mlp"], eps)
            m = {impl: layers.mlp(p["mlp"], h2, cfg, plan, impl=impl)
                 for impl in both}
            x_p = tfm.residual(x2, m["plain"], p, "post_norm_mlp", cfg)
            dec_rows.append((rel(a[None], a["plain"], one),
                             rel(m[None], m["plain"], one),
                             rel(x_k, x_p, one)))
    sync()
    lines = [f"{cfg.name} per layer, kernels vs plain, normwise "
             "(prefill: attention, MLP teacher-forced; residual "
             "free-running | decode: the same)"]
    for n, ((kind, pa_, pm, pr), (da, dm, dr)) in enumerate(zip(pre,
                                                                dec_rows)):
        lines.append(f"  layer {n:2d} {kind:6s}: prefill {pa_:.2e} {pm:.2e} "
                     f"{pr:.2e} | decode {da:.2e} {dm:.2e} {dr:.2e}")
    lines += [f"  prefill logits, kernels vs plain, {h}" for h in head]
    for line in lines:
        log(f"  {line}")
    own = max(max(r[1], r[2]) for r in pre)
    own = max([own] + [max(r[0], r[1]) for r in dec_rows])
    judge(f"{cfg.name} per-layer attention and MLP, kernels vs plain on the "
          "same input", own, 1e-2, "normwise over the real positions: bf16 "
          "outputs, a value that rounds to the other neighbour moves by "
          "2^-8 of itself")
    return lines


def _serve(llm, requests, judge, tag, max_new, must_launch,
           entry="stream"):
    """One ``LLM.stream`` (or ``LLM.generate``) run with the launch counts
    zeroed just before and read just after; checks every request's tokens.
    Returns (finished requests, launch counts, phase stats, wall seconds)."""
    from repro_torch.kernels import ops
    vocab = llm.cfg.vocab_size
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = getattr(llm, entry)(requests)
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    st = llm.phase_stats
    ok = len(done) == len(requests) and all(
        len(r.out) == max_new and all(0 <= t < vocab for t in r.out)
        for r in done)
    judge.check(f"{tag}: tokens", ok,
                f"{len(done)} requests x {max_new} in-vocab tokens")
    for name in must_launch:
        judge.check(f"{tag}: {name} launched", counts[name] > 0,
                    f"{counts[name]} launches")
    generated = sum(len(r.out) for r in done)
    steps = max(_decode_steps(llm, st), 1)
    log(f"  {tag}: wall {wall:.2f} s; prefill {st['prefill_real_tokens']} "
        f"tokens in {st['prefill_batches']} batches, "
        f"{st['prefill_real_tokens'] / max(st['prefill_s'], 1e-9):.1f} "
        f"tokens/s; decode {generated} tokens in {steps} steps "
        f"({st['decode_chunks']} chunks), "
        f"{generated / max(st['decode_s'], 1e-9):.1f} tokens/s; "
        f"preemptions {st.get('preemptions', 0)}; launches {counts}; per "
        f"decode step {counts['paged_attention'] / steps:.1f} "
        f"paged-attention and {counts['bcsc_mlp'] / steps:.1f} fused-MLP "
        f"launches; per prefill batch "
        f"{counts['sliding_window_attention'] / max(st['prefill_batches'], 1):.1f}"
        " sliding-window launches")
    return done, counts, st, wall


def _decode_steps(llm, st) -> int:
    """Decode steps of a run: the scheduler counts them, the drain engine
    counts chunks of ``sync_every``."""
    return st.get("decode_steps", st["decode_chunks"] * llm.plan.sync_every)


def _graph_step(graph, n: int = 16):
    """(device ms, busy ms, idle) per replay of a captured decode step:
    ``n`` replays back to back, timed by CUDA events around them; then
    ``n`` more under ``torch.profiler``, whose kernels' device times are
    summed (None when the trace holds no device time). Tracing lengthens
    the kernels by a few percent, so a busy time at or just above the step
    time means the device never idled between the graph's kernels.
    ``idle`` lists the three pairs of kernels (one, the next) with the
    most idle time on the device between them, in ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def replays():
        for _ in range(n):
            graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    replays()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replays()
        torch.cuda.synchronize()
    kernels = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                     for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy = sum(end_ - start_ for start_, end_, _ in kernels)
    idle = {}
    for (_, end0, prev), (start1, _, name) in zip(kernels, kernels[1:]):
        pair = f"{prev[:60]} -> {name[:60]}"
        idle[pair] = idle.get(pair, 0.0) + max(start1 - end0, 0.0)
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:3]
    return (start.elapsed_time(end) / n,
            busy / 1e3 / n if busy > 0 else None,
            [(name, t / 1e3 / n) for name, t in top])


def _turns(llm, make_requests, judge, tag, max_new, must_launch,
           entry="stream"):
    """A serve pass in both decode modes, in turns on one card: graphed
    (its first run captures the step graph), eager (``decode_graphs=False``
    on the same weights), graphed again (the captured graph replayed: the
    main path's run, whose counts are returned). The three must give equal
    streams token for token, and the second graphed run the eager run's
    launch counts exactly. The line of rates gives prefill and decode
    tokens/s in both modes, the graphed step's device time, busy share and
    capture time, and the peak of device memory over the pass. Returns
    (launch counts, phase stats, wall seconds, the line of rates)."""
    from repro_torch.serve import LLM
    _reset_peak()
    eager = LLM(llm.cfg, llm.params, llm.plan, eos_id=-1, device=DEVICE,
                decode_graphs=False)
    engine = llm._scheduler if entry == "stream" else None
    first, _, _, _ = _serve(llm, make_requests(), judge,
                            f"{tag} [graphed, capturing]", max_new, (),
                            entry)
    engine = engine or llm._engine
    captured = engine.graph
    runs = {"eager": _serve(eager, make_requests(), judge, f"{tag} [eager]",
                            max_new, must_launch, entry),
            "graphed": _serve(llm, make_requests(), judge,
                              f"{tag} [graphed]", max_new, must_launch,
                              entry)}
    streams = [[r.out for r in done] for done in
               (first, runs["eager"][0], runs["graphed"][0])]
    judge.check(f"{tag}: graphed and eager streams equal token for token",
                streams[0] == streams[1] == streams[2],
                f"{sum(len(o) for o in streams[1])} tokens, three runs")
    judge.check(f"{tag}: graphed launches equal the eager run's",
                runs["graphed"][1] == runs["eager"][1],
                f"{runs['graphed'][1]} vs {runs['eager'][1]}")
    rate, pre = {}, {}
    for mode, (done, _, st, _) in runs.items():
        generated = sum(len(r.out) for r in done)
        rate[mode] = generated / max(st["decode_s"], 1e-9)
        pre[mode] = st["prefill_real_tokens"] / max(st["prefill_s"], 1e-9)
    line = (f"{tag}: decode {rate['graphed']:.1f} tokens/s graphed, "
            f"{rate['eager']:.1f} eager ({rate['graphed'] / rate['eager']:.2f}"
            f"x); prefill {pre['graphed']:.1f} tokens/s graphed run, "
            f"{pre['eager']:.1f} eager run")
    graph = engine.graph
    if DEVICE == "cuda":
        judge.check(f"{tag}: decode step captured", graph is not None
                    and graph is captured,
                    "one step graph, reused by the second graphed run")
    if graph is not None:
        step_ms, busy, idle = _graph_step(graph)
        line += (f"; graphed step {step_ms:.3f} ms on the device "
                 f"({sum(graph.tally.values())} port-kernel launches in "
                 "it), kernels busy "
                 + (f"{busy:.3f} ms of it ({busy / step_ms:.1%}, traced)"
                    if busy else "not measured (no device time in the "
                    "trace)")
                 + f"; capture {graph.capture_s:.2f} s")
        log(f"  {tag}: most idle time between two kernels, ms per graphed "
            "step (traced): " + "; ".join(f"{t:.3f} {pair}"
                                          for pair, t in idle))
    line += f"; {_memory('peak of the pass')}"
    log(f"  {line}")
    _, counts, st, wall = runs["graphed"]
    return counts, st, wall, line


def _requests(cfg, lengths, max_new, arrivals):
    import torch
    from repro_torch.serve import StreamRequest
    gen_cpu = torch.Generator().manual_seed(SEED)
    return [StreamRequest(i, torch.randint(0, cfg.vocab_size, (n,),
                                           generator=gen_cpu).tolist(),
                          max_new, arrival=float(a))
            for i, (n, a) in enumerate(zip(lengths, arrivals))]


def _reset_peak():
    import torch
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _memory(what):
    """The peak of device memory allocated since the last ``_reset_peak``
    and what is allocated now, in GiB."""
    import torch
    if DEVICE != "cuda":
        return f"{what}: not measured (CPU)"
    return (f"{what}: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"(allocated now {torch.cuda.memory_allocated() / 2**30:.2f} "
            "GiB)")


def _free():
    """Free what earlier passes left on the card (their models, caches and
    step graphs, which reference cycles may hold until a collection)
    before the next model loads."""
    import gc
    import torch
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        log(f"  freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
            "still allocated before the next load")


def _load(arch, plan_kw, layers: int = 0, layered: bool = False):
    """Full-width random weights from SEED, MLPs packed at 0.75, on the
    device behind ``LLM`` with a paged fp plan (contiguous when the config
    has no global layer), at ``layers`` of the config's layers when given.
    Frees the previous model first and prints the peak of device memory
    over the load (the fp32 weights of ``init_params`` beside one layer's
    packing temporaries, or beside their bf16 copies). ``layered`` builds
    the packed bf16 tree one layer at a time instead
    (``serve.sparse.build_sparse_params``: the tree beside one layer's fp32
    draw and its packing temporaries)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.plan import plan_for_scheduler
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import LLM
    from repro_torch.serve.sparse import (build_sparse_params,
                                          sparsify_mlp_params)

    _free()
    _reset_peak()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    if layered:
        packed, stats = build_sparse_params(cfg, SEED, 0.75, device=DEVICE)
    else:
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        params = tfm.init_params(cfg, gen, DEVICE)
        packed, stats = sparsify_mlp_params(params, cfg, sparsity=0.75)
        del params
    plan = plan_for_scheduler(cfg, attn_path="paged", kv_quant="fp",
                              sync_every=8, **plan_kw)
    llm = LLM(cfg, packed, plan, eos_id=-1, device=DEVICE)
    del packed
    sync()
    packing = (f"MLPs packed at block density {stats['block_density']:.3f} "
               f"({stats['kept_blocks']} blocks)" if stats["packed"]
               else "no MLP to pack")
    log(f"serve: {arch}, {cfg.num_layers} layers {cfg.attn_pattern}, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, head_dim {cfg.head_dim}; "
        f"{packing}; loaded"
        + (" one layer at a time" if layered else "") + " in "
        f"{time.perf_counter() - t0:.1f} s; {_memory('load peak')}; "
        f"plan rows {plan.rows}, cache {plan.cache_len}, page "
        f"{plan.page_size}, {plan.num_pages} pages, fused MLP up to M "
        f"{plan.mlp_fused_m_max}")
    return llm


def _per_step_checks(judge, tag, counts, layers, n_global, steps,
                     mlp="bcsc_mlp", mlp_per_layer=1):
    """Launches per decode step of a run: paged attention once per global
    layer, the MLP kernel at least ``mlp_per_layer`` times per layer (plus
    short prefills)."""
    judge.check(f"{tag}: paged-attention launches per decode step",
                counts["paged_attention"] == n_global * steps,
                f"{counts['paged_attention']} = {n_global} x {steps} steps")
    judge.check(f"{tag}: {mlp} launches per decode step",
                counts[mlp] >= mlp_per_layer * layers * steps,
                f"{counts[mlp]} >= {mlp_per_layer} x {layers} x {steps} "
                "steps (plus short prefills)")


def _mesh_plan(llm, mesh, kv_quant="fp", **change):
    """``plan_serve`` at ``llm``'s plan's geometry (rows, cache, page size,
    attention path, sync cadence) on a 40e9 B budget, the pool fully
    provisioned (no preemption, no int8 rung), speculation off, over
    ``mesh`` (None: one device); ``change`` replaces plan fields after."""
    from repro_torch.core.plan import plan_serve
    p = llm.plan
    plan = plan_serve(
        llm.cfg, hbm_budget_bytes=int(40e9), expected_batch=p.rows,
        expected_len_dist={"mean": p.cache_len / 2, "max": p.cache_len},
        page_size=p.page_size,
        num_pages=p.rows * p.max_pages if p.paged else None,
        attn_path=p.attn_path, kv_quant=kv_quant, sync_every=p.sync_every,
        spec_k=0, mesh=mesh)
    return dataclasses.replace(plan, **change) if change else plan


def _sharded_pass(llm, judge, tag, mesh, lens, new, kv_quant="fp",
                  **change):
    """A sharded ``LLM.stream`` pass on ``llm``'s weights, under the
    reference's defaults (guard and tracer on, prefix sharing on a paged
    plan), graphed, beside the same plan on one device (``_mesh_plan``):
    both capture their step first, then run in turns (one device, the
    mesh, the mesh, one device) and the mesh once more under the profiler.
    Every run gives the one-device streams; each timed mesh run launches
    what the one-device run does, except paged attention tp times as
    often (once per shard per global layer per decode step); the card
    runs one device-to-host copy per decode chunk; ``sharding_report()``
    shows no lockstep divergence and per-device pool bytes of 1/tp; the
    ``collective_*`` counters equal ``chunk_collectives``' model for the
    run (these two are consistency checks: the bytes are a division and
    the scheduler counts the collectives with that model). Returns (the last timed mesh run's launch counts, the line of
    rates: decode tokens/s of both, graphed step device ms of both)."""
    from repro_torch.core.plan import num_global_layers
    from repro_torch.serve import LLM, shard
    cfg = llm.cfg
    plans = {m: _mesh_plan(llm, m, kv_quant, **change) for m in (None, mesh)}
    sharded = plans[mesh]
    tp = sharded.tp
    llms = {m: LLM(cfg, llm.params, p, eos_id=-1, device=DEVICE)
            for m, p in plans.items()}
    runs = {None: [], mesh: []}
    _reset_peak()
    for m in (None, mesh, None, mesh, mesh, None):
        runs[m].append(_guarded_run(llms[m], _requests(cfg, lens, new,
                                                       [0] * len(lens))))
    traced = _guarded_run(llms[mesh], _requests(cfg, lens, new,
                                                [0] * len(lens)),
                          transfers=True)
    want = [r.out for r in runs[None][0].done.values()]
    ok = all(len(o) == new and all(0 <= t < cfg.vocab_size for t in o)
             for o in want)
    judge.check(f"{tag}: tokens", ok, f"{len(lens)} requests x {new}")
    streams = [[r.out for r in run.done.values()]
               for run in runs[None] + runs[mesh] + [traced]]
    judge.check(f"{tag}: {mesh} streams equal one device's token for token",
                all(o == want for o in streams),
                f"{len(streams)} runs, {sum(len(o) for o in want)} tokens "
                "each")
    judge.check(f"{tag}: every outcome ok and kv {kv_quant} throughout",
                all(r.outcome.ok for run in runs[mesh] + [traced]
                    for r in run.done.values())
                and all(run.st["kv_quant"] == kv_quant
                        for run in runs[None] + runs[mesh]),
                f"{len(lens)} requests a run")
    one, many = runs[None][-1], runs[mesh][-1]
    steps = one.st["decode_steps"]
    n_global = num_global_layers(cfg) if plans[None].paged else 0
    expect = dict(one.counts, paged_attention=tp * one.counts[
        "paged_attention"])
    judge.check(f"{tag}: paged attention once per global layer per decode "
                "step on one device",
                one.counts["paged_attention"] == n_global * steps,
                f"{one.counts['paged_attention']} = {n_global} x {steps}")
    judge.check(f"{tag}: the mesh launches paged attention once per shard "
                "per global layer per step, the rest as one device",
                many.counts == expect and many.st["decode_steps"] == steps,
                f"{many.counts} vs {expect}: +{(tp - 1) * n_global} per "
                "step")
    _transfer_check(judge, f"{tag} [graphed, profiled]", traced,
                    traced.st["decode_chunks"], "decode chunks")
    rep = llms[mesh].sharding_report()
    counters = llms[mesh].telemetry().metrics.snapshot().counters
    model = shard.chunk_collectives(sharded, steps=traced.st["decode_steps"],
                                    tokens=counters["tokens_emitted"])
    judge.check(f"{tag}: sharding report (divergence; per-device KV "
                "bytes x tp = the whole, a consistency check)",
                rep.get("lockstep_divergence", 0) == 0
                and rep["kv_bytes_per_device"] * tp
                == rep["kv_bytes_single_device"]
                and (rep.get("shards") == tp) == sharded.paged,
                f"{rep}")
    judge.check(f"{tag}: collective counters equal the mesh decision's "
                "model (a consistency check: the scheduler counts with it)", counters["collective_allgather_bytes"] > 0
                and all(counters[k] == v for k, v in model.items()),
                f"{ {k: counters[k] for k in model} } vs {model}")
    rate = {m: [sum(len(r.out) for r in run.done.values())
                / max(run.st["decode_s"], 1e-9) for run in runs[m][1:]]
            for m in runs}
    mean = {m: sum(v) / len(v) for m, v in rate.items()}
    line = (f"{tag} ({cfg.name}, {cfg.num_layers} layers, {mesh} against one "
            f"device, {kv_quant} KV, graphed, in turns): decode "
            f"{mean[mesh]:.1f} tokens/s ("
            + ", ".join(f"{v:.1f}" for v in rate[mesh])
            + f") against {mean[None]:.1f} ("
            + ", ".join(f"{v:.1f}" for v in rate[None])
            + f"), {mean[mesh] / mean[None]:.3f}x")
    if DEVICE == "cuda":
        ms = {m: _graph_step(llms[m]._scheduler.graph)[0] for m in llms}
        line += (f"; graphed step {ms[mesh]:.3f} ms on the device against "
                 f"{ms[None]:.3f} ms")
    line += (f"; paged-attention launches a step {tp * n_global} against "
             f"{n_global}; collective bytes {counters['collective_allgather_bytes']}"
             f" ({counters['collective_ops']} gathers); "
             f"{_memory('peak of the pass')}")
    log(f"  {line}")
    del llms
    return many.counts, line


def phase_serve(judge):
    """Full-width, full-depth qwen2.5-3b: through ``LLM.stream`` a paged fp
    pass on the default plan and an int8 pass on the two-call MLP route,
    then through ``LLM.generate`` a drain pass on ``plan_for_engine``'s
    contiguous plan; each pass graphed and eager in turns (``_turns``).
    Returns (the graphed runs' summed launch counts, lines of rates)."""
    from repro_torch.core.plan import (num_global_layers, plan_for_engine,
                                       plan_for_scheduler)
    from repro_torch.serve import LLM

    llm = _load(ARCH, dict(rows=8, cache_len=1024, page_size=64))
    cfg = llm.cfg
    layers = cfg.num_layers
    _check_logits(llm, judge)
    _layer_errors(llm, judge)
    lens = [5, 37, 64, 130, 300, 511] * 2
    launches, st, _, line = _turns(
        llm, lambda: _requests(cfg, lens, 32,
                               [8 * (i // 4) for i in range(12)]),
        judge, "qwen fp pass", 32,
        ("sliding_window_attention", "paged_attention", "bcsc_mlp",
         "bcsc_matmul"))
    _per_step_checks(judge, "qwen fp pass", launches, layers,
                     num_global_layers(cfg), st["decode_steps"])
    lines = [line]
    plan8 = dataclasses.replace(
        plan_for_scheduler(cfg, rows=8, cache_len=1024, page_size=64,
                           attn_path="paged", kv_quant="int8", sync_every=8),
        mlp_fused_m_max=0)
    llm8 = LLM(cfg, llm.params, plan8, eos_id=-1, device=DEVICE)
    counts8, st8, _, line = _turns(
        llm8, lambda: _requests(cfg, [5, 130, 300, 511], 8, [0] * 4),
        judge, "qwen int8 pass", 8,
        ("paged_attention", "bcsc_gemv", "bcsc_matmul"))
    _per_step_checks(judge, "qwen int8 pass", counts8, layers,
                     num_global_layers(cfg), st8["decode_steps"],
                     mlp="bcsc_gemv", mlp_per_layer=3)
    lines.append(line)
    del llm8
    counts_s, line = _sharded_pass(
        llm, judge, "qwen int8 tp=2 pass", "tp=2", SHARDED_QWEN_LENS,
        SHARDED_NEW, kv_quant="int8", mlp_fused_m_max=0)
    lines.append(line)
    llm_g = LLM(cfg, llm.params, plan_for_engine(cfg, slots=8,
                                                 cache_len=1024),
                eos_id=-1, device=DEVICE)
    counts_g, st_g, _, line = _turns(
        llm_g, lambda: _requests(cfg, GENERATE_LENS, GENERATE_NEW,
                                 [0] * len(GENERATE_LENS)),
        judge, "qwen generate pass", GENERATE_NEW, ("bcsc_mlp",),
        entry="generate")
    eng = llm_g._engine
    judge.check("qwen generate pass: one host transfer per decode chunk",
                eng.host_syncs == 2 * st_g["decode_chunks"],
                f"{eng.host_syncs} transfers over its two runs of "
                f"{st_g['decode_chunks']} chunks")
    judge.check("qwen generate pass: fused-MLP launches per decode step",
                counts_g["bcsc_mlp"] >= layers * _decode_steps(llm_g, st_g),
                f"{counts_g['bcsc_mlp']} >= {layers} x "
                f"{_decode_steps(llm_g, st_g)} steps")
    lines.append(line + f"; host_syncs {st_g['decode_chunks']} a run")
    total = {k: launches[k] + counts8[k] + counts_g[k] + counts_s[k]
             for k in launches}
    return total, lines, llm


def _device_transfers(fn):
    """``fn()`` under a profiler trace of the card and the sync debug mode
    "warn". Returns (fn's result, the device-to-host copies the card ran,
    {"file:line": n} of every host-blocking call the debug mode saw, host-
    to-device copies included). The count is what the card did, not what
    the scheduler says it did: an ``.item()``, ``.cpu()`` or
    ``bool(tensor)`` anywhere in the run is one more copy. None and {} on
    the CPU."""
    import collections
    import warnings
    import torch
    if DEVICE != "cuda":
        return fn(), None, {}
    from torch.profiler import ProfilerActivity, profile
    with warnings.catch_warnings(record=True) as seen, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    # the raw trace: building the profiler's event tree for an eager run's
    # ~10^5 kernels would take minutes
    dtoh = sum(1 for e in prof.profiler.kineto_results.events()
               if e.name().startswith("Memcpy DtoH"))
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in seen
        if "synchronizing CUDA operation" in str(w.message))
    return out, dtoh, dict(sites)


def _sites(sites):
    return ", ".join(f"{k} x{v}" for k, v in sorted(
        sites.items(), key=lambda kv: -kv[1])) or "none"


def _guarded_run(llm, requests, chaos=None, transfers=False):
    """One ``LLM.stream`` run with the launch counts zeroed just before and
    read just after; nothing is checked here (a chaos run's failed requests
    are short). With ``transfers`` the run goes through
    ``_device_transfers``. Returns a namespace: ``done`` (requests by rid),
    ``counts`` (launches), ``st`` (phase stats), ``syncs`` (the scheduler's
    ``host_syncs`` of the run), ``wall`` (seconds, synchronized at both
    ends), ``rung`` ((paged-attention launches, decode steps) on the fp
    pool when the int8 rung fired, else None), ``dtoh`` and ``sites`` (see
    ``_device_transfers``; None and {} unless measured)."""
    import types
    from repro_torch.kernels import ops
    sch = llm._scheduler
    syncs = sch.host_syncs
    at_rung = []

    def watch(r, t):
        # tokens of a chunk arrive after it: the last counts read before the
        # rung's flag appears hold every launch and step made on the fp pool
        if "degraded_to_int8_at" not in sch.phase_stats:
            at_rung[:] = [(ops.launch_counts()["paged_attention"],
                           sch.phase_stats["decode_steps"])]
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    if transfers:
        done, dtoh, sites = _device_transfers(
            lambda: llm.stream(requests, chaos=chaos, on_token=watch))
    else:
        done = llm.stream(requests, chaos=chaos, on_token=watch)
        dtoh, sites = None, {}
    sync()
    wall = time.perf_counter() - t0
    st = llm.phase_stats
    return types.SimpleNamespace(
        done={r.rid: r for r in done}, counts=ops.launch_counts(), st=st,
        syncs=sch.host_syncs - syncs, wall=wall,
        rung=at_rung[0] if "degraded_to_int8_at" in st and at_rung
        else None, dtoh=dtoh, sites=sites)


def _transfer_check(judge, tag, run, want, what):
    """The card's device-to-host copies in ``run`` against ``want``."""
    if run.dtoh is None:
        judge.check(f"{tag}: device-to-host copies", True,
                    "not measured (CPU)")
        return
    judge.check(f"{tag}: device-to-host copies the card ran == {what}",
                run.dtoh == want,
                f"{run.dtoh} copies in the profiler trace, {want} {what} "
                f"({run.st['decode_chunks']} chunks, host_syncs "
                f"{run.syncs}); host-blocking calls by site: "
                f"{_sites(run.sites)}")


def phase_serve_guarded(judge, llm):
    """Full-width qwen2.5-3b (the model ``phase_serve`` loaded) under the
    serving guard, which ``LLM`` runs by default with tracing on:

    * guard cost: the fp pass's requests through the default ``LLM`` and a
      guard-less, untraced one (``guard=False, trace=False``), graphed, in
      turns (default, off, off, default); equal streams; both rates
      printed, over the decode spans and over each run's wall time (the
      guard's host work at a boundary lies outside the decode spans); then
      one more run of each under ``_device_transfers``: the card ran one
      device-to-host copy per decode chunk;
    * pressure: ``PRESSURE_PAGES`` pages of 64 (rows 8, cache 1024) under 12
      staggered prompts: the int8 rung fires at a boundary with live rows,
      the graphed run captures its step again over the int8 pools (whose
      graph launches paged attention once per global layer), paged
      attention launches exactly once per global layer per decode step on
      each side of the rung (plus each capture's warm-up steps), every
      outcome is ok, and a fresh eager run, profiled, gives the same
      streams with one device-to-host copy per chunk; the second capture's
      seconds and the pass's peak memory are printed;
    * chaos: ``audit_every_sync`` and ``CHAOS`` (ensure failures, a
      transient step fault, a NaN on rid 2): every request terminal, no
      audit violation, survivors equal to the clean run, rid 2 failed as
      non-finite, the second run's device-to-host copies equal to
      ``host_syncs`` (the chunks and the NaN sweeps); two same-seed runs
      and an eager run give the same trace signature.

    Returns (the main-path runs' summed launch counts, lines of rates)."""
    from repro_torch.core.plan import num_global_layers, plan_for_scheduler
    from repro_torch.serve import LLM
    from repro_torch.serve.chaos import ChaosConfig
    from repro_torch.serve.graphs import WARMUP_STEPS
    from repro_torch.serve.guard import GuardConfig
    cfg = llm.cfg
    n_global = num_global_layers(cfg)
    lines = []
    judge.check("guarded: LLM serves under the default guard, traced",
                llm.guard == GuardConfig()
                and llm.telemetry().tracer.enabled, f"{llm.guard}")

    # ---- guard cost, in turns on one card
    lens = [5, 37, 64, 130, 300, 511] * 2
    arrivals = [8 * (i // 4) for i in range(12)]
    off = LLM(cfg, llm.params, llm.plan, eos_id=-1, device=DEVICE,
              guard=False, trace=False)
    off.stream(_requests(cfg, lens, 32, arrivals))          # captures
    rates = {"default": [], "off": []}
    wall_rates = {"default": [], "off": []}
    streams = {}
    total = None
    for mode in ("default", "off", "off", "default"):
        target = llm if mode == "default" else off
        run = _guarded_run(target, _requests(cfg, lens, 32, arrivals))
        done, st = run.done, run.st
        streams.setdefault(mode, [done[i].out for i in sorted(done)])
        generated = sum(len(r.out) for r in done.values())
        rates[mode].append(generated / max(st["decode_s"], 1e-9))
        wall_rates[mode].append(generated / max(run.wall, 1e-9))
        if mode == "default":
            judge.check("guard cost [default]: every request ok and traced",
                        all(r.outcome is not None and r.outcome.ok
                            for r in done.values())
                        and llm.telemetry().tracer.events
                        and "drift" in st,
                        f"{st['outcomes']}; "
                        f"{len(llm.telemetry().tracer.events)} trace "
                        f"events; drift {st['drift']}")
            total = run.counts
    judge.check("guard cost: guarded and guard-less streams equal",
                streams["default"] == streams["off"],
                f"{sum(len(o) for o in streams['off'])} tokens")
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    wmean = {k: sum(v) / len(v) for k, v in wall_rates.items()}

    def turns(v):
        return ", ".join(f"{x:.1f}" for x in v)
    lines.append(
        f"qwen fp pass, guard cost (graphed, in turns default/off/off/"
        f"default): decode {mean['default']:.1f} tokens/s with the default "
        f"guard and tracing ({turns(rates['default'])}), {mean['off']:.1f} "
        f"without ({turns(rates['off'])}); guarded/off "
        f"{mean['default'] / mean['off']:.3f}; end to end (generated "
        f"tokens over each run's wall time) {wmean['default']:.1f} "
        f"({turns(wall_rates['default'])}) against {wmean['off']:.1f} "
        f"({turns(wall_rates['off'])}); guarded/off "
        f"{wmean['default'] / wmean['off']:.3f}")
    log(f"  {lines[-1]}")
    for mode, target in (("default", llm), ("off", off)):
        run = _guarded_run(target, _requests(cfg, lens, 32, arrivals),
                           transfers=True)
        judge.check(f"guard cost [{mode}]: host_syncs == decode chunks",
                    run.syncs == run.st["decode_chunks"],
                    f"{run.syncs} transfers, {run.st['decode_chunks']} "
                    "chunks")
        _transfer_check(judge, f"guard cost [{mode}]", run,
                        run.st["decode_chunks"], "decode chunks")
    del off, target

    # ---- pressure: the int8 rung mid-run, graphed against eager. This
    # pass and the chaos pass keep share_prefix=False: their exact launch
    # counts and the rung's step were derived without sharing
    _free()
    _reset_peak()
    plan = plan_for_scheduler(cfg, rows=8, cache_len=1024, page_size=64,
                              num_pages=PRESSURE_PAGES, attn_path="paged",
                              share_prefix=False, kv_quant="fp",
                              sync_every=8)
    arrivals = [8 * (i // 4) for i in range(len(PRESSURE_LENS))]
    runs = {}
    for mode in ("graphed", "eager"):
        press = LLM(cfg, llm.params, plan, eos_id=-1, device=DEVICE,
                    decode_graphs=mode == "graphed")
        run = runs[mode] = _guarded_run(press, _requests(
            cfg, PRESSURE_LENS, PRESSURE_NEW, arrivals),
            transfers=mode == "eager")
        done, counts, st = run.done, run.counts, run.st
        tag = f"pressure pass [{mode}]"
        judge.check(f"{tag}: every outcome ok with its tokens",
                    all(r.outcome.ok and len(r.out) == PRESSURE_NEW
                        for r in done.values()), f"{st['outcomes']}")
        rung = st.get("degraded_to_int8_at")
        judge.check(f"{tag}: int8 rung fired mid-run",
                    st["kv_quant"] == "int8" and rung is not None
                    and rung > 0,
                    f"kv_quant {st['kv_quant']}, rung at step {rung} of "
                    f"{st['clock_steps']}, pool {plan.num_pages} -> "
                    f"{plan.num_pages_int8} pages, peak "
                    f"{st['pages_peak']['pages_used']} pages used, "
                    f"preemptions {st['preemptions']}")
        # each capture runs WARMUP_STEPS eager steps before it; the
        # capture's own launches come back only as its replays
        warm = WARMUP_STEPS * n_global if press._scheduler._loop.use_graph             else 0
        pa_rung, steps_rung = run.rung or (0, 0)
        after = counts["paged_attention"] - pa_rung
        steps_after = st["decode_steps"] - steps_rung
        judge.check(f"{tag}: paged-attention launches before the rung",
                    run.rung is not None
                    and pa_rung == n_global * steps_rung + warm,
                    f"{pa_rung} = {n_global} x {steps_rung} steps + {warm} "
                    "warm-up")
        judge.check(f"{tag}: paged-attention launches after the rung",
                    run.rung is not None and steps_after > 0
                    and after == n_global * steps_after + warm,
                    f"{after} = {n_global} x {steps_after} steps + {warm} "
                    "warm-up, from int8 pages")
        judge.check(f"{tag}: host_syncs == decode chunks",
                    run.syncs == st["decode_chunks"],
                    f"{run.syncs} transfers, {st['decode_chunks']} chunks")
        if mode == "eager":
            _transfer_check(judge, tag, run, st["decode_chunks"],
                            "decode chunks")
        if mode == "graphed":
            loop = press._scheduler._loop
            caps = loop.captures
            judge.check(f"{tag}: step graph captured again over the int8 "
                        "pool, paged attention in it",
                        DEVICE != "cuda" or (
                            len(caps) == 2 and loop.graph.tally.get(
                                "paged_attention") == n_global),
                        f"captures {['%.2f s' % c for c in caps]}; the int8 "
                        "graph's paged-attention launches "
                        f"{loop.graph.tally.get('paged_attention') if loop.graph else None}")
            total = {k: total[k] + counts[k] for k in total}
            lines.append(
                f"pressure pass: int8 rung at step {rung} ({len(done)} "
                f"requests, {st['decode_chunks']} chunks); second capture "
                + (f"{caps[1]:.2f} s (first {caps[0]:.2f} s)"
                   if len(caps) == 2 else "not made (CPU)")
                + f"; {after} paged-attention launches after the rung "
                f"({n_global} x {steps_after} steps + {warm} warm-up); "
                f"wall {run.wall:.2f} s; {_memory('peak of the pass')}")
    judge.check("pressure pass: graphed and eager streams equal",
                [runs["graphed"].done[i].out for i in sorted(runs["graphed"].done)]
                == [runs["eager"].done[i].out for i in sorted(runs["eager"].done)],
                f"{len(PRESSURE_LENS) * PRESSURE_NEW} tokens")
    log(f"  {lines[-1]}")
    del runs, press

    # ---- chaos: faults absorbed, survivors untouched, traces reproducible
    guard = GuardConfig(audit_every_sync=True, degrade_rungs=("shed",))
    unshared = dataclasses.replace(llm.plan, share_prefix=False)
    chaos_llm = LLM(cfg, llm.params, unshared, eos_id=-1, device=DEVICE,
                    guard=guard)
    eager = LLM(cfg, llm.params, unshared, eos_id=-1, device=DEVICE,
                guard=guard, decode_graphs=False)
    zero = [0] * len(CHAOS_LENS)
    clean = _guarded_run(
        chaos_llm, _requests(cfg, CHAOS_LENS, CHAOS_NEW, zero)).done
    sigs = []
    for target in (chaos_llm, chaos_llm, eager):
        run = _guarded_run(
            target, _requests(cfg, CHAOS_LENS, CHAOS_NEW, zero),
            chaos=ChaosConfig(**CHAOS), transfers=len(sigs) == 1)
        done, st = run.done, run.st
        tracer = target.telemetry().tracer
        sigs.append(tracer.signature())
        if target is eager:
            continue
        survivors = [r for r in done.values() if r.outcome.ok]
        judge.check("chaos pass: every request terminal, audits clean",
                    all(r.outcome is not None for r in done.values())
                    and not any(e.name == "pool_audit"
                                for e in tracer.events),
                    f"{st['outcomes']}; injected {st['chaos_injected']}; "
                    f"step retries {st['step_retries']}; preemptions "
                    f"{st['preemptions']}")
        judge.check("chaos pass: survivors equal the clean run",
                    survivors and all(r.out == clean[r.rid].out
                                      for r in survivors),
                    f"{len(survivors)} survivors")
        judge.check("chaos pass: the poisoned rid failed as non-finite",
                    done[2].outcome.status == "failed"
                    and "non-finite" in done[2].outcome.reason,
                    f"rid 2: {done[2].outcome.status}")
        if len(sigs) == 1:
            total = {k: total[k] + run.counts[k] for k in total}
        else:
            _transfer_check(judge, "chaos pass", run, run.syncs,
                            "host_syncs (chunks and NaN sweeps)")
    judge.check("chaos pass: same-seed trace signatures equal (graphed "
                "twice, eager)", sigs[0] == sigs[1] == sigs[2],
                f"{len(sigs[0])} bytes of signature")
    del chaos_llm, eager
    return total, lines


def _prefixed(cfg, suffixes, max_new, arrivals, twin=False):
    """Requests behind one ``SHARED_PREFIX``-token system prompt, each with
    its own random suffix (seeded); ``twin`` makes the last prompt equal to
    the one before it, whole."""
    import torch
    from repro_torch.serve import StreamRequest
    gen = torch.Generator().manual_seed(SEED + 2)
    prefix = torch.randint(0, cfg.vocab_size, (SHARED_PREFIX,),
                           generator=gen).tolist()
    prompts = [prefix + torch.randint(0, cfg.vocab_size, (n,),
                                      generator=gen).tolist()
               for n in suffixes]
    if twin:
        prompts[-1] = list(prompts[-2])
    return [StreamRequest(i, p, max_new, arrival=float(a))
            for i, (p, a) in enumerate(zip(prompts, arrivals))]


def _partings(llm, done, want):
    """Where each request's stream parts from ``want``'s (rid -> tokens):
    [(rid, token index, top-2 margin share)], the margin that of the
    kernel path's logits for the next token after the common prefix (one
    prefill of prompt and common tokens)."""
    import torch
    from repro_torch.models import decoding
    out = []
    for r in done:
        w = want[r.rid]
        t = next((i for i, (a, b) in enumerate(zip(r.out, w)) if a != b),
                 None)
        if t is None:
            continue
        toks = torch.tensor([list(r.prompt) + list(w[:t])],
                            device=llm.device)
        logits, _ = decoding.prefill(llm.params, toks, llm.cfg,
                                     toks.shape[1], plan=llm.plan)
        row = logits[0, -1, :llm.cfg.vocab_size].float()
        top = torch.topk(row, 2).values
        out.append((r.rid, t, float((top[0] - top[1]) / row.abs().max())))
    return out


def _equal_or_tie(judge, tag, llm, done, want):
    """Streams equal to ``want``'s, or parted only at near-ties."""
    parts = _partings(llm, done, want)
    judge.check(f"{tag}: streams equal, or parted only at a near-tie",
                all(m < NEAR_TIE for _, _, m in parts),
                f"{sum(len(r.out) for r in done)} tokens; partings (rid, "
                f"token, top-2 margin / max |logit|): {parts or 'none'}")


def _verify_check(llm, judge, k: int):
    """One row prefilled on the kernel path, then k candidates scored by
    one ``verify_step`` (B·k virtual rows, the paged attention split as for
    the real row) and by k sequential ``serve_step`` calls from the same
    state: the logits' largest gap relative to max |logit|, and the argmax
    equality."""
    import torch
    from repro_torch.models import decoding
    cfg, plan, dev = llm.cfg, llm.plan, llm.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    plen, MP = 300, plan.max_pages
    toks = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                         device=dev)
    cand = torch.randint(0, cfg.vocab_size, (1, k), generator=gen,
                         device=dev)
    bt = torch.arange(MP, dtype=torch.int32, device=dev)[None]
    lengths = torch.tensor([plen], dtype=torch.int32, device=dev)
    outs = {}
    for mode in ("verify", "sequential"):
        cache = decoding.init_paged_cache(cfg, 1, plan.cache_len, MP,
                                          plan.page_size, "fp", device=dev)
        pp = decoding.PagedPrefill(cache=cache, block_table_rows=bt,
                                   slots=torch.arange(1, device=dev))
        decoding.prefill_batched(llm.params, toks, lengths, cfg,
                                 plan.cache_len, plan=plan, paged=pp)
        if mode == "verify":
            lg, _ = decoding.verify_step(llm.params, cache, cand, lengths,
                                         cfg, plan=plan, block_table=bt)
            outs[mode] = lg[0]
        else:
            seq = []
            for i in range(k):
                lg, _ = decoding.serve_step(
                    llm.params, cache, cand[:, i:i + 1], lengths.long() + i,
                    cfg, plan=plan, block_table=bt)
                seq.append(lg[0, 0])
            outs[mode] = torch.stack(seq)
    sync()
    got, want = (outs[m][:, :cfg.vocab_size] for m in ("verify",
                                                       "sequential"))
    err = float((got - want).abs().max() / want.abs().max())
    same = "bit-equal" if torch.equal(got, want) else "not bit-equal"
    judge.check(f"verify_step (k {k}) vs {k} sequential steps: argmax",
                torch.equal(got.argmax(-1), want.argmax(-1)),
                f"largest gap {err:.3e} of max |logit| ({same})")
    return err


def phase_serve_prefix_spec(judge, llm):
    """Full-width qwen2.5-3b (the model ``phase_serve`` loaded) with
    copy-on-write prefix sharing and speculative decoding:

    * sharing: 12 requests behind one 448-token system prompt (two with
      the same whole prompt), at steps 0/8/16, on rows 8, cache 1024, page
      64, with ``share_prefix`` on (the default plan) and off, graphed then
      eager, in turns: equal streams, fewer pages at peak with sharing (by
      at most 7 a co-resident request after the first), copies on write;
    * speculation: ``plan_serve(expected_batch=1)`` with ``SPEC_BUDGET``
      picks k by its ``spec`` rule; prompts ``SPEC_LENS`` with k (graphed,
      eager, graphed) and pinned ``spec_k=0`` (graphed, twice), in turns:
      equal streams or partings at near-ties only, paged attention once
      per global layer per round (the graph's tally too); the acceptance
      rate and decode tokens/s; one more run of each of sharing on and
      speculation in a profiler trace: one device-to-host copy per chunk;
    * resume: ``RESUME_PAGES`` pages under 8 prefixed requests and a guard
      without the int8 rung: preemptions, suffix-only resumes through the
      verifier (the GEMM launching in them), streams equal to a fully
      provisioned run (or parted at near-ties), graphed and eager.

    Returns (the main-path runs' summed launch counts, lines of rates)."""
    import torch
    from repro_torch.core.plan import (num_global_layers, plan_for_scheduler,
                                       plan_serve)
    from repro_torch.kernels import ops
    from repro_torch.serve import LLM
    from repro_torch.serve import scheduler as sched_mod
    from repro_torch.serve.guard import GuardConfig
    cfg = llm.cfg
    n_global = num_global_layers(cfg)
    lines = []
    _verify_check(llm, judge, 8)

    # ---- sharing on and off, graphed and eager, in turns
    _free()
    _reset_peak()
    geometry = dict(rows=8, cache_len=1024, page_size=64, attn_path="paged",
                    kv_quant="fp", sync_every=8)
    plans = {"on": plan_for_scheduler(cfg, **geometry),
             "off": plan_for_scheduler(cfg, share_prefix=False, **geometry)}
    judge.check("sharing: plan_for_scheduler shares prefixes by default",
                plans["on"].share_prefix and not plans["off"].share_prefix,
                f"share_prefix {plans['on'].share_prefix}")
    arrivals = [8 * (i // 4) for i in range(len(SHARED_SUFFIXES))]

    def shared():
        return _prefixed(cfg, SHARED_SUFFIXES, SHARED_NEW, arrivals,
                         twin=True)
    llms = {(mode, graphs): LLM(cfg, llm.params, plans[mode], eos_id=-1,
                                device=DEVICE, decode_graphs=graphs)
            for mode in ("on", "off") for graphs in (True, False)}
    streams, stats, total = {}, {}, None
    for mode, graphs in (("on", True), ("off", True), ("on", False),
                         ("off", False), ("on", True), ("off", True)):
        tag = f"sharing {mode} [{'graphed' if graphs else 'eager'}]"
        done, counts, st, _ = _serve(llms[mode, graphs], shared(), judge,
                                     tag, SHARED_NEW, ())
        streams.setdefault(mode, []).append([r.out for r in done])
        stats[mode] = st
        if mode == "on" and graphs:
            total = counts
    judge.check("sharing: every stream equal, on and off, graphed and eager",
                all(x == streams["off"][0]
                    for v in streams.values() for x in v),
                f"{len(SHARED_SUFFIXES) * SHARED_NEW} tokens, six runs")
    on, off = stats["on"], stats["off"]
    saved = off["pages_peak"]["pages_used"] - on["pages_peak"]["pages_used"]
    pages_prefix = SHARED_PREFIX // 64
    judge.check("sharing: fewer pages in use at peak",
                0 < saved <= pages_prefix * (on["peak_live_rows"] - 1),
                f"peak {on['pages_peak']['pages_used']} pages on, "
                f"{off['pages_peak']['pages_used']} off ({saved} saved, at "
                f"most {pages_prefix} x {on['peak_live_rows'] - 1}); "
                f"shared_tokens_admitted {on['shared_tokens_admitted']}, "
                f"cow_copies {on['cow_copies']}")
    judge.check("sharing: a shared tail page copied on write",
                on["cow_copies"] > 0 and off["cow_copies"] == 0
                and on["shared_tokens_admitted"] > 0,
                f"{on['cow_copies']} copies")
    rate = {m: len(SHARED_SUFFIXES) * SHARED_NEW / max(stats[m]["decode_s"],
                                                       1e-9)
            for m in stats}
    lines.append(
        f"sharing pass: peak {on['pages_peak']['pages_used']} pages with "
        f"sharing, {off['pages_peak']['pages_used']} without; "
        f"shared_tokens_admitted {on['shared_tokens_admitted']}, "
        f"cow_copies {on['cow_copies']}; decode {rate['on']:.1f} tokens/s "
        f"on, {rate['off']:.1f} off (graphed); prefill "
        f"{on['prefill_real_tokens'] / max(on['prefill_s'], 1e-9):.1f} "
        f"tokens/s on, "
        f"{off['prefill_real_tokens'] / max(off['prefill_s'], 1e-9):.1f} "
        f"off; {_memory('peak of the pass')}")
    log(f"  {lines[-1]}")
    run = _guarded_run(llms["on", True], shared(), transfers=True)
    _transfer_check(judge, "sharing on [graphed]", run,
                    run.st["decode_chunks"], "decode chunks (copies on "
                    "write included)")
    del llms

    # ---- speculation at batch 1, from plan_serve's rule
    _free()
    _reset_peak()
    dist = [n + SPEC_NEW for n in SPEC_LENS]
    splan = plan_serve(cfg, hbm_budget_bytes=SPEC_BUDGET, expected_batch=1,
                       expected_len_dist=dist)
    base = plan_serve(cfg, hbm_budget_bytes=SPEC_BUDGET, expected_batch=1,
                      expected_len_dist=dist, spec_k=0)
    dec = {d.name: d for d in splan.decisions}["spec"]
    k = splan.spec_k
    judge.check("spec: plan_serve picks k > 0 by rule at batch 1",
                k > 0 and dec.numbers["rule_choice"] == f"k={k}"
                and base.spec_k == 0,
                f"k {k}, rows {splan.rows}, cache {splan.cache_len}, "
                f"{splan.num_pages} pages; spec decision {dec.choice}: "
                f"{dec.numbers}")
    zero = [0] * len(SPEC_LENS)
    # the sequential plan runs graphed only: its eager step at one row is
    # the slowest run of the script (~28 s), and the graphed step is held
    # to the eager one by every other pass
    sllms = {(mode, graphs): LLM(cfg, llm.params,
                                 splan if mode == "spec" else base,
                                 eos_id=-1, device=DEVICE,
                                 decode_graphs=graphs)
             for mode, graphs in (("spec", True), ("spec", False),
                                  ("base", True))}
    sdone, sst, scounts = {}, {}, {}
    for mode, graphs in (("spec", True), ("base", True), ("spec", False),
                         ("spec", True), ("base", True)):
        tag = f"spec {mode} [{'graphed' if graphs else 'eager'}]"
        done, counts, st, _ = _serve(sllms[mode, graphs],
                                     _requests(cfg, SPEC_LENS, SPEC_NEW,
                                               zero), judge, tag, SPEC_NEW,
                                     ("paged_attention", "bcsc_mlp"))
        sdone[mode, graphs], sst[mode, graphs] = done, st
        scounts[mode, graphs] = counts
    want = {r.rid: r.out for r in sdone["base", True]}
    for graphs in (True, False):
        _equal_or_tie(judge, f"spec [{'graphed' if graphs else 'eager'}] vs "
                      "spec_k=0", llm, sdone["spec", graphs], want)
    judge.check("spec: graphed and eager speculative streams equal",
                [r.out for r in sdone["spec", True]]
                == [r.out for r in sdone["spec", False]],
                f"{len(SPEC_LENS) * SPEC_NEW} tokens")
    st = sst["spec", True]
    graph = sllms["spec", True]._scheduler.graph
    judge.check("spec: paged attention once per global layer per round",
                all(scounts["spec", g]["paged_attention"]
                    == n_global * sst["spec", g]["spec_rounds"]
                    for g in (True, False))
                and st["spec_rounds"] > 0
                and (graph is None
                     or graph.tally.get("paged_attention") == n_global),
                f"{scounts['spec', True]['paged_attention']} = {n_global} x "
                f"{st['spec_rounds']} rounds; the graph's tally "
                f"{graph.tally if graph is not None else 'none (CPU)'}")
    total = {kk: total[kk] + scounts["spec", True][kk] for kk in total}
    acc = st["spec_accepted_tokens"] / max(st["spec_drafted_tokens"], 1)
    srate = {m: len(SPEC_LENS) * SPEC_NEW / max(sst[m]["decode_s"], 1e-9)
             for m in sst}
    lines.append(
        f"spec pass (k {k} from plan_serve, rows 1): acceptance "
        f"{st['spec_accepted_tokens']} / {st['spec_drafted_tokens']} = "
        f"{acc:.3f} (untrained weights repeat tokens: not a property of "
        f"speculation), {st['spec_rounds']} rounds in "
        f"{st['decode_chunks']} chunks; decode {srate['spec', True]:.1f} "
        f"tokens/s graphed with spec, {srate['base', True]:.1f} without; "
        f"eager with spec {srate['spec', False]:.1f}; "
        f"{_memory('peak of the pass')}")
    log(f"  {lines[-1]}")
    run = _guarded_run(sllms["spec", True], _requests(cfg, SPEC_LENS,
                                                      SPEC_NEW, zero),
                       transfers=True)
    _transfer_check(judge, "spec [graphed]", run, run.st["decode_chunks"],
                    "decode chunks (tokens, emit and live flags of k "
                    "candidates in one copy)")
    del sllms

    # ---- preemption and the suffix-only resume on a tight pool
    _free()
    _reset_peak()
    guard = GuardConfig(degrade_rungs=())
    tight = plan_for_scheduler(cfg, num_pages=RESUME_PAGES, **geometry)
    zero = [0] * len(RESUME_SUFFIXES)
    resumes = []
    resume = sched_mod.resume_suffix

    def counted(*a, **kw):
        before = ops.launch_counts()
        resume(*a, **kw)
        after = ops.launch_counts()
        resumes.append({n: after[n] - before[n] for n in after
                        if after[n] != before[n]})
    runs = {}
    sched_mod.resume_suffix = counted
    try:
        for tag, plan, graphs in (("tight [graphed]", tight, True),
                                  ("tight [eager]", tight, False),
                                  ("provisioned", plans["on"], True)):
            target = LLM(cfg, llm.params, plan, eos_id=-1, device=DEVICE,
                         decode_graphs=graphs, guard=guard)
            runs[tag] = _serve(target, _prefixed(cfg, RESUME_SUFFIXES,
                                                 RESUME_NEW, zero), judge,
                               f"resume {tag}", RESUME_NEW, ())
            if tag == "tight [graphed]":
                n_resumes = len(resumes)
    finally:
        sched_mod.resume_suffix = resume
    st = runs["tight [graphed]"][2]
    judge.check("resume: preemptions and suffix-only resumes",
                st["preemptions"] > 0 and st["resume_fast_prompts"] > 0
                and all(r.outcome.ok for r in runs["tight [graphed]"][0]),
                f"preemptions {st['preemptions']}, resume_fast_prompts "
                f"{st['resume_fast_prompts']}, resume_fast_tokens "
                f"{st['resume_fast_tokens']}; {st['outcomes']}")
    judge.check("resume: the GEMM launched in the resumes",
                any(c.get("bcsc_matmul", 0) > 0 for c in resumes)
                and all(c.get("paged_attention", 0) == n_global
                        for c in resumes),
                f"launches per resume {resumes}")
    judge.check("resume: graphed and eager streams equal",
                [r.out for r in runs["tight [graphed]"][0]]
                == [r.out for r in runs["tight [eager]"][0]],
                f"{len(RESUME_SUFFIXES) * RESUME_NEW} tokens")
    _equal_or_tie(judge, "resume vs fully provisioned", llm,
                  runs["tight [graphed]"][0],
                  {r.rid: r.out for r in runs["provisioned"][0]})
    total = {kk: total[kk] + runs["tight [graphed]"][1][kk] for kk in total}
    lines.append(
        f"resume pass ({RESUME_PAGES} pages): preemptions "
        f"{st['preemptions']}, suffix-only resumes "
        f"{st['resume_fast_prompts']} ({st['resume_fast_tokens']} prompt "
        f"tokens not prefilled again; {n_resumes} in the graphed run), wall "
        f"{runs['tight [graphed]'][3]:.2f} s against "
        f"{runs['provisioned'][3]:.2f} s fully provisioned; "
        f"{_memory('peak of the pass')}")
    log(f"  {lines[-1]}")
    return total, lines


def _front_run(llm, judge, tag, requests):
    """One ``stream`` of the front-door LLM (its default ``eos_id``), the
    launch counts zeroed just before and read just after: every outcome
    ok, every request at most ``FRONT_NEW`` in-vocab tokens, ending at its
    budget or at the end-of-sequence token. Returns (finished requests,
    launch counts, phase stats)."""
    from repro_torch.kernels import ops
    vocab = llm.cfg.vocab_size
    sync()
    ops.reset_launches()
    done = llm.stream(requests)
    sync()
    counts = ops.launch_counts()
    ok = len(done) == len(requests) and all(
        r.outcome.ok and 0 < len(r.out) <= FRONT_NEW
        and all(0 <= t < vocab for t in r.out)
        and (len(r.out) == FRONT_NEW or r.out[-1] == llm.eos_id)
        for r in done)
    judge.check(f"{tag}: outcomes and tokens", ok,
                f"{len(done)} requests ok, {sum(len(r.out) for r in done)} "
                f"in-vocab tokens (eos {llm.eos_id})")
    return done, counts, llm.phase_stats


def _sparse_entry_points(llm, judge):
    """``ops.bcsc_matmul`` and ``ops.bcsc_gemv`` (the general sparse
    library, the reference's ``kernels/ops.py`` surface) at the model's up
    projection (d_model -> d_ff, 0.75 block sparsity): M ``SPARSE_ROWS``
    without and with bias + silu, a forced GEMM tile at M 5, and
    ``bcsc_gemv`` at M 8. Each is held against its plain version and
    against ``torch.matmul`` of x and the decoded dense bf16 weight in fp32
    (plus bias and silu), and takes the GEMV kernel at M <= 8, the GEMM
    above and at a forced tile. Returns the summed launch counts."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import sparsity as sp
    from repro_torch.kernels import ops
    cfg, dev = llm.cfg, llm.device
    d, ff = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    w = torch.randn(d, ff, generator=gen, device=dev) / d ** 0.5
    w = sp.block_magnitude_prune(w, 0.75, 16, 16).bfloat16()
    m = sp.bcsc_encode(w, 16, 16)
    wdense = w.float()                  # the decoded bf16 weight's values
    bias = torch.randn(ff, generator=gen, device=dev)
    total = {k: 0 for k in ops.launch_counts()}
    cases = [(M, act, 0) for M in SPARSE_ROWS for act in (None, "silu")]
    cases += [(5, "silu", 16), (8, "silu", -1)]      # -1: bcsc_gemv
    for M, act, bm in cases:
        x = torch.randn(M, d, generator=gen, device=dev).bfloat16()
        kw = dict(bias=bias, activation="silu") if act else {}
        entry = (lambda **k: ops.bcsc_gemv(x, m, **k)) if bm < 0 else \
            (lambda **k: ops.bcsc_matmul(x, m, bm=bm, **k))
        sync()
        ops.reset_launches()
        got = entry(**kw)
        sync()
        counts = ops.launch_counts()
        total = {k: total[k] + counts[k] for k in total}
        plain = entry(impl="plain", **kw)
        dense = torch.matmul(x.float(), wdense)
        if act:
            dense = F.silu(dense + bias)
        gemv = M <= 8 and bm <= 0
        arm = "bcsc_gemv" if gemv else "bcsc_matmul"
        name = (f"ops.{'bcsc_gemv' if bm < 0 else 'bcsc_matmul'}[M={M}"
                f"{', bm=%d' % bm if bm > 0 else ''}, "
                f"{'bias + silu' if act else 'bare'}]")
        tol = 1e-4 if gemv else 1e-3
        why = ("relative to max |out|: fp32 sums of the same bf16 products "
               "in another order" + ("" if gemv else ", a K split among "
                                     "them"))
        judge(f"{name} vs plain", errors(got, plain)[1], tol, why)
        judge(f"{name} vs torch.matmul (dense bf16 weight)",
              errors(got, dense)[1], tol, why)
        judge.check(f"{name}: the {arm} kernel launched",
                    counts[arm] == 1 and sum(counts.values()) == 1,
                    f"launches {counts}")
    return total


def phase_front_door(judge, llm, records):
    """The plan-less front door on full-width qwen2.5-3b (the weights
    ``phase_serve`` loaded): ``LLM(cfg, params)`` with no other argument
    resolves ``plan_serve`` over half the H100's memory (40e9 B) for 8 rows
    of up to 512 tokens; its ``explain()`` is printed in full. Eight
    requests (``FRONT_LENS``, ``FRONT_NEW`` new tokens) stream through it
    graphed (the first run captures the step), eager
    (``decode_graphs=False``) and graphed again (the main path's run), under
    the defaults (the guard, the tracer, eos 1): every outcome ok, equal
    streams, paged attention, the fused MLP and the sliding window
    launched. Then Eyexam's per-layer fused-MLP prediction at H100 rates
    beside the kernel phase's measured time, and the general sparse entry
    points (``_sparse_entry_points``). Returns (launch counts, lines)."""
    import torch
    from repro_torch.core import eyexam
    from repro_torch.core.plan import num_global_layers, plan_serve
    from repro_torch.serve import LLM
    cfg = llm.cfg
    on = {} if DEVICE == "cuda" else {"device": DEVICE}
    _free()
    _reset_peak()
    front = LLM(cfg, llm.params, **on)
    want = plan_serve(cfg, hbm_budget_bytes=40_000_000_000, expected_batch=8,
                      expected_len_dist={"mean": 256, "max": 512})
    plan = front.plan
    judge.check("front door: LLM(cfg, params) resolves the default plan",
                plan == want and plan.paged and plan.rows == 8
                and plan.cache_len == 512,
                f"plan_serve(40e9 B, batch 8, mean 256, max 512): rows "
                f"{plan.rows}, cache {plan.cache_len}, {plan.attn_path}, "
                f"{plan.num_pages} pages, spec_k {plan.spec_k}")
    for line in front.explain().splitlines():
        log(f"  | {line}")

    def requests():
        return _requests(cfg, FRONT_LENS, FRONT_NEW,
                         [4 * (i // 4) for i in range(len(FRONT_LENS))])
    eager = LLM(cfg, llm.params, decode_graphs=False, **on)
    runs = {}
    for tag, target in (("graphed, capturing", front), ("eager", eager),
                        ("graphed", front)):
        runs[tag] = _front_run(target, judge, f"front door [{tag}]",
                               requests())
    streams = [[r.out for r in done] for done, _, _ in runs.values()]
    judge.check("front door: graphed and eager streams equal",
                streams[0] == streams[1] == streams[2],
                f"{sum(len(o) for o in streams[1])} tokens, three runs")
    _, counts, st = runs["graphed"]
    judge.check("front door: graphed launches equal the eager run's",
                counts == runs["eager"][1],
                f"{counts} vs {runs['eager'][1]}")
    for name in ("paged_attention", "bcsc_mlp", "sliding_window_attention"):
        judge.check(f"front door: {name} launched", counts[name] > 0,
                    f"{counts[name]} launches")
    _per_step_checks(judge, "front door", counts, cfg.num_layers,
                     num_global_layers(cfg), st["decode_steps"])
    rate = {}
    for tag in ("eager", "graphed"):
        done, _, s = runs[tag]
        rate[tag] = (sum(len(r.out) for r in done) / max(s["decode_s"], 1e-9),
                     s["prefill_real_tokens"] / max(s["prefill_s"], 1e-9))
    lines = [f"front door (LLM(cfg, params): rows {plan.rows}, cache "
             f"{plan.cache_len}, {plan.num_pages} pages): decode "
             f"{rate['graphed'][0]:.1f} tokens/s graphed, "
             f"{rate['eager'][0]:.1f} eager; prefill "
             f"{rate['graphed'][1]:.1f} tokens/s graphed run, "
             f"{rate['eager'][1]:.1f} eager run; "
             f"{_memory('peak of the pass')}"]
    log(f"  {lines[-1]}")
    del eager

    mlp = {d.name: d for d in plan.decisions}["mlp"].numbers
    t = mlp["per_layer_time_s"]
    rec = records.get("bcsc_mlp")
    measured = (f"{rec['ms']:.4f} ms measured by the kernel phase at the "
                "same M and widths" if rec else "not measured")
    total_mem = (f"{torch.cuda.get_device_properties(0).total_memory} B"
                 if DEVICE == "cuda" else "not measured")
    lines.append(
        f"Eyexam at {eyexam.H100_SXM.name} rates: fused sparse MLP per layer "
        f"at M {plan.bcsc_bm(plan.rows)} predicted "
        f"{1e3 * t['fused_sparse']:.4f} ms "
        f"({mlp['per_layer_bytes']['weights_sparse_real']:.0f} weight bytes "
        f"/ {eyexam.H100_SXM.hbm_bw:.3g} B/s + one launch of "
        f"{eyexam.H100_SXM.launch_s:g} s), {measured}; dense "
        f"{1e3 * t['dense']:.4f} ms, two-call {1e3 * t['two_call_sparse']:.4f}"
        f" ms predicted; device memory {total_mem} against "
        f"H100_SXM.hbm_cap {eyexam.H100_SXM.hbm_cap:.0f} B")
    log(f"  {lines[-1]}")

    sparse = _sparse_entry_points(llm, judge)
    total = {k: counts[k] + sparse[k] for k in counts}
    del front
    return total, lines


def _fleet_requests(cfg):
    """``FLEET_LENS`` prompts (seeded), request i arriving at step i, in
    two tenants; the second six begin with the first page of the first
    six's prompts where both are at least a page long."""
    import torch
    from repro_torch.serve import StreamRequest
    gen = torch.Generator().manual_seed(SEED + 3)
    page = FLEET_PLAN["page_size"]
    half = len(FLEET_LENS) // 2
    prompts = []
    for i, n in enumerate(FLEET_LENS):
        head = []
        if i >= half and n >= page and len(prompts[i - half]) >= page:
            head = prompts[i - half][:page]
        prompts.append(head + torch.randint(0, cfg.vocab_size,
                                            (n - len(head),),
                                            generator=gen).tolist())
    return [StreamRequest(i, p, FLEET_NEW, arrival=float(i),
                          tenant=f"t{i % 2}") for i, p in enumerate(prompts)]


def _fleet_run(fleet, chaos=None, transfers=False, audit_memory=False):
    """One ``stream`` of a fleet ``LLM``, the launch counts zeroed just
    before and read just after; with ``audit_memory`` the device memory
    allocated at each window's supervision and before the run ("start"),
    and each live replica's own device bytes then (``memory`` and
    ``resident``: clock -> bytes, clock -> {slot: bytes}). Returns a
    namespace: ``done`` (by rid), ``counts``, ``st`` (the fleet's phase
    stats), ``reps`` (its replicas), ``wall``, ``dtoh`` and ``sites``
    (``_device_transfers``), ``memory``, ``resident``."""
    import types
    import torch
    from repro_torch.kernels import ops
    memory, resident = {}, {}
    if audit_memory:
        sup = fleet._fleet.supervisor
        audit = sup.audit

        def measured(replicas, clock, sync_every):
            sync()
            memory[clock] = torch.cuda.memory_allocated() \
                if DEVICE == "cuda" else 0
            resident[clock] = {rep.slot: rep.scheduler._loop.device_bytes()
                               for rep in replicas}
            return audit(replicas, clock, sync_every)
        sup.audit = measured
        sync()
        memory["start"] = torch.cuda.memory_allocated() \
            if DEVICE == "cuda" else 0
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        if transfers:
            done, dtoh, sites = _device_transfers(
                lambda: fleet.stream(_fleet_requests(fleet.cfg), chaos=chaos))
        else:
            done = fleet.stream(_fleet_requests(fleet.cfg), chaos=chaos)
            dtoh, sites = None, {}
    finally:
        if audit_memory:
            del sup.audit                 # the instance's own again
    sync()
    wall = time.perf_counter() - t0
    return types.SimpleNamespace(
        done={r.rid: r for r in done}, counts=ops.launch_counts(),
        st=fleet.phase_stats, reps=list(fleet._fleet._all), wall=wall,
        dtoh=dtoh, sites=sites, memory=memory, resident=resident)


def _decode_rate(done, decode_s):
    return sum(len(r.out) for r in done) / max(decode_s, 1e-9)


def phase_fleet(judge, llm):
    """The multi-replica fleet on full-width qwen2.5-3b (the weights
    ``phase_serve`` loaded): ``LLM(cfg, params, plan,
    replicas=FLEET_REPLICAS)`` over ``plan_for_scheduler(rows 4, cache 1024,
    page 64)`` per replica, 12 requests (``_fleet_requests``), greedy,
    ``eos_id=-1``. Runs: (a) the same requests through a one-replica
    ``LLM`` on the same plan; (b) the fault-free fleet, graphed (then once
    more under ``_device_transfers``); (c) the fleet eager
    (``decode_graphs=False``); (d) replica 0 killed at ``FLEET_KILL``; (e)
    replica 1 stalled at ``FLEET_STALL``. Checks: one terminal outcome per
    rid in (b), (d) and (e); one failover in (d) and in (e), the stall
    caught by the heartbeat; (b) == (c); the requests of (d) that never
    lived on replica 0 equal (b), migrated ones equal or part at a near-tie;
    (b) against (a) by the near-tie rule; the card's device-to-host copies
    over (b) equal the replicas' decode chunks; one capture per replica;
    after the kill the allocated memory falls by one replica's footprint
    (pool, decode state, step graph); the replicas share ``llm``'s weights.
    Prints per-replica pool bytes and capture seconds, the memory the fleet
    adds, the router's affinity hits and the fleet's decode rate against
    (a)'s. Returns ((b)'s launch counts, lines)."""
    import torch
    from repro_torch.core.plan import num_global_layers, plan_for_scheduler
    from repro_torch.serve import LLM, kvcache
    from repro_torch.serve.chaos import ReplicaChaosConfig
    from repro_torch.serve.graphs import WARMUP_STEPS
    from repro_torch.serve.replica import DEAD, RETIRED
    cfg = llm.cfg
    n_global = num_global_layers(cfg)
    _free()
    _reset_peak()
    plan = plan_for_scheduler(cfg, attn_path="paged", kv_quant="fp",
                              sync_every=8, **FLEET_PLAN)
    pool = kvcache.paged_cache_bytes(cfg, plan.rows, plan.cache_len,
                                     plan.num_pages, plan.page_size)
    n = len(FLEET_LENS)

    # (a) one replica on the same plan
    single = LLM(cfg, llm.params, plan, eos_id=-1, device=DEVICE)
    sync()
    t0 = time.perf_counter()
    done_a = {r.rid: r for r in single.stream(_fleet_requests(cfg))}
    sync()
    wall_a = time.perf_counter() - t0
    st_a = single.phase_stats
    rate_a = _decode_rate(done_a.values(), st_a["decode_s"])
    del single

    # (b) the fault-free fleet, graphed; it shares llm's weights
    before = torch.cuda.memory_allocated() if DEVICE == "cuda" else 0
    fleet = LLM(cfg, llm.params, plan, eos_id=-1, device=DEVICE,
                replicas=FLEET_REPLICAS)
    built = (torch.cuda.memory_allocated() if DEVICE == "cuda" else 0) \
        - before
    shared = all(a.data_ptr() == b.data_ptr() for a, b in zip(
        _leaves(fleet.params), _leaves(llm.params)))
    judge.check("fleet: the replicas share the one copy of the weights",
                shared and built < 1 << 20,
                f"every tensor of the fleet's params is llm's; the fleet LLM "
                f"allocated {built} B when built")
    b = _fleet_run(fleet, audit_memory=True)
    st = b.st

    def terminal(tag, run):
        judge.check(f"fleet {tag}: every rid in exactly one terminal outcome",
                    sorted(run.done) == list(range(n)) and all(
                        r.outcome is not None for r in run.done.values()),
                    f"{run.st['outcomes']} over {n} requests")
    terminal("(b)", b)
    judge.check("fleet (b): every request ok with its budget of tokens",
                all(r.outcome.ok and len(r.out) == FLEET_NEW
                    and all(0 <= t < cfg.vocab_size for t in r.out)
                    for r in b.done.values()),
                f"{sum(len(r.out) for r in b.done.values())} tokens")
    caps = [rep.scheduler._loop.captures for rep in b.reps]
    judge.check("fleet (b): one capture per replica's scheduler",
                DEVICE != "cuda" or all(len(c) == 1 for c in caps),
                f"captures {[[round(x, 3) for x in c] for c in caps]} s")
    judge.check("fleet (b): every replica released at its retirement",
                all(rep.state == RETIRED and rep.scheduler._loop.state is None
                    and rep.scheduler._loop.graph is None for rep in b.reps),
                f"{len(b.reps)} replicas retired")
    counts = b.counts
    steps = st["fleet"]["decode_steps"]
    warm = WARMUP_STEPS * sum(len(c) for c in caps)
    for name in ("sliding_window_attention", "paged_attention", "bcsc_mlp"):
        judge.check(f"fleet (b): {name} launched", counts[name] > 0,
                    f"{counts[name]} launches")
    judge.check("fleet (b): paged-attention launches per decode step",
                counts["paged_attention"] == n_global * (steps + warm),
                f"{counts['paged_attention']} = {n_global} x ({steps} "
                f"decode steps over the replicas + {warm} capture warm-up "
                "steps)")
    decode_b = sum(rep.scheduler.phase_stats["decode_s"] for rep in b.reps)
    rate_b = _decode_rate(b.done.values(), decode_b)
    want = {rid: r.out for rid, r in b.done.items()}
    _equal_or_tie(judge, "fleet (b) vs one replica (a)", llm,
                  list(done_a.values()), want)

    # (b) again, the card's device-to-host copies counted
    bt = _fleet_run(fleet, transfers=True)
    syncs = sum(rep.scheduler.host_syncs for rep in bt.reps)
    judge.check("fleet (b): the same streams under the profiler",
                {rid: r.out for rid, r in bt.done.items()} == want,
                f"{n} requests")
    if bt.dtoh is None:
        judge.check("fleet (b): device-to-host copies", True,
                    "not measured (CPU)")
    else:
        judge.check("fleet (b): device-to-host copies the card ran == the "
                    "replicas' decode chunks",
                    bt.dtoh == bt.st["fleet"]["decode_chunks"] == syncs,
                    f"{bt.dtoh} copies in the profiler trace, "
                    f"{bt.st['fleet']['decode_chunks']} chunks over "
                    f"{len(bt.reps)} replicas, host_syncs {syncs}; "
                    f"host-blocking calls by site: {_sites(bt.sites)}")

    # (c) the same fleet eager
    eager = LLM(cfg, llm.params, plan, eos_id=-1, device=DEVICE,
                replicas=FLEET_REPLICAS, decode_graphs=False)
    c = _fleet_run(eager)
    judge.check("fleet (c): eager streams, outcomes and placements equal "
                "(b)'s",
                [(r.out, r.outcome.status, r.replica, r.migrations)
                 for _, r in sorted(c.done.items())]
                == [(r.out, r.outcome.status, r.replica, r.migrations)
                    for _, r in sorted(b.done.items())],
                f"{sum(len(r.out) for r in c.done.values())} tokens")
    judge.check("fleet (c): paged-attention launches per decode step",
                c.counts["paged_attention"]
                == n_global * c.st["fleet"]["decode_steps"],
                f"{c.counts['paged_attention']} = {n_global} x "
                f"{c.st['fleet']['decode_steps']} steps")
    del eager

    # (d) replica 0 killed: survivors equal (b), migrated ones by the rule
    d = _fleet_run(fleet, chaos=ReplicaChaosConfig(
        kill_at_step={0: FLEET_KILL}), audit_memory=True)
    terminal("(d)", d)
    judge.check("fleet (d): one failover, every outcome ok",
                d.st["failovers"] == 1 and d.st["outcomes"]["ok"] == n,
                f"failovers {d.st['failovers']} "
                f"({d.st['failover_reasons']}), migrated "
                f"{d.st['migrated_requests']}")
    stay = [r for r in d.done.values() if not r.migrations]
    moved = [r for r in d.done.values() if r.migrations]
    judge.check("fleet (d): requests that never lived on replica 0 equal "
                "(b)", stay and all(r.out == want[r.rid] for r in stay),
                f"{len(stay)} requests")
    parts = _partings(llm, moved, want)
    judge.check("fleet (d): migrated requests equal (b), or part at a "
                "near-tie", moved and all(m < NEAR_TIE for _, _, m in parts),
                f"{len(moved)} migrated, {len(parts)} parted (rid, token, "
                f"top-2 margin / max |logit|): {parts or 'none'}")
    dead = [rep for rep in d.reps if rep.state == DEAD]
    mem = d.memory
    before_kill = FLEET_KILL - plan.sync_every
    own = d.resident[before_kill][0]       # replica 0's tensors
    foot = (mem[0.0] - mem["start"]) / FLEET_REPLICAS
    drop = mem[before_kill] - mem[FLEET_KILL]
    judge.check("fleet (d): the dead replica's memory released",
                len(dead) == 1 and dead[0].scheduler._loop.device_bytes()
                == 0 and own >= pool and (DEVICE != "cuda"
                                          or drop >= 0.99 * own),
                f"allocated {mem[before_kill] / 2**20:.1f} MiB at the window "
                f"before the kill (step {before_kill:g}), "
                f"{mem[FLEET_KILL] / 2**20:.1f} MiB at the kill's: "
                f"{drop / 2**20:.1f} MiB released against replica 0's own "
                f"{own / 2**20:.1f} MiB (pool {pool / 2**20:.1f} MiB; its "
                "graph's intermediates sit in the graph's private pool, "
                "reserved, not allocated)" if DEVICE == "cuda" else
                "not measured (CPU): its decode state and pools dropped")

    # (e) replica 1 stalled: the heartbeat catches it
    e = _fleet_run(fleet, chaos=ReplicaChaosConfig(
        stall_at_step={1: FLEET_STALL}))
    terminal("(e)", e)
    judge.check("fleet (e): the stall failed over by the heartbeat",
                e.st["failovers"] == 1 and all(
                    k.startswith("heartbeat stalled")
                    for k in e.st["failover_reasons"]),
                f"{e.st['failover_reasons']}, clock {e.st['clock_steps']:g} "
                f"steps against {st['clock_steps']:g} fault-free")
    parts_e = _partings(llm, [r for r in e.done.values() if r.outcome.ok],
                        want)
    judge.check("fleet (e): streams equal (b), or part at a near-tie",
                e.st["outcomes"]["ok"] == n
                and all(m < NEAR_TIE for _, _, m in parts_e),
                f"{len(parts_e)} parted: {parts_e or 'none'}")

    cap_s = [round(c_[0], 3) for c_ in caps if c_]
    lines = [
        f"fleet ({FLEET_REPLICAS} replicas of rows {plan.rows}, cache "
        f"{plan.cache_len}, {plan.num_pages} pages of {plan.page_size}): "
        f"decode {rate_b:.1f} tokens/s over the replicas' summed decode "
        f"time, {sum(len(r.out) for r in b.done.values()) / b.wall:.1f} "
        f"over the run's wall ({b.wall:.2f} s, captures included); one "
        f"replica (a) {rate_a:.1f} and "
        f"{sum(len(r.out) for r in done_a.values()) / wall_a:.1f} "
        f"({wall_a:.2f} s); per replica: pool {pool / 2**20:.1f} MiB, "
        f"capture {cap_s} s"
        + (f", own tensors {own / 2**20:.1f} MiB, allocated at spawn "
           f"{foot / 2**20:.1f} MiB (the rest is cuBLAS's workspace for the "
           f"capture stream, which PyTorch keeps per stream of its pool); "
           f"the fleet adds {(mem[0.0] - mem['start']) / 2**20:.1f} MiB "
           "over llm at spawn" if DEVICE == "cuda" else "")
        + f"; run walls (a) {wall_a:.2f}, (b) {b.wall:.2f}, profiled "
        f"{bt.wall:.2f}, (c) {c.wall:.2f}, (d) {d.wall:.2f}, (e) "
        f"{e.wall:.2f} s"
        + f"; router {st['router']}; clock {st['clock_steps']:g} steps, "
        f"{st['rounds']} windows; (d) {d.st['migrated_requests']} migrated, "
        f"{len(parts)} parted, (e) detected after "
        f"{e.st['clock_steps'] - st['clock_steps']:g} more steps; "
        f"{_memory('peak of the pass')}"]
    log(f"  {lines[-1]}")
    del fleet
    return counts, lines


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _stream_pass(llm, judge, tag, lens, max_new, arrivals):
    """An ``LLM.stream`` pass through ``_turns`` that must launch all four
    kernels of the path; then, on its main-path run, the sliding window
    once per layer per prefill batch, paged attention once per global
    layer per decode step and the fused MLP at least once per layer per
    step. Returns what ``_turns`` returns."""
    from repro_torch.core.plan import num_global_layers
    cfg = llm.cfg
    counts, st, wall, line = _turns(
        llm, lambda: _requests(cfg, lens, max_new, arrivals), judge, tag,
        max_new, ("sliding_window_attention", "paged_attention", "bcsc_mlp",
                  "bcsc_matmul"))
    layers = cfg.num_layers
    judge.check(f"{tag}: sliding-window launches per prefill batch",
                counts["sliding_window_attention"]
                == layers * st["prefill_batches"],
                f"{counts['sliding_window_attention']} = {layers} x "
                f"{st['prefill_batches']} batches")
    _per_step_checks(judge, tag, counts, layers, num_global_layers(cfg),
                     st["decode_steps"])
    return counts, st, wall, line


def phase_serve_gemma(judge):
    """Full-width, full-depth gemma2-2b through ``LLM.stream``: long prompts
    (window-mode prefill in the local layers), decode past the window (the
    local rings wrap), graphed and eager in turns. Returns (the graphed
    run's launch counts, lines of rates)."""
    llm = _load(GEMMA, GEMMA_PLAN)
    cfg, plan = llm.cfg, llm.plan
    _check_logits(llm, judge, GEMMA_CHECK, plan.tier(max(GEMMA_CHECK)))
    _layer_errors(llm, judge, GEMMA_CHECK, plan.tier(max(GEMMA_CHECK)))
    counts, st, wall, line = _stream_pass(llm, judge, "gemma2 pass",
                                          GEMMA_LENS, GEMMA_NEW,
                                          [0, 0, 0, 8, 8, 8])
    generated = len(GEMMA_LENS) * GEMMA_NEW
    rates = (f"gemma2-2b: prefill "
             f"{st['prefill_real_tokens'] / max(st['prefill_s'], 1e-9):.1f} "
             f"tokens/s ({st['prefill_real_tokens']} tokens, "
             f"{st['prefill_s']:.2f} s), decode "
             f"{generated / max(st['decode_s'], 1e-9):.1f} tokens/s "
             f"({generated} tokens, {st['decode_s']:.2f} s), wall "
             f"{wall:.2f} s (the graphed run)")
    counts_s, sharded = _sharded_pass(llm, judge, "gemma2 tp=2 pass", "tp=2",
                                      SHARDED_GEMMA_LENS, SHARDED_NEW)
    return {k: counts[k] + counts_s[k] for k in counts}, \
        [line, rates, sharded]


def phase_serve_nemo(judge):
    """Full-width, full-depth mistral-nemo-12b (40 global layers, d_model
    5120 against 32 heads of 128, an untied 131k head): through
    ``LLM.stream`` 12 requests of up to 3500 prompt tokens on paged fp KV,
    then through ``LLM.generate`` 8 requests on ``plan_for_engine(slots=8,
    cache_len=4096)``'s contiguous cache; each pass graphed and eager in
    turns. Returns (the graphed runs' summed launch counts, lines of
    rates)."""
    from repro_torch.core.plan import plan_for_engine
    from repro_torch.serve import LLM
    llm = _load(NEMO, NEMO_PLAN)
    cfg, plan = llm.cfg, llm.plan
    _check_logits(llm, judge, NEMO_CHECK, plan.tier(max(NEMO_CHECK)))
    _layer_errors(llm, judge, NEMO_CHECK, plan.tier(max(NEMO_CHECK)))
    counts, _, _, line = _stream_pass(
        llm, judge, "mistral-nemo fp pass", NEMO_LENS, NEMO_NEW,
        [8 * (i // 4) for i in range(len(NEMO_LENS))])
    lines = [line]
    llm_g = LLM(cfg, llm.params,
                plan_for_engine(cfg, slots=NEMO_PLAN["rows"],
                                cache_len=NEMO_PLAN["cache_len"]),
                eos_id=-1, device=DEVICE)
    counts_g, st_g, _, line = _turns(
        llm_g, lambda: _requests(cfg, NEMO_GENERATE_LENS, NEMO_GENERATE_NEW,
                                 [0] * len(NEMO_GENERATE_LENS)),
        judge, "mistral-nemo generate pass", NEMO_GENERATE_NEW,
        ("sliding_window_attention", "bcsc_mlp", "bcsc_matmul"),
        entry="generate")
    eng = llm_g._engine
    judge.check("mistral-nemo generate pass: one host transfer per decode "
                "chunk", eng.host_syncs == 2 * st_g["decode_chunks"],
                f"{eng.host_syncs} transfers over its two runs of "
                f"{st_g['decode_chunks']} chunks")
    steps = _decode_steps(llm_g, st_g)
    judge.check("mistral-nemo generate pass: fused-MLP launches per decode "
                "step", counts_g["bcsc_mlp"] >= cfg.num_layers * steps,
                f"{counts_g['bcsc_mlp']} >= {cfg.num_layers} x {steps} steps")
    lines.append(line + f"; host_syncs {st_g['decode_chunks']} a run")
    return {k: counts[k] + counts_g[k] for k in counts}, lines


def phase_serve_gemma3(judge):
    """Full-width, full-depth gemma3-12b (48 layers, five local of window
    1024 to one global, qk-norm, RoPE theta 10 000 local and 1 000 000
    global, d_model 3840 against 16 heads of 256, a tied 262k head) through
    ``LLM.stream``: 6 requests of up to 7000 prompt tokens on paged fp KV
    (window-mode prefill in the local layers; every ring longer than 1024
    wraps in decode), then 4 on int8 KV pages on the default MLP route;
    each pass graphed and eager in turns. Returns (the graphed runs' summed
    launch counts, lines of rates)."""
    from repro_torch.core.plan import plan_for_scheduler
    from repro_torch.serve import LLM
    llm = _load(GEMMA3, GEMMA3_PLAN)
    cfg, plan = llm.cfg, llm.plan
    _check_logits(llm, judge, GEMMA3_CHECK, plan.tier(max(GEMMA3_CHECK)))
    _layer_errors(llm, judge, GEMMA3_CHECK, plan.tier(max(GEMMA3_CHECK)))
    counts, _, _, line = _stream_pass(llm, judge, "gemma3 fp pass",
                                      GEMMA3_LENS, GEMMA3_NEW,
                                      [0, 0, 0, 8, 8, 8])
    lines = [line]
    plan8 = plan_for_scheduler(cfg, attn_path="paged", kv_quant="int8",
                               sync_every=8, **GEMMA3_PLAN)
    llm8 = LLM(cfg, llm.params, plan8, eos_id=-1, device=DEVICE)
    counts8, _, _, line = _stream_pass(llm8, judge, "gemma3 int8 pass",
                                       GEMMA3_INT8_LENS, GEMMA3_INT8_NEW,
                                       [0] * len(GEMMA3_INT8_LENS))
    lines.append(line + f"; fused MLP up to M {plan8.mlp_fused_m_max}")
    return {k: counts[k] + counts8[k] for k in counts}, lines


def _check_logits_exact(llm, judge, length: int, rows: int = 2):
    """``_check_logits`` for a config with recurrent state, which prefills
    exact lengths only: ``rows`` prompts of one ``length`` on the plan's
    contiguous cache, their prefill (the GEMM arm past the fused route,
    prefill attention) and one decode step (M ``rows``: the fused MLP, the
    local rings, the recurrent state) through the kernels and through
    ``impl="plain"``."""
    _check_logits_contiguous(llm, judge, [length] * rows, length)


def _check_logits_contiguous(llm, judge, lengths, tier: int):
    """``_check_logits`` on the plan's contiguous cache: prompts of
    ``lengths`` padded to ``tier``, their prefill and one decode step
    through the kernels and through ``impl="plain"``. Returns the two
    gaps."""
    import torch
    from repro_torch.models import decoding
    cfg, plan, dev = llm.cfg, llm.plan, llm.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = len(lengths)
    toks = torch.randint(0, cfg.vocab_size, (rows, tier), generator=gen,
                         device=dev)
    lengths = list(lengths)
    out, nxt = {}, None
    for impl in (None, "plain"):
        logits, cache = decoding.prefill_batched(
            llm.params, toks, lengths, cfg, plan.cache_len, plan=plan,
            impl=impl)
        if nxt is None:
            nxt = logits[:, -1].argmax(-1)[:, None]
        step, _ = decoding.serve_step(
            llm.params, cache, nxt,
            torch.tensor(lengths, dtype=torch.long, device=dev), cfg,
            plan=plan, impl=impl)
        out[impl] = (logits[..., :cfg.vocab_size], step[..., :cfg.vocab_size])
        del cache
    sync()
    gaps = []
    for i, what in enumerate(("prefill", "decode")):
        got, want = out[None][i], out["plain"][i]
        judge.check(f"{cfg.name} {what} logits finite",
                    bool(torch.isfinite(got).all()), f"{tuple(got.shape)}")
        gaps.append(errors(got, want)[1])
        judge(f"{cfg.name} {what} logits, kernels vs plain", gaps[-1], 5e-2,
              f"relative to max |logit| after {cfg.num_layers} layers at "
              f"prompts of {lengths} tokens (tier {tier}): sums in another "
              "order flip bf16 roundings, which the layers carry forward")
    return gaps


def _exact_batches(lens, rows: int):
    """The prefill batches' M of a pass whose requests arrive in waves of
    ``rows`` (each wave admitted when the previous one finishes, as equal
    budgets make them do), bucketed by exact length within a wave."""
    out = []
    for i in range(0, len(lens), rows):
        wave = lens[i:i + rows]
        out += [wave.count(n) * n for n in sorted(set(wave))]
    return out


def _prefill_ms(llm, lengths):
    """(ms, peak GiB) of one single-prompt prefill at each length: host
    clock around a call synchronised on both sides, the second of two (the
    first pays each new shape's library set-up), and the peak of device
    memory over it (None on the CPU)."""
    import torch
    from repro_torch.models import decoding
    cfg, plan, dev = llm.cfg, llm.plan, llm.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    out = {}
    for n in lengths:
        toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                             device=dev)
        for _ in range(2):
            sync()
            _reset_peak()
            t0 = time.perf_counter()
            decoding.prefill_batched(llm.params, toks, [n], cfg,
                                     plan.cache_len, plan=plan)
            sync()
            out[n] = ((time.perf_counter() - t0) * 1e3,
                      torch.cuda.max_memory_allocated() / 2**30
                      if DEVICE == "cuda" else None)
    return out


def phase_serve_recurrent(judge):
    """Full-width, full-depth recurrentgemma-2b (26 layers: 8 periods of
    two RG-LRU layers and one local of window 2048, then 2 RG-LRU; MQA 10
    heads of 256, d_ff 7680) and mamba2-130m (24 Mamba-2 SSD layers, no
    MLP), each after the previous model was freed, on the plans' contiguous
    caches (no global layer, so no page pool) with exact-length prefill
    buckets. recurrentgemma-2b: the logits check, ``LLM.stream`` (prefill
    past the window, decode wrapping the rings) and ``LLM.generate`` on
    ``plan_for_engine``, each graphed and eager in turns: the sliding
    window once per local layer per prefill batch, the fused MLP at least
    once per layer per decode step, the GEMM on the batches past the fused
    route, paged attention never. mamba2-130m: ``LLM.stream`` in turns with
    no port kernel launched, and the prefill ms of each prompt length.
    Returns (the graphed runs' summed launch counts, lines of rates)."""
    from repro_torch.core.plan import plan_for_engine
    from repro_torch.models.ssm import chunk_size
    from repro_torch.serve import LLM
    llm = _load(RGEMMA, RGEMMA_PLAN)
    cfg, plan = llm.cfg, llm.plan
    judge.check(f"{RGEMMA}: contiguous plan, exact-length prefill",
                not plan.paged and plan.prefill_exact and not plan.degrade,
                f"attn_path {plan.attn_path}, prefill_exact "
                f"{plan.prefill_exact}, degrade {plan.degrade}")
    _check_logits_exact(llm, judge, RGEMMA_CHECK)
    n_local = sum(cfg.layer_kind(i) == "local"
                  for i in range(cfg.num_layers))
    fused = plan.mlp_fused_m_max

    def gemm_batches(ms):
        return sum(fused is not None and m > fused for m in ms)

    lines = []
    passes = (
        ("recurrentgemma stream pass", llm, RGEMMA_LENS,
         [0] * 4 + [8] * 4, "stream",
         _exact_batches(RGEMMA_LENS, plan.rows)),
        ("recurrentgemma generate pass",
         LLM(cfg, llm.params, plan_for_engine(
             cfg, slots=RGEMMA_PLAN["rows"],
             cache_len=RGEMMA_PLAN["cache_len"]), eos_id=-1, device=DEVICE),
         RGEMMA_GENERATE_LENS, [0] * len(RGEMMA_GENERATE_LENS), "generate",
         _exact_batches(RGEMMA_GENERATE_LENS, len(RGEMMA_GENERATE_LENS))))
    total = None
    for tag, model, lens, arrivals, entry, ms in passes:
        counts, st, _, line = _turns(
            model, lambda: _requests(cfg, lens, RGEMMA_NEW, arrivals), judge,
            tag, RGEMMA_NEW,
            ("sliding_window_attention", "bcsc_mlp", "bcsc_matmul"),
            entry=entry)
        steps = _decode_steps(model, st)
        judge.check(f"{tag}: prefill batches by exact length",
                    st["prefill_batches"] == len(ms)
                    and st["prefill_padded_tokens"]
                    == st["prefill_real_tokens"],
                    f"{st['prefill_batches']} batches (M {ms}), "
                    f"{st['prefill_padded_tokens']} padded = "
                    f"{st['prefill_real_tokens']} real tokens")
        judge.check(f"{tag}: sliding-window launches per prefill batch",
                    counts["sliding_window_attention"]
                    == n_local * len(ms),
                    f"{counts['sliding_window_attention']} = {n_local} "
                    f"local layers x {len(ms)} batches")
        judge.check(f"{tag}: fused-MLP launches per decode step",
                    counts["bcsc_mlp"] >= cfg.num_layers * steps,
                    f"{counts['bcsc_mlp']} >= {cfg.num_layers} x {steps} "
                    "steps (plus the prefills on the fused route)")
        judge.check(f"{tag}: GEMM launches on the prefills past the fused "
                    "route", counts["bcsc_matmul"]
                    == 3 * cfg.num_layers * gemm_batches(ms),
                    f"{counts['bcsc_matmul']} = 3 x {cfg.num_layers} x "
                    f"{gemm_batches(ms)} batches of M > {fused}")
        judge.check(f"{tag}: no paged attention",
                    counts["paged_attention"] == 0,
                    f"{counts['paged_attention']} launches")
        lines.append(line)
        total = counts if total is None else \
            {k: total[k] + counts[k] for k in total}
    del passes, model, llm
    mamba = _load(MAMBA, MAMBA_PLAN)
    mcfg = mamba.cfg
    counts, st, _, line = _turns(
        mamba, lambda: _requests(mcfg, MAMBA_LENS, MAMBA_NEW,
                                 [0] * len(MAMBA_LENS)), judge,
        "mamba2 stream pass", MAMBA_NEW, ())
    judge.check("mamba2 stream pass: no port kernel launched",
                sum(counts.values()) == 0, f"{counts}")
    judge.check("mamba2 stream pass: prefill batches by exact length",
                st["prefill_batches"] == len(set(MAMBA_LENS))
                and st["prefill_padded_tokens"] == st["prefill_real_tokens"],
                f"{st['prefill_batches']} batches")
    ms = _prefill_ms(mamba, MAMBA_LENS)
    lines.append(line)
    lines.append("mamba2-130m: one-prompt prefill by length: ms (SSD "
                 "chunk, peak GiB): " + ", ".join(
                     f"{n}: {t:.2f} ({chunk_size(n, mcfg.ssm_chunk)}, "
                     + (f"{peak:.2f})" if peak is not None else "-)")
                     for n, (t, peak) in ms.items()))
    log(f"  {lines[-1]}")
    return {k: total[k] + counts[k] for k in total}, lines


def phase_serve_moe(judge):
    """mixtral-8x7b at full width and ``MIXTRAL_LAYERS`` layers (each
    sliding-window attention, window 4096, and an MoE MLP of 8 experts of
    14336, top-2; random weights from SEED, the experts dense bf16: there
    is no MLP to pack), after the recurrent models were freed, on the
    contiguous plan its lack of a global layer resolves to: the logits
    check at ``MIXTRAL_CHECK`` (tier 8192: window-mode prefill, the sort
    dispatch at capacity 2560), then ``LLM.stream`` (``MIXTRAL_PLAN``,
    ``MIXTRAL_LENS``) and ``LLM.generate`` on ``plan_for_engine(slots=4,
    cache_len=8192)``, each graphed and eager in turns: the sliding window
    once per layer per prefill batch, no other port kernel (the expert
    products are torch matrix products, as the reference's are einsums).
    Prints the graphed step's device ms beside its bound: every expert's
    weights (decode runs all experts, as the reference's does) and the
    attention and head weights read once per step at the memory rate.
    Returns (the graphed runs' summed launch counts, lines of rates)."""
    from repro_torch.core.plan import plan_for_engine
    from repro_torch.models.moe import expert_capacity
    from repro_torch.serve import LLM
    llm = _load(MIXTRAL, MIXTRAL_PLAN, MIXTRAL_LAYERS)
    cfg, plan = llm.cfg, llm.plan
    judge.check(f"{MIXTRAL}: contiguous plan, power-of-two tiers",
                not plan.paged and not plan.prefill_exact
                and not plan.degrade,
                f"attn_path {plan.attn_path}, tier(5000) {plan.tier(5000)}")
    tier = plan.tier(max(MIXTRAL_CHECK))
    gaps = _check_logits_contiguous(llm, judge, MIXTRAL_CHECK, tier)
    step_bytes = sum(t.numel() * t.element_size()
                     for key, part in llm.params.items() if key != "embed"
                     for t in _leaves(part))
    bound_ms = 1e3 * step_bytes / HBM_BYTES_PER_S
    lines = [f"mixtral-8x7b ({cfg.num_layers} layers): kernels vs plain "
             f"logits gap {gaps[0]:.3e} (prefill), {gaps[1]:.3e} (decode); "
             f"sort dispatch at tier {tier}: capacity "
             f"{expert_capacity(tier, cfg)} slots per expert and row; "
             f"decode step bound {bound_ms:.3f} ms ({step_bytes / 1e9:.2f} "
             "GB of weights at the memory rate)"]
    log(f"  {lines[0]}")
    passes = (
        ("mixtral stream pass", llm, MIXTRAL_LENS, [0] * 4 + [8] * 4,
         "stream"),
        ("mixtral generate pass",
         LLM(cfg, llm.params, plan_for_engine(
             cfg, slots=MIXTRAL_PLAN["rows"],
             cache_len=MIXTRAL_PLAN["cache_len"]), eos_id=-1, device=DEVICE),
         MIXTRAL_GENERATE_LENS, [0] * len(MIXTRAL_GENERATE_LENS),
         "generate"))
    total = None
    for tag, model, lens, arrivals, entry in passes:
        counts, st, wall, line = _turns(
            model, lambda: _requests(cfg, lens, MIXTRAL_NEW, arrivals),
            judge, tag, MIXTRAL_NEW, ("sliding_window_attention",),
            entry=entry)
        judge.check(f"{tag}: sliding-window launches per prefill batch",
                    counts["sliding_window_attention"]
                    == cfg.num_layers * st["prefill_batches"],
                    f"{counts['sliding_window_attention']} = "
                    f"{cfg.num_layers} x {st['prefill_batches']} batches")
        others = {k: n for k, n in counts.items()
                  if k != "sliding_window_attention"}
        judge.check(f"{tag}: no other port kernel",
                    not any(others.values()), f"{others}")
        generated = len(lens) * MIXTRAL_NEW
        lines.append(
            line + f"; decode step bound {bound_ms:.3f} ms; prefill "
            f"{st['prefill_real_tokens'] / max(st['prefill_s'], 1e-9):.1f} "
            f"tokens/s ({st['prefill_real_tokens']} tokens in "
            f"{st['prefill_batches']} batches, {st['prefill_s']:.2f} s), "
            f"decode {generated / max(st['decode_s'], 1e-9):.1f} tokens/s, "
            f"wall {wall:.2f} s (the graphed run)")
        total = counts if total is None else \
            {k: total[k] + counts[k] for k in total}
    counts, line = _sharded_pass(llm, judge, "mixtral tp=2,ep=4 pass",
                                 "tp=2,ep=4", SHARDED_MIXTRAL_LENS,
                                 SHARDED_NEW)
    lines.append(line)
    return {k: total[k] + counts[k] for k in total}, lines


def _frontend_inputs(llm, rows: int, length: int):
    """A pass's prompts ((rows, length), or (rows, K, length) for K
    codebooks) and the frontend's embeddings (``cond`` or
    ``patch_embeds``, bf16 N(0, 1) x 0.02), from SEED."""
    import torch
    from repro_torch.models import frontend
    cfg, dev = llm.cfg, llm.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 7 + length)
    K = cfg.num_codebooks
    toks = torch.randint(0, cfg.vocab_size,
                         (rows, K, length) if K > 1 else (rows, length),
                         generator=gen, device=dev)
    extra = {}
    if cfg.cross_attn_cond:
        extra["cond"] = frontend.synth_cond_embeds(gen, rows, cfg, dev)
    if cfg.frontend == "vision":
        extra["patch_embeds"] = frontend.synth_patch_embeds(gen, rows, cfg,
                                                            dev)
    return toks, extra


def _positions_of(cfg, length: int) -> int:
    """Positions of a prompt of ``length`` tokens (patches before it)."""
    return length + (cfg.num_patches if cfg.frontend == "vision" else 0)


def _plain_stream(llm, toks, extra, new: int):
    """The plain path's greedy stream (``impl="plain"``: every kernel's
    plain version on the card) and its logits at each step: (tokens (B,
    new[, K]), [the (B[, K], V) logits each token was taken from])."""
    import torch
    from repro_torch.models import decoding
    cfg, plan = llm.cfg, llm.plan
    n = _positions_of(cfg, toks.shape[-1])
    logits, cache = decoding.prefill(llm.params, toks, cfg, n + new,
                                     plan=plan, impl="plain", **extra)
    pos = torch.full((toks.shape[0],), n, dtype=torch.long,
                     device=toks.device)
    out, seen = [], []
    for _ in range(new):
        last = logits[:, -1, ..., :cfg.vocab_size]
        seen.append(last)
        out.append(last.argmax(-1))
        logits, cache = decoding.serve_step(
            llm.params, cache, out[-1][..., None], pos, cfg, plan=plan,
            cond=extra.get("cond"), impl="plain")
        pos = pos + 1
    return torch.stack(out, dim=1), seen


def _stream_partings(got, want, seen):
    """Where the kernel path's stream ``got`` parts from the plain path's
    ``want`` (B, T[, K]): per row, the first step where any codebook
    differs and, at it, the plain logits' largest top-2 margin share over
    the parting codebooks; the row is compared no further."""
    import torch
    out = []
    for b in range(got.shape[0]):
        differ = (got[b] != want[b]).reshape(got.shape[1], -1)
        steps = torch.nonzero(differ.any(-1)).flatten()
        if not len(steps):
            continue
        t = int(steps[0])
        rows = seen[t][b].reshape(-1, seen[t].shape[-1])[differ[t]].float()
        top = torch.topk(rows, 2, dim=-1).values
        margin = (top[:, 0] - top[:, 1]) / rows.abs().amax(-1)
        out.append((b, t, float(margin.max())))
    return out


def _frontend_launches(cfg, plan, m_prefill: int, rows: int, steps: int):
    """Launches of one ``make_generate_fn`` call by the plan's routes: the
    sliding window once per layer in the prefill; each MLP (prefill M
    ``m_prefill``, then ``steps`` decode steps of M ``rows``) one fused
    launch a layer on the fused route, else its 2 (ungated) or 3 (gated)
    products through the GEMV or the GEMM; paged attention never (a
    contiguous cache)."""
    from repro_torch.kernels import ops
    n, mats = cfg.num_layers, 3 if cfg.mlp_gated else 2
    want = dict.fromkeys(ops.launch_counts(), 0)
    want["sliding_window_attention"] = n
    for M, times in ((m_prefill, 1), (rows, steps)):
        if plan.mlp_route(M) == "fused":
            want["bcsc_mlp"] += n * times
        else:
            key = "bcsc_gemv" if plan.matmul_route(M) == "gemv" \
                else "bcsc_matmul"
            want[key] += mats * n * times
    return want


def _kernel_groups(graph, n: int = 8):
    """Device ms per replay of ``graph`` by kernel group, from a profiler
    trace of ``n`` replays read as raw kineto events (the event tree of
    thousands of kernels would take long to build): the port's kernels,
    cuBLAS, PyTorch's elementwise kernels, its reductions, the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        group = ("port kernels" if "repro" in name else
                 "cuBLAS" if "nvjet" in name or "gemm" in name.lower()
                 or "cutlass" in name else
                 "elementwise" if "elementwise" in name else
                 "reductions" if "reduce" in name.lower() else "other")
        groups[group] = groups.get(group, 0.0) + e.duration_ns() / 1e6 / n
    return groups


def _step_device_ms(fn, n: int = 16):
    """(device ms, host ms, device ms by kernel group, graph) of one decode
    step
    ``fn`` (a ``serve_step`` on fixed tensors, eager): the host clock
    around one synchronised eager call; then ``fn`` captured as a CUDA
    graph (two warm-up calls on the capture stream first, as
    ``serve.graphs.StepGraph`` does) and ``n`` replays back to back between
    CUDA events, which time the device's work with no gap for the host's
    launches (an eager step's thousands of launches fill the launch queue,
    so the device would run at the host's pace); then ``_kernel_groups``.
    The capture's launch counts are taken back out. Device ms, groups and
    the graph (which replays ``fn`` on its tensors, so they must outlive
    it) None on the CPU."""
    import torch
    from repro_torch.kernels import ops
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    host_ms = (time.perf_counter() - t0) * 1e3
    if DEVICE != "cuda":
        return None, host_ms, None, None
    before = ops.launch_counts()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    ops.set_launches(before)
    return _replay_ms(graph, n), host_ms, _kernel_groups(graph), graph


def _replay_ms(graph, n: int = 16) -> float:
    """Device ms per replay of the CUDA graph ``graph``: one replay, then
    ``n`` back to back between CUDA events."""
    import torch
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _frontend_check_logits(llm, judge, toks, extra):
    """The prefill and first decode step's logits of the kernel path
    against ``impl="plain"`` on the same weights and inputs (the kernel
    path's greedy tokens fed to both). Returns the two gaps."""
    import torch
    from repro_torch.models import decoding
    cfg, plan = llm.cfg, llm.plan
    n = _positions_of(cfg, toks.shape[-1])
    pos = torch.full((toks.shape[0],), n, dtype=torch.long,
                     device=toks.device)
    out, nxt = {}, None
    for impl in (None, "plain"):
        logits, cache = decoding.prefill(llm.params, toks, cfg, n + 1,
                                         plan=plan, impl=impl, **extra)
        if nxt is None:
            nxt = logits[:, -1, ..., :cfg.vocab_size].argmax(-1)[..., None]
        step, _ = decoding.serve_step(llm.params, cache, nxt, pos, cfg,
                                      plan=plan, cond=extra.get("cond"),
                                      impl=impl)
        out[impl] = (logits[..., :cfg.vocab_size],
                     step[..., :cfg.vocab_size])
        del cache
    sync()
    gaps = []
    for i, what in enumerate(("prefill", "decode")):
        got, want = out[None][i], out["plain"][i]
        judge.check(f"{cfg.name} {what} logits finite",
                    bool(torch.isfinite(got).all()), f"{tuple(got.shape)}")
        gaps.append(errors(got, want)[1])
        judge(f"{cfg.name} {what} logits, kernels vs plain", gaps[-1], 5e-2,
              f"relative to max |logit| after {cfg.num_layers} layers at "
              f"{tuple(toks.shape)} tokens: sums in another order flip bf16 "
              "roundings, which the layers carry forward")
    return gaps


def _generate_turn(generate, llm, toks, extra):
    """One ``generate`` call on ``llm``'s weights, synchronised on both
    sides, with its prefill timed inside it (``decoding.prefill``
    synchronised around). Returns (tokens, wall s, prefill s)."""
    from repro_torch.models import decoding
    prefill, marks = decoding.prefill, {}

    def timed_prefill(*args, **kw):
        sync()
        t0 = time.perf_counter()
        out = prefill(*args, **kw)
        sync()
        marks["prefill_s"] = time.perf_counter() - t0
        return out
    decoding.prefill = timed_prefill
    try:
        sync()
        t0 = time.perf_counter()
        got = generate(llm.params, toks, **extra)
        sync()
        wall = time.perf_counter() - t0
    finally:
        decoding.prefill = prefill
    return got, wall, marks["prefill_s"]


def _frontend_pass(llm, judge, rows: int, length: int, new: int):
    """One ``make_generate_fn`` pass of ``rows`` prompts of ``length``
    tokens and ``new`` new tokens: in turns, a graphed call (its first: it
    captures the decode step), a ``graphs=False`` call and a graphed call
    that replays the captured step, with the launch counts zeroed just
    before it and read just after (the main path's run), held to
    ``_frontend_launches``; the three calls' tokens equal bit for bit;
    each call's prefill timed inside it (synchronised on both sides) and
    the rest counted as decode; a fourth, graphed, call and the prefill
    alone under ``_device_transfers`` (the decode steps must add no
    device-to-host copy); then one decode step on the cache of a
    ``make_prefill_step`` prefill, its device ms (``_step_device_ms``)
    against its bound, and its graph and the generate call's own step
    graph replayed in turns (each 16 replays, twice), the latter by kernel
    group too; the stream against the plain path's (equal, or parted at
    near-ties). Returns (launch counts, line)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import decoding
    from repro_torch.serve.engine import make_generate_fn, make_prefill_step
    cfg, plan = llm.cfg, llm.plan
    tag = f"{cfg.name} {rows} x {length} + {new}"
    toks, extra = _frontend_inputs(llm, rows, length)
    n = _positions_of(cfg, length)
    prefill_step = make_prefill_step(cfg, n + new, plan)
    _reset_peak()
    generate = make_generate_fn(cfg, new, plan=plan)
    eager = make_generate_fn(cfg, new, plan=plan, graphs=False)
    first, first_wall, _ = _generate_turn(generate, llm, toks, extra)
    want, eager_wall, eager_prefill_s = _generate_turn(eager, llm, toks,
                                                       extra)
    del eager
    ops.reset_launches()
    got, wall, prefill_s = _generate_turn(generate, llm, toks, extra)
    counts = ops.launch_counts()
    peak = _memory("peak of the generate calls")
    captures = [c for loop in generate.loops.values() for c in loop.captures]
    shape = (rows, new, cfg.num_codebooks) if cfg.num_codebooks > 1 \
        else (rows, new)
    judge.check(f"{tag}: tokens", tuple(got.shape) == shape and bool(
        ((got >= 0) & (got < cfg.vocab_size)).all()),
        f"{tuple(got.shape)} in-vocab tokens")
    judge.check(f"{tag}: graphed calls == the graphs=False call, bit for "
                "bit", torch.equal(first, want) and torch.equal(got, want),
                f"{len(captures)} capture(s) "
                + ", ".join(f"{c:.2f} s" for c in captures))
    judge.check(f"{tag}: one step graph, captured once",
                DEVICE != "cuda" or len(captures) == 1,
                f"captures {captures}")
    want_n = _frontend_launches(cfg, plan, rows * n, rows, new)
    judge.check(f"{tag}: launches by the plan's routes", counts == want_n,
                f"{counts} vs {want_n}")
    _, dtoh, sites = _device_transfers(
        lambda: generate(llm.params, toks, **extra))
    _, dtoh_prefill, _ = _device_transfers(
        lambda: prefill_step(llm.params, toks, **extra))
    judge.check(f"{tag}: the graphed decode steps copy nothing to the host",
                dtoh == dtoh_prefill,
                "not measured (CPU)" if dtoh is None else
                f"{dtoh} device-to-host copies in a traced generate call, "
                f"{dtoh_prefill} in its prefill alone; host-blocking calls "
                f"by site: {_sites(sites)}")
    logits, cache = prefill_step(llm.params, toks, **extra)
    nxt = logits[:, -1, ..., :cfg.vocab_size].argmax(-1)[..., None]
    pos = torch.full((rows,), n, dtype=torch.long, device=llm.device)
    step_ms, step_host_ms, groups, step_graph = _step_device_ms(
        lambda: decoding.serve_step(llm.params, cache, nxt, pos, cfg,
                                    plan=plan, cond=extra.get("cond")))
    # the generate call's own step graph (sampling, the step, the copies
    # into its buffers), replayed past the run's end (positions stay at
    # the cache's last slot, so each replay reads the whole cache), in
    # turns with the serve_step graph
    graph = next(iter(generate.loops.values())).graph
    turns, loop_groups = [], None
    if graph is not None:
        turns = [(_replay_ms(step_graph), _replay_ms(graph.graph))
                 for _ in range(2)]
        loop_groups = _kernel_groups(graph.graph)
    del generate, graph, step_graph, cache, logits
    plain, seen = _plain_stream(llm, toks, extra, new)
    parts = _stream_partings(got, plain, seen)
    judge.check(f"{tag}: kernel and plain streams equal, or parted only at "
                "a near-tie", all(m < NEAR_TIE for _, _, m in parts),
                f"partings (row, step, top-2 margin / max |logit|): "
                f"{parts or 'none'}")
    del plain, seen
    # the step's bound: its weights as stored (packs with their pads; the
    # embedding, of which a step reads a row per token, left out) and the
    # K/V it reads at the memory rate, against its products (2 flops per
    # row per bf16 weight; musicgen's cross-attention recomputes the
    # conditioning's K and V each step) at the bf16 peak
    KV, D, layers = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    weights = [t for key, part in llm.params.items() if key != "embed"
               for t in _leaves(part)]
    w_bytes = sum(t.numel() * t.element_size() for t in weights)
    kv_bytes = rows * (n + 1) * layers * 2 * KV * D * 2
    flops = 2 * rows * sum(t.numel() for t in weights
                           if t.dtype == torch.bfloat16)
    if cfg.cross_attn_cond:
        flops += (2 * rows * cfg.cross_attn_cond * cfg.d_model
                  * 2 * cfg.num_heads * D * layers)
    bound_ms, by = bound(w_bytes + kv_bytes, flops)
    decode_s = max(wall - prefill_s, 1e-9)
    eager_s = max(eager_wall - eager_prefill_s, 1e-9)
    books = f" of {cfg.num_codebooks} codebooks" \
        if cfg.num_codebooks > 1 else ""
    line = (f"{tag} (make_generate_fn): prefill {rows * n / prefill_s:.1f} "
            f"positions/s ({rows} x {n}"
            + (f", {cfg.num_patches} patches each" if n != length else "")
            + f", {prefill_s * 1e3:.1f} ms); decode graphed "
            f"{rows * new / decode_s:.1f} tokens/s ({rows} rows x {new} "
            f"steps{books} in {decode_s:.3f} s: {decode_s / new * 1e3:.3f} "
            f"ms a step), eager {rows * new / eager_s:.1f} tokens/s "
            f"({eager_s / new * 1e3:.3f} ms a step); one decode step "
            + (f"{step_ms:.3f} ms on the device (captured, 16 replays; "
               f"graphed wall / device {decode_s / new * 1e3 / step_ms:.3f}"
               "; by kernel group, traced: " + ", ".join(
                   f"{g} {t:.3f}" for g, t in sorted(
                       groups.items(), key=lambda kv: -kv[1]))
               + "; in turns, serve_step graph / the generate call's own "
               "step graph at the cache's end: " + ", ".join(
                   f"{a:.3f} / {b:.3f}" for a, b in turns)
               + " ms; the latter by kernel group: " + ", ".join(
                   f"{g} {t:.3f}" for g, t in sorted(
                       loop_groups.items(), key=lambda kv: -kv[1])) + ")"
               if step_ms is not None else "not measured on a device (CPU)")
            + f", {step_host_ms:.1f} ms of host clock eager; bound "
            f"{bound_ms:.3f} ms ({by}: {w_bytes / 1e9:.2f} GB of weights, "
            f"{kv_bytes / 1e6:.1f} MB of K/V, {flops / 1e9:.1f} GFLOP); "
            f"capture {', '.join(f'{c:.2f}' for c in captures) or 'none'} "
            f"s (first call's wall {first_wall:.2f} s); wall {wall:.2f} s; "
            f"{peak}")
    log(f"  {line}")
    return counts, line


def phase_serve_frontends(judge):
    """musicgen-large at full width and depth (48 layers, cross-attention
    to ``cond`` of 64 embeddings, four codebooks, sinusoidal positions,
    ungated tanh-gelu MLPs packed at 0.75) and internvl2-26b at full width
    and ``INTERNVL_LAYERS`` layers (256 vision patches before the text,
    GQA 48 / 8 heads of 128, gated silu MLPs packed at 0.75; built one
    layer at a time), each after the previous model was freed, through
    ``make_generate_fn`` (the serving loops do not serve them, as the
    reference's do not): the load's memory peak, the logits check on the
    first pass's inputs, then each pass of ``MUSICGEN_PASSES`` /
    ``INTERNVL_PASSES`` (``_frontend_pass``).
    Returns (the main-path runs' summed launch counts, lines of rates)."""
    lines, total = [], None
    for arch, plan_kw, layers, layered, passes in (
            (MUSICGEN, MUSICGEN_PLAN, 0, False, MUSICGEN_PASSES),
            (INTERNVL, INTERNVL_PLAN, INTERNVL_LAYERS, True,
             INTERNVL_PASSES)):
        llm = _load(arch, plan_kw, layers, layered)
        lines.append(f"{arch} ({llm.cfg.num_layers} layers"
                     + (", built one layer at a time" if layered else "")
                     + f"): {_memory('load peak')}")
        rows, length, _ = passes[0]
        gaps = _frontend_check_logits(llm, judge,
                                      *_frontend_inputs(llm, rows, length))
        lines.append(f"{arch} ({llm.cfg.num_layers} layers): kernels vs "
                     f"plain logits gap {gaps[0]:.3e} (prefill), "
                     f"{gaps[1]:.3e} (decode)")
        log(f"  {lines[-1]}")
        for rows, length, new in passes:
            counts, line = _frontend_pass(llm, judge, rows, length, new)
            lines.append(line)
            total = counts if total is None else \
                {k: total[k] + counts[k] for k in total}
        del llm
    return total, lines


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out
    try:
        import torch
        card = timed("device", phase_device)
        timed("build", phase_build)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        judge, records = Judge(), {}
        timed("kernels", phase_kernels, flush, judge, records)
        for arch in (GEMMA, NEMO, GEMMA3):
            timed(f"kernels ({arch} widths)", phase_kernels_model, flush,
                  judge, arch)
        timed("kernels (dense)", phase_kernels_dense, flush, judge, records)
        timed("kernels (tp shards)", phase_kernels_shards, flush, judge)
        timed("kernels (frontend widths)", phase_kernels_frontends, flush,
              judge)
        timed("kernels (flash backward)", phase_kernels_backward, flush,
              judge, records)
        timed("kernels (query offset)", phase_kernels_seqshard, flush, judge,
              records)
        del flush
        launches, rates, llm = timed("serve qwen2.5-3b", phase_serve, judge)
        counts, more = timed("serve qwen2.5-3b guarded", phase_serve_guarded,
                             judge, llm)
        rates += more
        launches = {k: launches[k] + counts[k] for k in launches}
        counts, more = timed("serve qwen2.5-3b prefix + spec",
                             phase_serve_prefix_spec, judge, llm)
        rates += more
        launches = {k: launches[k] + counts[k] for k in launches}
        counts, more = timed("serve qwen2.5-3b front door", phase_front_door,
                             judge, llm, records)
        rates += more
        launches = {k: launches[k] + counts[k] for k in launches}
        counts, more = timed("serve qwen2.5-3b fleet", phase_fleet, judge,
                             llm)
        del llm
        rates += more
        launches = {k: launches[k] + counts[k] for k in launches}
        torch.cuda.empty_cache()
        for name, phase in (("serve gemma2-2b", phase_serve_gemma),
                            ("serve mistral-nemo-12b", phase_serve_nemo),
                            ("serve gemma3-12b", phase_serve_gemma3),
                            ("serve recurrentgemma-2b + mamba2-130m",
                             phase_serve_recurrent),
                            ("serve mixtral-8x7b", phase_serve_moe),
                            ("serve musicgen-large + internvl2-26b",
                             phase_serve_frontends),
                            ("train qwen2.5-3b", phase_train),
                            ("train qwen2.5-3b on a mesh", phase_train_mesh),
                            ("train qwen2.5-3b compressed DP",
                             phase_train_compressed),
                            ("elastic round trip", phase_elastic),
                            ("train qwen2.5-3b over processes",
                             phase_train_dist),
                            ("cells qwen2.5-3b", phase_cells)):
            counts, more = timed(name, phase, judge)
            rates += more
            launches = {k: launches[k] + counts[k] for k in launches}
        if judge.failures:
            raise SmokeFailure(f"checks failed: {judge.failures}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"{card}:")
    for line in rates + records["seqshard"]:
        log(f"  {line}")
    log("phase wall times: " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in walls.items()))
    kernels = []
    for name, source, replaces in KERNELS:
        rec = records[name]
        ms, by = rec["bound"]
        lib = "none" if rec["library_ms"] is None \
            else f"{rec['library_ms']:.4f} ms"
        log(f"{name} ({rec['shape']}): {rec['ms']:.4f} ms per launch, bound "
            f"{ms:.4f} ms ({by}), plain {rec['plain_ms']:.4f} ms, library "
            f"{lib}, {launches[name]} launches")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": ms, "bound_by": by,
            "library_ms": rec["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
