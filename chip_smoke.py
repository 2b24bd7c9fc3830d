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
   softcap among them) and at head ratios 5, 6 and 10 (llama4,
   internvl2-26b and recurrentgemma-2b heads), causal and in window mode.
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
   contiguous cache);
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
6. serve gemma2-2b, mistral-nemo-12b and gemma3-12b, each at full width and
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
   every pass of 4 and 6 runs three times in turns (``_turns``): with the
   decode step captured as a CUDA graph (the first run captures it), with
   the eager step (``decode_graphs=False``), with the graph again. The
   three must give equal streams token for token, and the last run (the
   main path's: launch counts zeroed just before, read just after) the
   eager run's launch counts exactly, with paged attention once per global
   layer per decode step (``core.plan.num_global_layers``), the MLP kernel
   at least once per layer per step and, on the stream passes of 6, the
   sliding window once per layer per prefill batch. Each pass prints
   prefill and decode tokens/s in both modes, the graphed step's device
   time (CUDA events around 16 replays), its kernels' busy time and the
   three pairs of kernels with the most idle time between them (a profiler
   trace of 16 more), the capture time and the peak of device memory;
   each load prints its own peak;
7. report: prefill and decode tokens/s, the wall time of each phase, one
   JSON line describing every kernel, the card's name and power limit, then
   the contract line.

``rs_matmul`` is on no model path (as in the reference), so it launches only
in the kernel phase and reports 0 launches on the main path.

Exits non-zero, printing no result, when there is no CUDA device or when run
outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
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
# the serve phases' device; a CPU rehearsal of their control flow sets
# DEVICE = "cpu", the reduced archs and smaller gemma2 geometry
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
    through cuBLAS on the decoded weights; returns (record, log line)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels import bcsc_matmul as bm
    from repro_torch.kernels import bcsc_mlp as bmlp
    wg, wu, wd = packs
    Mp, d = x.shape
    n_real = int(counts.sum())

    def trip(p, key):
        return (p["blocks"], p["row_ids"], p[key])

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
                        for p in (wg, wu)], 1).bfloat16()
    wdown = bm._dense_weight(*trip(wd, "col_ids"), ff, d).bfloat16()
    xm = x[:M]

    def act_fn(v):
        return F.silu(v) if act == "silu" else F.gelu(v, approximate="tanh")

    def library():
        gu = torch.matmul(xm, wdense)
        return torch.matmul(act_fn(gu[:, :ff]) * gu[:, ff:], wdown)
    rec = dict(max_abs_err=abs_err, ms=time_ms(cu, flush),
               plain_ms=time_ms(plain, flush),
               library_ms=time_ms(library, flush),
               bound=bound(M * d * 2 + n_real * BLOCK_BYTES + M * d * 4,
                           2 * M * 256 * n_real),
               shape=f"{tag}: M {M}, {d} -> {ff} -> {d}, {act}, {n_real} "
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


def _paged_line(cfg, geometry, lengths, kv, gen, flush, judge):
    """Paged attention at a model's decode shape (its pass's rows, ragged
    lengths, a random block table with never-touched tails), fp or int8
    pages: held against the plain version, equal bits on a second call,
    timed against the plain version, SDPA over gathered (dequantized) pages
    and the bound; returns the log line."""
    import torch
    from repro_torch.kernels import paged_attention as pa
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
        sc, kd, vd, elem = {}, kp, vp, 2
    else:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        sc = dict(k_scale=torch.rand(P, KV, generator=gen, device=dev) * 4,
                  v_scale=torch.rand(P, KV, generator=gen, device=dev) * 4)
        kd, vd = ((p.float() * s[:, None, :, None] / 127).bfloat16()
                  for p, s in ((kp, sc["k_scale"]), (vp, sc["v_scale"])))
        elem = 1
    args = (q, kp, vp, bt, lengths)
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
            x2 = dec._residual(x_p, a["plain"], p, "post_norm", cfg)
            h2 = rms_norm(x2, p["pre_norm_mlp"], eps)
            m = {impl: layers.mlp(p["mlp"], h2, cfg, plan, impl=impl)
                 for impl in both}
            x_k, _ = dec._block_prefill(p, x_k, kind, pos, cfg, cache_len,
                                        lens, None, None, plan, None)
            x_p = dec._residual(x2, m["plain"], p, "post_norm_mlp", cfg)
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
            x2 = dec._residual(x_p, a["plain"], p, "post_norm", cfg)
            h2 = rms_norm(x2, p["pre_norm_mlp"], eps)
            m = {impl: layers.mlp(p["mlp"], h2, cfg, plan, impl=impl)
                 for impl in both}
            x_p = dec._residual(x2, m["plain"], p, "post_norm_mlp", cfg)
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


def _load(arch, plan_kw):
    """Full-width random weights from SEED, MLPs packed at 0.75, on the
    device behind ``LLM`` with a paged fp plan. Frees the previous model
    first and prints the peak of device memory over the load (the fp32
    weights of ``init_params`` beside one layer's packing temporaries)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.plan import plan_for_scheduler
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import LLM
    from repro_torch.serve.sparse import sparsify_mlp_params

    _free()
    _reset_peak()
    cfg = get_config(arch)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, gen, DEVICE)
    packed, stats = sparsify_mlp_params(params, cfg, sparsity=0.75)
    del params
    plan = plan_for_scheduler(cfg, attn_path="paged", share_prefix=False,
                              kv_quant="fp", sync_every=8, **plan_kw)
    llm = LLM(cfg, packed, plan, eos_id=-1, device=DEVICE)
    del packed
    sync()
    log(f"serve: {arch}, {cfg.num_layers} layers {cfg.attn_pattern}, "
        f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, head_dim {cfg.head_dim}; "
        f"MLPs packed at block density {stats['block_density']:.3f} "
        f"({stats['kept_blocks']} blocks); loaded in "
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
                           attn_path="paged", share_prefix=False,
                           kv_quant="int8", sync_every=8),
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
    total = {k: launches[k] + counts8[k] + counts_g[k] for k in launches}
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

    # ---- pressure: the int8 rung mid-run, graphed against eager
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
    chaos_llm = LLM(cfg, llm.params, llm.plan, eos_id=-1, device=DEVICE,
                    guard=guard)
    eager = LLM(cfg, llm.params, llm.plan, eos_id=-1, device=DEVICE,
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
    return counts, [line, rates]


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
    plan8 = plan_for_scheduler(cfg, attn_path="paged", share_prefix=False,
                               kv_quant="int8", sync_every=8, **GEMMA3_PLAN)
    llm8 = LLM(cfg, llm.params, plan8, eos_id=-1, device=DEVICE)
    counts8, _, _, line = _stream_pass(llm8, judge, "gemma3 int8 pass",
                                       GEMMA3_INT8_LENS, GEMMA3_INT8_NEW,
                                       [0] * len(GEMMA3_INT8_LENS))
    lines.append(line + f"; fused MLP up to M {plan8.mlp_fused_m_max}")
    return {k: counts[k] + counts8[k] for k in counts}, lines


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
        del flush
        launches, rates, llm = timed("serve qwen2.5-3b", phase_serve, judge)
        counts, more = timed("serve qwen2.5-3b guarded", phase_serve_guarded,
                             judge, llm)
        del llm
        rates += more
        launches = {k: launches[k] + counts[k] for k in launches}
        torch.cuda.empty_cache()
        for name, phase in (("serve gemma2-2b", phase_serve_gemma),
                            ("serve mistral-nemo-12b", phase_serve_nemo),
                            ("serve gemma3-12b", phase_serve_gemma3)):
            counts, more = timed(name, phase, judge)
            rates += more
            launches = {k: launches[k] + counts[k] for k in launches}
        if judge.failures:
            raise SmokeFailure(f"checks failed: {judge.failures}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"{card}:")
    for line in rates:
        log(f"  {line}")
    log("phase wall times: " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in walls.items()))
    kernels = []
    for name, source, replaces in KERNELS:
        rec = records[name]
        ms, by = rec["bound"]
        log(f"{name} ({rec['shape']}): {rec['ms']:.4f} ms per launch, bound "
            f"{ms:.4f} ms ({by}), plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']:.4f} ms, {launches[name]} launches")
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
