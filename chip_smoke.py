#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: require CUDA (no CPU fallback); print the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compile the port's CUDA kernels from the sources in this checkout
   (one nvcc per source, all started together);
3. kernels: hold each of the six kernels against its plain PyTorch version
   at the shapes the main paths give it (qwen2.5-3b and gemma2-2b widths),
   with the tolerance stated beside each, and time the kernel, the plain
   version and, where one exists, the single PyTorch call that computes the
   same function (CUDA events around the device's work, L2 flushed before
   each launch; paged attention against SDPA over gathered pages at both
   models' shapes); print each attention kernel's launch configuration
   (paged attention's split, the sliding window's blocks, stages and
   shared memory) beside the compiler's registers and spills;
4. serve qwen2.5-3b: full width and depth, random weights from a seed, MLPs
   packed at 0.75 block sparsity. First the first prefill and decode logits
   of the kernel path are held against the plain path; then 12 requests go
   through ``LLM.stream`` on paged fp KV (launch counts zeroed just before,
   read just after: sliding-window attention, paged attention, the fused MLP
   and the GEMM must have run), then 4 requests on int8 KV pages with the
   two-call MLP route (the GEMV and GEMM arms);
5. serve gemma2-2b: full width and depth (26 layers alternating local and
   global attention, softcaps), the same checks, then 6 requests of up to
   6000 prompt tokens through ``LLM.stream`` on paged fp KV: prefill runs
   the sliding-window kernel in window mode in the local layers, decode
   past position 4096 wraps the local rings; every request must return its
   budget of in-vocabulary tokens;
6. report: prefill and decode tokens/s, the wall time of each phase, one
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
                log(f"  ptxas: {name}: {regs.group(1) if regs else '?'} "
                    f"registers; {spill}")


def _packed_weight(K, N, sparsity, gen):
    import torch
    from repro_torch.core import sparsity as sp
    from repro_torch.serve.sparse import pack_weight
    w = torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5
    return pack_weight(sp.block_magnitude_prune(w, sparsity, 16, 16), 16, 16,
                       torch.bfloat16)


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


def phase_kernels(flush, judge, records):
    """Each kernel against its plain version at the shapes the main path
    gives it; fills ``records[name]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import bcsc_matmul as bm
    from repro_torch.kernels import bcsc_mlp as bmlp
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

    # ---- fused MLP: M 8 and 64, K 2048, d_ff 11008, sparsity 0.75
    wg = _packed_weight(d, ff, 0.75, gen)
    wu = _packed_weight(d, ff, 0.75, gen)
    wd = _packed_weight(ff, d, 0.75, gen)
    counts = torch.stack([wg["nnzb"], wu["nnzb"], wd["nnzb"]])
    n_real = int(counts.sum())

    def trip(p, key):
        return (p["blocks"], p["row_ids"], p[key])

    for M in (8, 64):
        x = torch.randn(M, d, generator=gen, device=dev).bfloat16()

        def cu():
            return bmlp.bcsc_mlp_cuda(
                x, trip(wg, "col_ptr"), trip(wu, "col_ptr"),
                trip(wd, "col_ptr"), counts, d_ff=ff, n_out=d,
                activation="silu")

        def plain():
            return bmlp.bcsc_mlp_plain(
                x, trip(wg, "col_ids"), trip(wu, "col_ids"),
                trip(wd, "col_ids"), counts, d_ff=ff, n_out=d,
                activation="silu")
        abs_err, rel = errors(cu(), plain())
        judge(f"bcsc_mlp[M={M}]", rel, 2e-3,
              "relative to max |out|: an fp32 sum in another order can flip "
              "the bf16 rounding of a hidden value, 2^-8 of it")
        if M == 8:          # the decode shape at rows 8
            wdense = torch.cat([bm._dense_weight(*trip(p, "col_ids"), k, n)
                                for p, k, n in ((wg, d, ff), (wu, d, ff))],
                               1).bfloat16()
            wdown = bm._dense_weight(*trip(wd, "col_ids"), ff, d).bfloat16()

            def library():
                gu = torch.matmul(x, wdense)
                return torch.matmul(F.silu(gu[:, :ff]) * gu[:, ff:], wdown)
            records["bcsc_mlp"] = dict(
                max_abs_err=abs_err, ms=time_ms(cu, flush),
                plain_ms=time_ms(plain, flush),
                library_ms=time_ms(library, flush),
                bound=bound(x.numel() * 2 + n_real * BLOCK_BYTES + M * d * 4,
                            2 * M * 256 * n_real),
                shape=f"M {M}, {d} -> {ff} -> {d}, {n_real} real blocks")

    # ---- GEMM (prefill, M 512) and GEMV (decode, M 1 and 8)
    for name, (K, N, w) in {"up": (d, ff, wg), "down": (ff, d, wd)}.items():
        x = torch.randn(512, K, generator=gen, device=dev).bfloat16()

        def cu():
            return bm.bcsc_matmul_cuda(x, w["blocks"], w["row_ids"],
                                       w["col_ptr"], n_out=N)

        def plain():
            return bm.bcsc_matmul_plain(x, w["blocks"], w["row_ids"],
                                        w["col_ids"], n_out=N)
        abs_err, rel = errors(cu(), plain())
        judge(f"bcsc_matmul[512x{K}->{N}]", rel, 1e-3,
              "relative to max |out|: tensor-core fp32 accumulation of the "
              "same bf16 products in another order")
        if name == "up":
            nnz = int(w["nnzb"])
            wdense = bm._dense_weight(*trip(w, "col_ids"), K, N).bfloat16()
            records["bcsc_matmul"] = dict(
                max_abs_err=abs_err, ms=time_ms(cu, flush),
                plain_ms=time_ms(plain, flush),
                library_ms=time_ms(lambda: torch.matmul(x, wdense), flush),
                bound=bound(x.numel() * 2 + nnz * BLOCK_BYTES + 512 * N * 4,
                            2 * 512 * 256 * nnz),
                shape=f"M 512, {K} -> {N}, {nnz} blocks")
    bias = torch.randn(ff, generator=gen, device=dev)
    for M, act, b in ((1, None, None), (8, "silu", bias)):
        x = torch.zeros(8, d, device=dev, dtype=torch.bfloat16)
        x[:M] = torch.randn(M, d, generator=gen, device=dev).bfloat16()

        def cu():
            return bm.bcsc_gemv_cuda(x, wg["blocks"], wg["row_ids"],
                                     wg["col_ptr"], n_out=ff, bias=b,
                                     activation=act)

        def plain():
            return bm.bcsc_gemv_plain(x, wg["blocks"], wg["row_ids"],
                                      wg["col_ids"], n_out=ff, bias=b,
                                      activation=act)
        abs_err, rel = errors(cu()[:M], plain()[:M])
        judge(f"bcsc_gemv[M={M}]", rel, 1e-4,
              "relative to max |out|: fp32 FMA of the same bf16 products in "
              "another order")
        if M == 8:
            nnz = int(wg["nnzb"])
            wdense = bm._dense_weight(*trip(wg, "col_ids"), d, ff).bfloat16()
            records["bcsc_gemv"] = dict(
                max_abs_err=abs_err, ms=time_ms(cu, flush),
                plain_ms=time_ms(plain, flush),
                library_ms=time_ms(lambda: F.silu(torch.addmm(
                    bias.bfloat16(), x, wdense)), flush),
                bound=bound(x.numel() * 2 + nnz * BLOCK_BYTES + ff * 4
                            + 8 * ff * 4, 2 * 8 * 256 * nnz),
                shape=f"M 8, {d} -> {ff}, bias + silu, {nnz} blocks")


def phase_kernels_gemma(flush, judge):
    """Paged attention, the fused MLP and the GEMM at the shapes the gemma2
    pass gives them (head_dim 256, two query heads per KV head, softcap 50,
    tanh-gelu, 2304 -> 9216 -> 2304), each against its plain version with
    the tolerance used at qwen2.5-3b shapes; returns the log lines of their
    times (the JSON line keeps the qwen2.5-3b shapes)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import bcsc_matmul as bm
    from repro_torch.kernels import bcsc_mlp as bmlp
    from repro_torch.kernels import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cfg = get_config(GEMMA)
    d, ff = cfg.d_model, cfg.d_ff
    log("kernels: paged attention, fused MLP and GEMM at gemma2-2b widths")
    lines = []

    # ---- paged attention: the pass's 4 rows, ragged up to 6000 tokens
    KV, D, ps = cfg.num_kv_heads, cfg.head_dim, GEMMA_PLAN["page_size"]
    R, MP = cfg.num_heads // KV, GEMMA_PLAN["cache_len"] // ps
    lengths = torch.tensor([6000, 7, 4724, 1523], dtype=torch.int32,
                           device=dev)
    B, P = len(lengths), len(lengths) * MP
    bt = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    bt = bt.reshape(B, MP).clone()
    for b in range(B):
        bt[b, -(-int(lengths[b]) // ps):] = -1
    q = torch.randn(B, KV, R, D, generator=gen, device=dev).bfloat16()
    kp = torch.randn(P, ps, KV, D, generator=gen, device=dev).bfloat16()
    vp = torch.randn(P, ps, KV, D, generator=gen, device=dev).bfloat16()
    args = (q, kp, vp, bt, lengths)
    cap = cfg.attn_logit_softcap
    log("  " + _split_line(B, KV, MP))

    def cu():
        return pa.paged_attention_cuda(*args, softcap=cap)

    def plain():
        return pa.paged_attention_plain(*args, softcap=cap)
    abs_err, _ = errors(cu(), plain())
    torch.cuda.synchronize()
    judge(f"paged_attention[gemma2: D {D}, R {R}, softcap {cap:g}]", abs_err,
          1e-4, "absolute on outputs of order 1: fp32 online softmax vs one "
          "masked softmax, sums in another order")
    tokens = int(lengths.sum())
    ms, by = bound(q.numel() * 2 + 2 * tokens * KV * D * 2 + bt.numel() * 4
                   + B * 4 + B * KV * R * D * 4, 4 * tokens * KV * R * D)
    sdpa = _sdpa_over_pages(q, kp, vp, bt, lengths)
    lines.append(f"paged_attention (gemma2: B {B}, KV {KV}, R {R}, D {D}, "
                 f"softcap {cap:g}, {tokens} tokens): "
                 f"{time_ms(cu, flush):.4f} ms, plain "
                 f"{time_ms(plain, flush):.4f} ms, SDPA over gathered pages "
                 f"(no softcap) {time_ms(sdpa, flush):.4f} ms, bound "
                 f"{ms:.4f} ms ({by})")
    del kp, vp, sdpa

    # ---- fused MLP (decode, M 4, and short prefill, M 64), tanh-gelu
    wg = _packed_weight(d, ff, 0.75, gen)
    wu = _packed_weight(d, ff, 0.75, gen)
    wd = _packed_weight(ff, d, 0.75, gen)
    counts = torch.stack([wg["nnzb"], wu["nnzb"], wd["nnzb"]])

    def trip(p, key):
        return (p["blocks"], p["row_ids"], p[key])
    for M in (4, 64):
        # the kernel takes rows in eights: the decode step's 4 rows come
        # zero-padded, as kernels.ops pads them
        x = torch.zeros(-(-M // 8) * 8, d, device=dev, dtype=torch.bfloat16)
        x[:M] = torch.randn(M, d, generator=gen, device=dev).bfloat16()

        def cu():
            return bmlp.bcsc_mlp_cuda(
                x, trip(wg, "col_ptr"), trip(wu, "col_ptr"),
                trip(wd, "col_ptr"), counts, d_ff=ff, n_out=d,
                activation="gelu")

        def plain():
            return bmlp.bcsc_mlp_plain(
                x, trip(wg, "col_ids"), trip(wu, "col_ids"),
                trip(wd, "col_ids"), counts, d_ff=ff, n_out=d,
                activation="gelu")
        judge(f"bcsc_mlp[gemma2: M={M}, gelu]",
              errors(cu()[:M], plain()[:M])[1],
              2e-3, "relative to max |out|: an fp32 sum in another order "
              "can flip the bf16 rounding of a hidden value, 2^-8 of it")
        if M == 4:
            lines.append(f"bcsc_mlp (gemma2: M 4, {d} -> {ff} -> {d}, gelu, "
                         f"{int(counts.sum())} real blocks): "
                         f"{time_ms(cu, flush):.4f} ms, plain "
                         f"{time_ms(plain, flush):.4f} ms")

    # ---- GEMM at the prefill's M: one 8192-token prompt
    for K, N, w in ((d, ff, wg), (ff, d, wd)):
        x = torch.randn(8192, K, generator=gen, device=dev).bfloat16()

        def cu():
            return bm.bcsc_matmul_cuda(x, w["blocks"], w["row_ids"],
                                       w["col_ptr"], n_out=N)

        def plain():
            return bm.bcsc_matmul_plain(x, w["blocks"], w["row_ids"],
                                        w["col_ids"], n_out=N)
        judge(f"bcsc_matmul[gemma2: 8192x{K}->{N}]", errors(cu(), plain())[1],
              1e-3, "relative to max |out|: tensor-core fp32 accumulation "
              "of the same bf16 products in another order")
        lines.append(f"bcsc_matmul (gemma2: M 8192, {K} -> {N}, "
                     f"{int(w['nnzb'])} blocks): {time_ms(cu, flush):.4f} ms,"
                     f" plain {time_ms(plain, flush):.4f} ms")
    for line in lines:
        log(f"  {line}")
    return lines


def band_pairs(S: int, window: int) -> int:
    """(query, key) pairs of a causal window over S positions."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def phase_kernels_dense(flush, judge, records):
    """Sliding-window attention at gemma2-2b local and qwen2.5-3b causal
    prefill shapes, and rs_matmul at the GeGLU up-projection's widths."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import local_attention as swa
    from repro_torch.kernels import rs_matmul as rs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    log("kernels: sliding-window attention and rs_matmul")
    for tag, (B, S, H, KV, D, window, cap) in {
            "gemma2-2b local": (1, 8192, 8, 4, 256, 4096, 50.0),
            "gemma2-2b global": (1, 8192, 8, 4, 256, 8192, 50.0),
            "qwen2.5-3b causal": (2, 512, 16, 2, 128, 512, 0.0)}.items():
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

    K, N = 2304, 9216
    w = (torch.randn(K, N, generator=gen, device=dev) / K ** 0.5).bfloat16()
    bias = torch.randn(N, generator=gen, device=dev)
    for M in (512, 8):
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()

        def cu():
            return rs.rs_matmul_cuda(x, w, bias=bias, activation="gelu")

        def plain():
            return rs.rs_matmul_plain(x, w, bias=bias, activation="gelu")
        abs_err, rel = errors(cu(), plain())
        judge(f"rs_matmul[M={M}]", rel, 1e-3,
              "relative to max |out|: fp32 tensor-core accumulation of the "
              "same bf16 products in another order")
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


def _serve(llm, requests, judge, tag, max_new, must_launch):
    """One ``LLM.stream`` run with the launch counts zeroed just before and
    read just after; checks every request's tokens. Returns (launch counts,
    phase stats, wall seconds)."""
    from repro_torch.kernels import ops
    vocab = llm.cfg.vocab_size
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    done = llm.stream(requests)
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
    steps = max(st["decode_steps"], 1)
    log(f"  {tag}: wall {wall:.2f} s; prefill {st['prefill_real_tokens']} "
        f"tokens in {st['prefill_batches']} batches, "
        f"{st['prefill_real_tokens'] / max(st['prefill_s'], 1e-9):.1f} "
        f"tokens/s; decode {generated} tokens in {st['decode_steps']} steps,"
        f" {generated / max(st['decode_s'], 1e-9):.1f} tokens/s; "
        f"preemptions {st['preemptions']}; launches {counts}; per decode "
        f"step {counts['paged_attention'] / steps:.1f} paged-attention and "
        f"{counts['bcsc_mlp'] / steps:.1f} fused-MLP launches; per prefill "
        f"batch {counts['sliding_window_attention'] / max(st['prefill_batches'], 1):.1f}"
        " sliding-window launches")
    return counts, st, wall


def _requests(cfg, lengths, max_new, arrivals):
    import torch
    from repro_torch.serve import StreamRequest
    gen_cpu = torch.Generator().manual_seed(SEED)
    return [StreamRequest(i, torch.randint(0, cfg.vocab_size, (n,),
                                           generator=gen_cpu).tolist(),
                          max_new, arrival=float(a))
            for i, (n, a) in enumerate(zip(lengths, arrivals))]


def _load(arch, plan_kw):
    """Full-width random weights from SEED, MLPs packed at 0.75, on the
    device behind ``LLM`` with a paged fp plan."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.plan import plan_for_scheduler
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import LLM
    from repro_torch.serve.sparse import sparsify_mlp_params

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
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30 if DEVICE == 'cuda' else 0:.2f}"
        " GiB on the card; "
        f"plan rows {plan.rows}, cache {plan.cache_len}, page "
        f"{plan.page_size}, {plan.num_pages} pages, fused MLP up to M "
        f"{plan.mlp_fused_m_max}")
    return llm


def phase_serve(judge):
    """Full-width, full-depth qwen2.5-3b through ``LLM.stream``: a paged fp
    pass on the default plan, then an int8 pass on the two-call MLP route.
    Returns the summed launch counts."""
    from repro_torch.core.plan import plan_for_scheduler
    from repro_torch.serve import LLM

    llm = _load(ARCH, dict(rows=8, cache_len=1024, page_size=64))
    cfg = llm.cfg
    _check_logits(llm, judge)
    _layer_errors(llm, judge)
    lens = [5, 37, 64, 130, 300, 511] * 2
    launches, _, _ = _serve(
        llm, _requests(cfg, lens, 32, [8 * (i // 4) for i in range(12)]),
        judge, "qwen fp pass", 32,
        ("sliding_window_attention", "paged_attention", "bcsc_mlp",
         "bcsc_matmul"))
    plan8 = dataclasses.replace(
        plan_for_scheduler(cfg, rows=8, cache_len=1024, page_size=64,
                           attn_path="paged", share_prefix=False,
                           kv_quant="int8", sync_every=8),
        mlp_fused_m_max=0)
    llm8 = LLM(cfg, llm.params, plan8, eos_id=-1, device=DEVICE)
    counts8, _, _ = _serve(llm8, _requests(cfg, [5, 130, 300, 511], 8,
                                           [0] * 4),
                           judge, "qwen int8 pass", 8,
                           ("paged_attention", "bcsc_gemv", "bcsc_matmul"))
    return {k: launches[k] + counts8[k] for k in launches}


def phase_serve_gemma(judge):
    """Full-width, full-depth gemma2-2b through ``LLM.stream``: long prompts
    (window-mode prefill in the local layers), decode past the window (the
    local rings wrap). Returns (launch counts, tokens/s line)."""
    llm = _load(GEMMA, GEMMA_PLAN)
    cfg, plan = llm.cfg, llm.plan
    _check_logits(llm, judge, GEMMA_CHECK, plan.tier(max(GEMMA_CHECK)))
    _layer_errors(llm, judge, GEMMA_CHECK, plan.tier(max(GEMMA_CHECK)))
    arrivals = [0, 0, 0, 8, 8, 8]
    counts, st, wall = _serve(
        llm, _requests(cfg, GEMMA_LENS, GEMMA_NEW, arrivals), judge,
        "gemma2 pass", GEMMA_NEW,
        ("sliding_window_attention", "paged_attention", "bcsc_mlp",
         "bcsc_matmul"))
    layers, n_global = cfg.num_layers, cfg.num_layers // 2
    judge.check("gemma2 pass: sliding-window launches per prefill batch",
                counts["sliding_window_attention"]
                == layers * st["prefill_batches"],
                f"{counts['sliding_window_attention']} = {layers} x "
                f"{st['prefill_batches']} batches")
    judge.check("gemma2 pass: paged-attention launches per decode step",
                counts["paged_attention"] == n_global * st["decode_steps"],
                f"{counts['paged_attention']} = {n_global} x "
                f"{st['decode_steps']} steps")
    judge.check("gemma2 pass: fused-MLP launches per decode step",
                counts["bcsc_mlp"] >= layers * st["decode_steps"],
                f"{counts['bcsc_mlp']} >= {layers} x {st['decode_steps']} "
                "steps (plus short prefills)")
    generated = len(GEMMA_LENS) * GEMMA_NEW
    rates = (f"gemma2-2b: prefill "
             f"{st['prefill_real_tokens'] / max(st['prefill_s'], 1e-9):.1f} "
             f"tokens/s ({st['prefill_real_tokens']} tokens, "
             f"{st['prefill_s']:.2f} s), decode "
             f"{generated / max(st['decode_s'], 1e-9):.1f} tokens/s "
             f"({generated} tokens, {st['decode_s']:.2f} s), wall "
             f"{wall:.2f} s")
    return counts, rates


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
        timed("kernels (gemma2 widths)", phase_kernels_gemma, flush, judge)
        timed("kernels (dense)", phase_kernels_dense, flush, judge, records)
        del flush
        launches = timed("serve qwen2.5-3b", phase_serve, judge)
        torch.cuda.empty_cache()
        g_counts, rates = timed("serve gemma2-2b", phase_serve_gemma, judge)
        launches = {k: launches[k] + g_counts[k] for k in launches}
        if judge.failures:
            raise SmokeFailure(f"checks failed: {judge.failures}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(rates)
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
