#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. device: require CUDA (no CPU fallback); print the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compile the port's CUDA kernels from the sources in this checkout
   (one nvcc per source, all started together);
3. kernels: hold each kernel against its plain PyTorch version at full-width
   qwen2.5-3b shapes, with the tolerance stated beside each, and time the
   kernel, the plain version and, where one exists, the single PyTorch call
   that computes the same function (CUDA events, L2 flushed before each
   launch);
4. serve: full-width, full-depth qwen2.5-3b with random weights from a seed,
   MLPs packed at 0.75 block sparsity. First the first prefill and decode
   logits of the kernel path are held against the plain path; then 12
   requests go through ``LLM.stream`` on paged fp KV (launch counts zeroed
   just before, read just after: paged attention, the fused MLP and the
   GEMM must have run), then 4 requests on int8 KV pages with the two-call
   MLP route (the GEMV and GEMM arms); every request must return its budget
   of in-vocabulary tokens;
5. report: prefill and decode tokens/s, one JSON line describing every
   kernel, the card's name and power limit, then the contract line.

Exits non-zero, printing no result, when there is no CUDA device or when run
outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16 tensor cores
SEED = 0
ARCH = "qwen2.5-3b"
# the serve phase's device and model; a CPU rehearsal of its control flow
# sets DEVICE = "cpu" and ARCH = "qwen2.5-3b-reduced" before phase_serve
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
    Warmed up first; CUDA events."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
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
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or "==" in line:
                log(f"  ptxas: {line.strip()}")


def _packed_weight(K, N, sparsity, gen):
    import torch
    from repro_torch.core import sparsity as sp
    from repro_torch.serve.sparse import pack_weight
    w = torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5
    return pack_weight(sp.block_magnitude_prune(w, sparsity, 16, 16), 16, 16,
                       torch.bfloat16)


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
        # library yardstick: SDPA over the pages gathered to dense K/V
        T = MP * ps
        pages = bt.clamp_min(0).long()
        kd = kw["k_pool"][pages].reshape(B, T, KV, D).permute(0, 2, 1, 3)
        vd = kw["v_pool"][pages].reshape(B, T, KV, D).permute(0, 2, 1, 3)
        kd = kd.repeat_interleave(R, 1).contiguous()
        vd = vd.repeat_interleave(R, 1).contiguous()
        qd = q.reshape(B, KV * R, 1, D)
        mask = (torch.arange(T, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        n_bytes = (q.numel() * 2 + 2 * tokens * KV * D * 2 + bt.numel() * 4
                   + B * 4 + B * KV * R * D * 4)
        records["paged_attention"] = dict(
            max_abs_err=abs_err,
            ms=time_ms(lambda: pa.paged_attention_cuda(*args), flush),
            plain_ms=time_ms(lambda: pa.paged_attention_plain(*args), flush),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qd, kd, vd, attn_mask=mask), flush),
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


def _check_logits(llm, judge):
    """The first prefill (two prompts at tier 64: M 128, the GEMM arm) and
    decode (M 2: the fused MLP, paged attention) logits of the kernel path
    against ``impl="plain"`` on the same weights and tokens."""
    import torch
    from repro_torch.models import decoding
    cfg, plan, dev = llm.cfg, llm.plan, llm.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    lengths = torch.tensor([37, 64], dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
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
        judge(f"{what} logits, kernels vs plain", errors(got, want)[1], 5e-2,
              "relative to max |logit| after 36 layers: sums in another "
              "order flip bf16 roundings, which the layers carry forward")


def _serve(llm, requests, judge, tag, max_new, must_launch):
    """One ``LLM.stream`` run with the launch counts zeroed just before and
    read just after; checks every request's tokens."""
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
    log(f"  {tag}: wall {wall:.2f} s; prefill {st['prefill_real_tokens']} "
        f"tokens in {st['prefill_batches']} batches, "
        f"{st['prefill_real_tokens'] / max(st['prefill_s'], 1e-9):.1f} "
        f"tokens/s; decode {generated} tokens in {st['decode_steps']} steps,"
        f" {generated / max(st['decode_s'], 1e-9):.1f} tokens/s; "
        f"preemptions {st['preemptions']}; launches {counts}; "
        f"per decode step {counts['paged_attention'] / max(st['decode_steps'], 1):.1f}"
        " paged-attention launches")
    return counts


def phase_serve(judge):
    """Full-width, full-depth qwen2.5-3b through ``LLM.stream``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.plan import plan_for_scheduler
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import LLM, StreamRequest
    from repro_torch.serve.sparse import sparsify_mlp_params

    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, gen, DEVICE)
    packed, stats = sparsify_mlp_params(params, cfg, sparsity=0.75)
    del params
    plan = plan_for_scheduler(cfg, rows=8, cache_len=1024, page_size=64,
                              attn_path="paged", share_prefix=False,
                              kv_quant="fp", sync_every=8)
    llm = LLM(cfg, packed, plan, eos_id=-1, device=DEVICE)
    del packed
    sync()
    log(f"serve: {ARCH}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"d_ff {cfg.d_ff}; MLPs packed at block density "
        f"{stats['block_density']:.3f} ({stats['kept_blocks']} blocks); "
        f"loaded in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30 if DEVICE == 'cuda' else 0:.2f}"
        " GiB on the card; "
        f"plan rows {plan.rows}, cache {plan.cache_len}, page "
        f"{plan.page_size}, {plan.num_pages} pages, fused MLP up to M "
        f"{plan.mlp_fused_m_max}")
    _check_logits(llm, judge)

    gen_cpu = torch.Generator().manual_seed(SEED)
    lens = [5, 37, 64, 130, 300, 511] * 2

    def requests(lengths, max_new, spacing):
        return [StreamRequest(i, torch.randint(0, cfg.vocab_size, (n,),
                                               generator=gen_cpu).tolist(),
                              max_new, arrival=float(spacing * (i // 4)))
                for i, n in enumerate(lengths)]
    launches = _serve(llm, requests(lens, 32, 8), judge, "fp pass", 32,
                      ("paged_attention", "bcsc_mlp", "bcsc_matmul"))
    plan8 = dataclasses.replace(
        plan_for_scheduler(cfg, rows=8, cache_len=1024, page_size=64,
                           attn_path="paged", share_prefix=False,
                           kv_quant="int8", sync_every=8),
        mlp_fused_m_max=0)
    llm8 = LLM(cfg, llm.params, plan8, eos_id=-1, device=DEVICE)
    counts8 = _serve(llm8, requests([5, 130, 300, 511], 8, 0), judge,
                     "int8 pass", 8,
                     ("paged_attention", "bcsc_gemv", "bcsc_matmul"))
    return {k: launches[k] + counts8[k] for k in launches}


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    try:
        import torch
        card = phase_device()
        phase_build()
        flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        judge, records = Judge(), {}
        phase_kernels(flush, judge, records)
        del flush
        launches = phase_serve(judge)
        if judge.failures:
            raise SmokeFailure(f"checks failed: {judge.failures}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
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
