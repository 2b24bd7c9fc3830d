#!/usr/bin/env python3
"""Where a decode step, or a prefill, of the PyTorch/CUDA port spends its
time, on one GPU.

    python3 scripts/profile_decode_torch.py [--arch qwen2.5-3b] [--rows R]
                                            [--steps 8] [--mlp-source OLD.cu]
    python3 scripts/profile_decode_torch.py --arch gemma2-2b --prefill 8192
                                            [--gemm-source OLD.cu]

Builds a full-width model as ``chip_smoke.py`` does (random weights from
seed 0, MLPs packed at 0.75 block sparsity), prefills ``rows`` prompts of
ragged length into a paged fp pool (qwen2.5-3b: 8 rows of 5 to 900 tokens
in a 1024-token cache; gemma2-2b: 4 rows of 7 to 6000 tokens in an
8192-token cache, so its local rings have wrapped; mistral-nemo-12b: 8 rows
of 5 to 3500 tokens in a 4096-token cache; gemma3-12b: 4 rows of 7 to 7000
tokens in an 8192-token cache, past its 1024-token window), then runs decode steps
(the serving path's in-place step, ``serve.engine.DecodeLoop``: greedy
sampling, the EOS and budget masks and ``decoding.serve_step`` through the
block table) twice: eager, and as replays of the step captured as a CUDA
graph (``serve.graphs.StepGraph``), each on its own copy of the rows. For
each it reports:

* host wall time per step, synchronised at the end of the steps;
* from a ``torch.profiler`` trace of ``steps`` steps: device time per step by
  kernel name and by group, kernel launches per step, and the share of the
  step the device was busy (the rest is the host issuing work, or, for the
  graph, the gaps between its kernel nodes).

With ``--prefill N`` it profiles instead one prefill of a single N-token
prompt (``decoding.prefill_batched`` into the paged pool) and splits its
device time by kernel group: the BCSC GEMM, the fp32 epilogue and gate
around it (the device time between the start and the end of each MLP call,
from CUDA events, less the GEMM's), sliding-window attention, cuBLAS, and
the rest. ``--gemm-source`` names a ``bcsc_matmul.cu`` of an earlier design
with PR 13's C interface (``repro_bcsc_gemm(x, M, K, blocks, row_ids,
col_ptr, out, N, stream)``); it is built with nvcc into its own library
(namespace ``repro_variant``) and the prefill is profiled with it and with
the tree's GEMM in turns (variant, tree, tree, variant), in one process on
one card.

``--mlp-source`` (decode) names a ``bcsc_mlp.cu`` of an earlier design with
the C interface ``repro_bcsc_mlp(x, Mp, K, gate, up, down triples, counts,
act, d_ff, n_out, hidden, out, barrier, stream)``, the barrier one zeroed
word a call; it is built like ``--gemm-source``'s (namespace
``repro_variant_mlp``) and the decode step is profiled with it and with the
tree's fused MLP in turns (variant, tree, tree, variant), eager; the
graphed step is the tree's. Each turn runs its own steps, so the contexts
grow by a few tokens from one to the next.

The last line is a JSON object with the same numbers.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# arch -> (cache_len, prompt lengths of the rows, in turn)
SETUPS = {"qwen2.5-3b": (1024, (5, 37, 64, 130, 300, 511, 700, 900)),
          "gemma2-2b": (8192, (7, 1500, 4700, 6000)),
          "mistral-nemo-12b": (4096, (5, 300, 1000, 2000, 3500, 64, 511,
                                      3000)),
          "gemma3-12b": (8192, (7, 1500, 4100, 7000))}
GROUPS = (   # kernel-name fragment -> group, first match wins
    ("paged_attention", "paged attention (port)"),
    ("swa_kernel", "sliding-window attention (port)"),
    ("bcsc_mlp", "fused BCSC MLP (port)"),
    ("bcsc_g", "BCSC GEMM/GEMV (port)"),
    ("gemm", "dense matmul (cuBLAS)"), ("gemv", "dense matmul (cuBLAS)"),
    ("nvjet", "dense matmul (cuBLAS)"),
    ("xmma", "dense matmul (cuBLAS)"), ("cutlass", "dense matmul (cuBLAS)"),
    ("reduce", "reductions"), ("index", "gather/scatter"),
    ("scatter", "gather/scatter"), ("gather", "gather/scatter"),
    ("elementwise", "elementwise"), ("Memset", "memset/memcpy"),
    ("Memcpy", "memset/memcpy"),
)


def group_of(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other"


def kernel_times(prof) -> dict:
    """Device time (us) and launches of a profile, by kernel name."""
    import torch
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total
            k[1] += 1
    return kernels


def by_group(kernels: dict, n: int) -> dict:
    """{group: [ms, launches]} per ``n`` repetitions."""
    groups = {}
    for name, (t, c) in kernels.items():
        g = groups.setdefault(group_of(name), [0.0, 0])
        g[0] += t / 1e3 / n
        g[1] += c / n
    return groups


def variant_library(source: str, namespace: str, fn: str, argtypes):
    """``fn`` of ``source`` built with nvcc into ``build/`` under
    ``namespace`` (so its template symbols do not resolve to the tree's)."""
    from repro_torch.kernels import _build
    src = os.path.abspath(source)
    digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    lib_path = os.path.join(_build.BUILD_DIR, f"{namespace}-{digest}.so")
    if not os.path.exists(lib_path):
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        built = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-Drepro={namespace}", src, "-o", lib_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if built.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{built.stdout}")
    lib = ctypes.CDLL(lib_path)
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def variant_gemm(source: str):
    """A ``bcsc_matmul_cuda`` that launches the GEMM of ``source`` (the C
    interface without a workspace or plan: ``repro_bcsc_gemm(x, M, K,
    blocks, row_ids, col_ptr, out, N, stream)``), built into ``build/``
    under the namespace repro_variant."""
    import torch
    from repro_torch.kernels import _build
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = variant_library(source, "repro_variant", "repro_bcsc_gemm",
                         [P, I, I, P, P, P, P, I, P])

    def gemm(x, blocks, row_ids, col_ptr, *, n_out):
        M, K = x.shape
        out = torch.empty((M, n_out), dtype=torch.float32, device=x.device)
        code = fn(x.data_ptr(), M, K, blocks.data_ptr(), row_ids.data_ptr(),
                  col_ptr.data_ptr(), out.data_ptr(), n_out,
                  _build.stream_of(x))
        if code:
            raise RuntimeError(f"variant GEMM: CUDA error {code}")
        return out
    return gemm


def variant_mlp(source: str):
    """A ``bcsc_mlp_cuda`` that launches the fused MLP of ``source`` (the C
    interface with a zeroed barrier word a call, see the module docstring;
    the hidden and out allocated here), built into ``build/`` under the
    namespace repro_variant_mlp."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.epilogue import act_code
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = variant_library(source, "repro_variant_mlp", "repro_bcsc_mlp",
                         [P, I, I] + [P] * 10 + [I, I, I, P, P, P, P])

    def mlp(x, gate, up, down, counts, *, d_ff, n_out, activation=None):
        Mp, K = x.shape
        ptrs = []
        for pack in (gate, up, down):
            ptrs += [None] * 3 if pack is None else [t.data_ptr()
                                                    for t in pack]
        hidden = torch.empty((Mp, d_ff), dtype=torch.bfloat16,
                             device=x.device)
        out = torch.empty((Mp, n_out), dtype=torch.float32, device=x.device)
        barrier = torch.zeros((1,), dtype=torch.int32, device=x.device)
        code = fn(x.data_ptr(), Mp, K, *ptrs, counts.data_ptr(),
                  act_code(activation), d_ff, n_out, hidden.data_ptr(),
                  out.data_ptr(), barrier.data_ptr(), _build.stream_of(x))
        if code:
            raise RuntimeError(f"variant fused MLP: CUDA error {code}")
        return out
    return mlp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(SETUPS), default="qwen2.5-3b")
    ap.add_argument("--rows", type=int, default=None,
                    help="default: one row per prompt length of the arch")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--prefill", type=int, default=0, metavar="N",
                    help="profile one prefill of an N-token prompt instead")
    ap.add_argument("--gemm-source", default=None,
                    help="with --prefill: also profile the GEMM of this "
                         "bcsc_matmul.cu (PR 13's C interface), in turns")
    ap.add_argument("--mlp-source", default=None,
                    help="decode: also profile the fused MLP of this "
                         "bcsc_mlp.cu (the barrier-word C interface), in "
                         "turns")
    args = ap.parse_args()
    if args.gemm_source and not args.prefill:
        ap.error("--gemm-source needs --prefill")
    if args.mlp_source and args.prefill:
        ap.error("--mlp-source profiles the decode step, not --prefill")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("profile_decode_torch: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core.plan import plan_for_scheduler
    from repro_torch.models import decoding
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import DecodeLoop, refill_rows
    from repro_torch.serve.sparse import sparsify_mlp_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    cache_len, lens = SETUPS[args.arch]
    if args.prefill:
        if args.prefill > cache_len:
            ap.error(f"--prefill {args.prefill} > the cache of {cache_len}")
        lens = (args.prefill,)
    R = 1 if args.prefill else (args.rows or len(lens))
    params = tfm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    packed, _ = sparsify_mlp_params(params, cfg, sparsity=0.75)
    del params
    params = tfm.compute_copy(packed)
    del packed
    plan = plan_for_scheduler(cfg, rows=R, cache_len=cache_len, page_size=64,
                              attn_path="paged", share_prefix=False,
                              kv_quant="fp", sync_every=8)
    MP = plan.max_pages
    cache = decoding.init_paged_cache(cfg, R, plan.cache_len, R * MP,
                                      plan.page_size, "fp", device=dev)
    bt = torch.arange(R * MP, dtype=torch.int32, device=dev).reshape(R, MP)
    lengths = torch.tensor([lens[i % len(lens)] for i in range(R)],
                           dtype=torch.int32, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (R, plan.tier(int(lengths.max()))),
                         generator=torch.Generator(dev).manual_seed(1),
                         device=dev)
    pp = decoding.PagedPrefill(cache=cache, block_table_rows=bt,
                               slots=torch.arange(R, device=dev))

    def prefill():
        return decoding.prefill_batched(params, toks, lengths, cfg,
                                        plan.cache_len, plan=plan, paged=pp)
    if args.prefill:
        return profile_prefill(args, cfg, prefill, toks.shape[1])
    del cache, pp
    loops = {}
    for graphs in (False, True):
        # each mode on its own rows: the same prompts, prefilled into the
        # loop's own pool; budgets that outlast the run
        loop = DecodeLoop(cfg, params, plan, temperature=0.0, eos_id=-1,
                          device=dev, paged=True, sync_every=args.steps,
                          graphs=graphs)
        state = loop.start(0)
        table = loop.set_block_table(bt.cpu().numpy())
        refill_rows(params, cfg, plan, state, toks, lengths,
                    list(range(R)), [cache_len] * R, block_table=table)
        loops[graphs] = loop
    torch.cuda.synchronize()

    from repro_torch.kernels import bcsc_mlp as bmlp
    mlps = {"tree": bmlp.bcsc_mlp_cuda}
    order = ["tree"]
    if args.mlp_source:
        mlps["variant"] = variant_mlp(args.mlp_source)
        order = ["variant", "tree", "tree", "variant"]
    print(f"device: {torch.cuda.get_device_name(0)}; {args.arch}, rows {R}, "
          f"lengths {lengths.tolist()}")
    runs = []
    try:
        for label in order:
            bmlp.bcsc_mlp_cuda = mlps[label]
            runs.append(profile_steps(loops[False].step, args.steps,
                                      f"eager step, {label} fused MLP"))
    finally:
        bmlp.bcsc_mlp_cuda = mlps["tree"]
    graph = loops[True].graph
    print(f"step graph: {sum(graph.tally.values())} kernel launches "
          f"captured, {graph.capture_s:.2f} s to warm up and capture")
    graphed = profile_steps(loops[True].step, args.steps,
                            "graphed step, tree fused MLP")
    last = runs[-1] if len(runs) == 1 else runs[1]   # the tree's first turn
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "arch": args.arch,
        "rows": R, "wall_ms_per_step": last["wall_ms"],
        "device_busy_ms_per_step": last["busy_ms"],
        "launches_per_step": last["launches"],
        "groups_ms_per_step": last["groups_ms"],
        "graphed": dict(graphed, capture_s=graph.capture_s),
        "runs": runs}))
    return 0


def profile_steps(step, n: int, label: str) -> dict:
    """Wall time of ``n`` decode steps after 3 warm-up steps, then a
    profile of ``n`` more: device time by kernel group and launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = kernel_times(prof)
    busy_ms = sum(t for t, _ in kernels.values()) / 1e3 / n
    launches = sum(c for _, c in kernels.values()) / n
    groups = by_group(kernels, n)
    print(f"[{label}] decode step: wall {wall_ms:.3f} ms (host "
          f"clock), device busy {busy_ms:.3f} ms in {launches:.0f} launches "
          f"({busy_ms / wall_ms:.1%} busy, traced steps)")
    for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:28s} {t:8.3f} ms/step  {c:7.1f} launches/step")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, c) in top:
        print(f"  {t / 1e3 / n:8.3f} ms/step {c / n:7.1f}x  {name[:90]}")
    return {"run": label, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "launches": launches,
            "groups_ms": {g: t for g, (t, _) in groups.items()}}


def profile_prefill(args, cfg, prefill, tier: int) -> int:
    """Profile ``prefill`` (one row, ``args.prefill`` real tokens padded to
    ``tier``) with the tree's GEMM, and in turns with ``--gemm-source``'s."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import bcsc_matmul as bm
    from repro_torch.models import layers
    gemms = {"tree": bm.bcsc_matmul_cuda}
    order = ["tree"]
    if args.gemm_source:
        gemms["variant"] = variant_gemm(args.gemm_source)
        order = ["variant", "tree", "tree", "variant"]
    mlp, spans = layers.mlp, []

    def timed_mlp(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = mlp(*a, **kw)
        end.record()
        spans.append((start, end))
        return y
    print(f"device: {torch.cuda.get_device_name(0)}; {args.arch}, one "
          f"prefill of {args.prefill} tokens (tier {tier})")
    results = []
    try:
        for label in order:
            bm.bcsc_matmul_cuda = gemms[label]
            prefill()                           # warm-up (builds, caches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            layers.mlp = timed_mlp
            spans.clear()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prefill()
                torch.cuda.synchronize()
            layers.mlp = mlp
            mlp_ms = sum(s.elapsed_time(e) for s, e in spans)
            kernels = kernel_times(prof)
            groups = by_group(kernels, 1)
            gemm_ms = groups.get("BCSC GEMM/GEMV (port)", [0.0, 0])[0]
            busy_ms = sum(t for t, _ in kernels.values()) / 1e3
            split = {"BCSC GEMM (port)": gemm_ms,
                     "fp32 epilogue and gate (MLP span less the GEMM)":
                         mlp_ms - gemm_ms}
            for g in ("sliding-window attention (port)",
                      "dense matmul (cuBLAS)"):
                split[g] = groups.get(g, [0.0, 0])[0]
            split["other"] = busy_ms - sum(split.values())
            print(f"[{label}] prefill: wall {wall_ms:.3f} ms (host clock, "
                  f"untraced), device busy {busy_ms:.3f} ms in "
                  f"{sum(c for _, c in kernels.values())} launches, "
                  f"{args.prefill / wall_ms * 1e3:.1f} tokens/s")
            for g, t in split.items():
                print(f"  {g:48s} {t:9.3f} ms  {t / busy_ms:6.1%}")
            for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
                print(f"    by name: {g:28s} {t:9.3f} ms  {c:5.0f} launches")
            results.append({"gemm": label, "wall_ms": wall_ms,
                            "device_busy_ms": busy_ms, "mlp_span_ms": mlp_ms,
                            "split_ms": split})
    finally:
        bm.bcsc_matmul_cuda = gemms["tree"]
        layers.mlp = mlp
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "arch": args.arch, "prefill_tokens": args.prefill,
                      "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
