#!/usr/bin/env python3
"""What holds the BCSC GEMV, the fused BCSC MLP and rs_matmul back, by
ablation on one GPU, and the tree's kernels against an earlier tree's.

    python3 scripts/ablate_kernels_torch.py [--reps 10] [--parent DIR]

Each variant is the tree's ``csrc/bcsc_matmul.cu``, ``csrc/bcsc_mlp.cu`` or
``csrc/rs_matmul.cu`` with a part removed or changed (named text edits of
the source or of its copy of ``common.cuh``), built by nvcc into a library
of its own (``-Drepro=repro_ablate_<n>``, so that no variant resolves
another's template symbols), all builds started together. Every variant is
timed beside the unchanged kernel in one process, at the shapes
``chip_smoke.py`` times (the GEMV at qwen2.5-3b's up projection with bias +
silu and its down projection, M 8; the fused MLP at qwen2.5-3b's M 8 and
64 and gemma2-2b's M 8; rs_matmul at 512 x 2304 -> 9216 with bias +
tanh-gelu, its streaming arm at M 8), with ``chip_smoke.time_ms``: device
time, L2 flushed before each launch, the card held busy while the host
enqueues. A variant that removes work computes a wrong result; only the
unchanged kernel is held against its plain version.

``--parent DIR``: an earlier tree unpacked into DIR (``git archive``); its
GEMV, fused MLP and sliding-window sources are built the same way and timed
in turns with the tree's (parent, tree, tree, parent), the sliding window
at gemma2-2b's local and qwen2.5-3b's causal prefill shapes. The last line
is a JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "build", "ablate")

_P1 = ("for (int c = (warp >> 1) * gridDim.x + blockIdx.x; c < d_ff / 16;",
       "for (int c = d_ff; c < d_ff / 16;")
_P2 = ("for (int task = gw; task < tasks; task += n_warps) {",
       "for (int task = tasks; task < tasks; task += n_warps) {")
_PREFETCH = ("  walk.prefetch_blocks();\n", "\n")
_BARRIER = ("  grid_barrier(words);\n", "\n")
# name -> (edits, thread blocks an SM)
MLP_VARIANTS = {
    "tree": ([], 1),
    "no phase 1 (hidden columns)": ([_P1], 1),
    "no phase 2 (down projection)": ([_P2, _PREFETCH], 1),
    "launch, index loads and grid barrier only": ([_P1, _P2, _PREFETCH], 1),
    "launch and index loads only": ([_P1, _P2, _PREFETCH, _BARRIER], 1),
    "rings of 8 slots at 8 rows (16 in the tree)": (
        [("NT == 1 ? 16 :", "NT == 1 ? 8 :")], 1),
    "no in-order sum of the down parts": (
        [("if (!__shfl_sync(0xffffffffu, last, 0)) continue;",
          "if (true) continue;")], 1),
    "two blocks of 8 warps an SM (one of 16 in the tree)": (
        [("constexpr int kMlpWarps = 16;", "constexpr int kMlpWarps = 8;"),
         ("constexpr int kMlpBlocksPerSm = 1;",
          "constexpr int kMlpBlocksPerSm = 2;")], 2),
}
_LOADS = ("""        mbar_arrive_expect(&full[st], kRsStageBytes);
        tma_load_2d(xs, &tm_x, kt * kRsBK, m0, &full[st]);
#pragma unroll
        for (int b = 0; b < kRsBN / 64; ++b)
          tma_load_2d(ws + b * kRsWBox, &tm_w, n0 + 64 * b, kt * kRsBK,
                      &full[st]);""", """        mbar_arrive(&full[st]);
        (void)xs;
        (void)ws;
        (void)m0;
        (void)n0;""")
RS_VARIANTS = {
    "tree": [],
    "no loads (the producer arrives, copies nothing)": [_LOADS],
    "no products (no wgmma)": [
        ("        wgmma_tb(acc, sw128_desc(xs + kk * 32, 16, 1024),\n"
         "                 sw128_desc(ws + kk * 16 * 128, kRsWBox, 1024));",
         "        ;")],
    "no epilogue stores (the tile is staged, not stored)": [
        ("      for (int row = e; row < kRsBM; row += kRsEpiWarps)",
         "      for (int row = kRsBM; row < kRsBM; row += kRsEpiWarps)")],
    "3 ring stages (4 in the tree)": [
        ("constexpr int kRsStages = 4;", "constexpr int kRsStages = 3;")],
    "the last round of tiles not split in K": [
        ("  if (parts < 2) parts = 1;", "  parts = 1;")],
    "no loads, no epilogue stores": [
        _LOADS, ("      for (int row = e; row < kRsBM; row += kRsEpiWarps)",
                 "      for (int row = kRsBM; row < kRsBM; "
                 "row += kRsEpiWarps)")],
}
_NO_WALK = ("  walk.prefetch_blocks();   // the blocks need no row id\n"
            "  walk.run(x, K, kGemvRows, true, acc, unused);\n",
            "  acc[0][0] = acc[0][1] = acc[0][2] = acc[0][3] = 0.0f;\n"
            "  (void)walk;\n  (void)unused;\n")
_NO_ADD = ("    for (int s2 = 1; s2 < split; ++s2) {",
           "    for (int s2 = split; s2 < split; ++s2) {")
GEMV_VARIANTS = {
    "tree": [],
    "the launch only (every thread returns at once)": [
        ("  extern __shared__ __align__(128) unsigned char smem[];\n"
         "  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;\n",
         "  extern __shared__ __align__(128) unsigned char smem[];\n"
         "  if (K > 0) return;\n"
         "  const int lane = threadIdx.x & 31, s = threadIdx.x >> 5;\n")],
    "no walk (launch, x prefetch, bias loads, combine, stores)": [_NO_WALK],
    "partials not added (part 0 stores its own)": [_NO_ADD],
    "no prefetch of x into L2": [
        ("  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < x_lines;",
         "  for (int i = x_lines; i < x_lines;")],
    "rings of 2 slots (4 in the tree)": [
        ("constexpr int kGemvStages = 4;", "constexpr int kGemvStages = 2;")],
    "rings of 8 slots (4 in the tree)": [
        ("constexpr int kGemvStages = 4;", "constexpr int kGemvStages = 8;")],
}
# the GEMV variants that still compute the function
GEMV_CORRECT = ("tree", "no prefetch of x into L2",
                "rings of 2 slots (4 in the tree)",
                "rings of 8 slots (4 in the tree)")
# the parent tree's C interface of the GEMV: no workspace, words or split
PARENT_GEMV_ARGS = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 \
    + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
RS_STREAM_VARIANTS = {
    "tree": [],
    "no combine kernel (the K parts are not added)": [
        ("    if (e != cudaSuccess || nk == 1) return (int)e;",
         "    return (int)e;")],
}


def build(jobs):
    """{key: (path of the source, edits)} -> {key: loaded library}. Each
    variant is built in a directory of its own beside a copy of the
    source's ``common.cuh``; an edit applies to whichever of the two holds
    its target."""
    from repro_torch.kernels import _build
    procs = {}
    for i, (key, (source, edits)) in enumerate(jobs.items()):
        files = {"src": open(source).read(),
                 "common.cuh": open(os.path.join(os.path.dirname(source),
                                                 "common.cuh")).read()}
        for old, new in edits:
            where = [k for k, text in files.items() if old in text]
            if not where:
                raise RuntimeError(f"{key}: edit target not in {source} or "
                                   f"its common.cuh: {old[:60]!r}")
            files[where[0]] = files[where[0]].replace(old, new)
        vdir = os.path.join(OUT, f"v{i}")
        os.makedirs(vdir, exist_ok=True)
        with open(os.path.join(vdir, "common.cuh"), "w") as f:
            f.write(files["common.cuh"])
        path = os.path.join(vdir, "kernel.cu")
        with open(path, "w") as f:
            f.write(files["src"])
        procs[key] = (path, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-Drepro=repro_ablate_{i}", path, "-o", path[:-3] + ".so"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n{log}")
        libs[key] = ctypes.CDLL(path[:-3] + ".so")
    return libs


def c_function(lib, name):
    from repro_torch.kernels import _build
    fn = getattr(lib, name)
    fn.argtypes = _build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--parent", default=None,
                    help="an earlier tree, unpacked: its GEMV, fused MLP and "
                         "sliding window are timed in turns with the tree's")
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if not torch.cuda.is_available():
        print("ablate_kernels_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import bcsc_matmul as bm
    from repro_torch.kernels import bcsc_mlp as bmlp
    from repro_torch.kernels import local_attention as swa
    from repro_torch.kernels import rs_matmul as rs
    from repro_torch.kernels.epilogue import act_code

    def src(name):
        return os.path.join(CSRC, name)
    jobs = {("gemv", k): (src("bcsc_matmul.cu"), e)
            for k, e in GEMV_VARIANTS.items()}
    jobs.update({("mlp", k): (src("bcsc_mlp.cu"), e) for k, (e, _) in
                 MLP_VARIANTS.items()})
    jobs.update({("rs", k): (src("rs_matmul.cu"), e)
                 for k, e in RS_VARIANTS.items()})
    jobs.update({("stream", k): (src("rs_matmul.cu"), e)
                 for k, e in RS_STREAM_VARIANTS.items() if k != "tree"})
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "src",
                            "repro_torch", "kernels", "csrc")
        for key, name in (("gemv", "bcsc_matmul.cu"), ("mlp", "bcsc_mlp.cu"),
                          ("swa", "local_attention.cu")):
            jobs[("parent", key)] = (os.path.join(pdir, name), [])
        jobs[("swa", "tree")] = (src("local_attention.cu"), [])
    libs = build(jobs)
    dev = torch.device("cuda")
    n_sm = _build.sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {card}")
    result = {"device": torch.cuda.get_device_name(0), "card": card,
              "bcsc_gemv": {}, "bcsc_mlp": {}, "rs_matmul": {},
              "sliding_window_attention": {}}

    def timed(fn):
        return cs.time_ms(fn, flush, reps=args.reps)

    class ReadFlush:
        """A flush that reads the buffer: L2 is left full of clean lines
        (chip_smoke's zeroing leaves it full of dirty ones, whose
        write-backs a kernel that brings lines into L2 pays)."""
        def zero_(self):
            flush.view(torch.int32).sum()

    def timed_clean(fn):
        return cs.time_ms(fn, ReadFlush(), reps=args.reps)

    def show(kernel, tag, row):
        print(f"{kernel} {tag}:")
        for name, v in row.items():
            print(f"  {name:58s} {v:.4f}" + (" ms" if "error" not in name
                                             else " of max |out|"))

    # ---- the GEMV: variants of the tree's, the tree's at split 1 (one
    # warp a column), and the parent's, at the int8 pass's two shapes
    gen_v = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    for tag, K, N, act in (("qwen2.5-3b up, bias + silu", 2048, 11008,
                            "silu"),
                           ("qwen2.5-3b down", 11008, 2048, None)):
        w = cs._packed_weight(K, N, 0.75, gen_v)
        x = torch.randn(8, K, generator=gen_v, device=dev).bfloat16()
        bias = torch.randn(N, generator=gen_v, device=dev) if act else None
        out = torch.empty(8, N, device=dev)
        split = bm.gemv_plan(K, N, n_sm)["split"]
        want = bm.bcsc_gemv_plain(x, w["blocks"], w["row_ids"], w["col_ids"],
                                  n_out=N, bias=bias, activation=act)
        pack = (w["blocks"].data_ptr(), w["row_ids"].data_ptr(),
                w["col_ptr"].data_ptr())
        runs = [(k, libs[("gemv", k)], split) for k in GEMV_VARIANTS]
        for other in sorted({1, max(1, split // 2),
                             min(bm.GEMV_MAX_SPLIT, 2 * split)} - {split}):
            runs.insert(1, (f"tree at split {other} ({split} planned)",
                            libs[("gemv", "tree")], other))
        if args.parent:
            # a parent whose GEMV takes the split gets the tree's; an
            # earlier one has no split argument (split 0 below)
            psplit = split if "int split, void* stream" in open(
                jobs[("parent", "gemv")][0]).read() else 0
            runs = [("parent", libs[("parent", "gemv")], psplit)] + runs + [
                ("parent, again", libs[("parent", "gemv")], psplit)]
        row = {}
        for name, lib, sp in runs:
            if sp == 0:
                fn = getattr(lib, "repro_bcsc_gemv")
                fn.argtypes, fn.restype = PARENT_GEMV_ARGS, ctypes.c_int

                def call(fn=fn):
                    _build.check(fn(
                        x.data_ptr(), K, *pack, _build.ptr(bias),
                        act_code(act), out.data_ptr(), N,
                        _build.stream_of(x)), f"bcsc_gemv {name}")
            else:
                fn = c_function(lib, "repro_bcsc_gemv")

                def call(fn=fn, sp=sp):
                    _build.check(fn(
                        x.data_ptr(), K, *pack, _build.ptr(bias),
                        act_code(act), out.data_ptr(), N, sp,
                        _build.stream_of(x)), f"bcsc_gemv {name}")
            row[name] = timed(call)
            if name in GEMV_CORRECT or name not in GEMV_VARIANTS:
                call()
                row[f"{name}: error"] = cs.errors(out, want)[1]
            if name in ("tree", "parent"):
                row[f"{name}, L2 flushed by reading"] = timed_clean(call)
        wdense = bm._dense_weight(w["blocks"], w["row_ids"], w["col_ids"], K,
                                  N).bfloat16()
        if act:
            def library():
                torch.nn.functional.silu(torch.addmm(bias.bfloat16(), x,
                                                     wdense))
        else:
            def library():
                torch.matmul(x, wdense)
        row["library (addmm + silu, or matmul)"] = timed(library)
        row["library, L2 flushed by reading"] = timed_clean(library)
        nnz = int(w["nnzb"])
        row["bound"] = cs.bound(x.numel() * 2 + nnz * cs.BLOCK_BYTES
                                + (4 * N if act else 0) + 32 * N,
                                2 * 8 * 256 * nnz)[0]
        result["bcsc_gemv"][tag] = row
        show("bcsc_gemv", f"{tag} (M 8, {K} -> {N}, {nnz} blocks, split "
             f"{split})", row)

    for arch, K, ff, Ms, act in (("qwen2.5-3b", 2048, 11008, (8, 64), "silu"),
                                 ("gemma2-2b", 2304, 9216, (8,), "gelu")):
        packs = [cs._packed_weight(k, n, 0.75, gen)
                 for k, n in ((K, ff), (K, ff), (ff, K))]
        counts = torch.stack([p["nnzb"] for p in packs])
        ptrs = [t.data_ptr() for p in packs
                for t in (p["blocks"], p["row_ids"], p["col_ptr"])]
        plan = bmlp.mlp_plan(ff, K, n_sm)
        for M in Ms:
            x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
            hidden = torch.empty(M, ff, dtype=torch.bfloat16, device=dev)
            out = torch.empty(M, K, device=dev)
            ws = torch.empty((K // 16) * plan["split"] * bmlp.row_tiles(M)
                             * 128, device=dev)
            row = {}
            runs = [(name, libs[("mlp", name)], per_sm)
                    for name, (_, per_sm) in MLP_VARIANTS.items()]
            if args.parent:
                runs = [("parent", libs[("parent", "mlp")], 1)] + runs + [
                    ("parent, again", libs[("parent", "mlp")], 1)]
            for name, lib, per_sm in runs:
                fn = c_function(lib, "repro_bcsc_mlp")
                words = torch.zeros(2 + K // 16, dtype=torch.int32,
                                    device=dev)

                def call(fn=fn, words=words, grid=per_sm * n_sm):
                    _build.check(fn(
                        x.data_ptr(), M, K, *ptrs, counts.data_ptr(),
                        act_code(act), ff, K, hidden.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), words.data_ptr(),
                        grid, plan["split"], _build.stream_of(x)),
                        f"bcsc_mlp variant {name}")
                row[name] = timed(call)
                if name == "tree":
                    call()
                    want = bmlp.bcsc_mlp_plain(
                        x, *[(p["blocks"], p["row_ids"], p["col_ids"])
                             for p in packs], counts, d_ff=ff, n_out=K,
                        activation=act)
                    row["tree error"] = cs.errors(out, want)[1]
            tag = f"{arch} M {M}"
            result["bcsc_mlp"][tag] = row
            print(f"bcsc_mlp {tag} (error {row['tree error']:.1e}):")
            for name, ms in row.items():
                if name != "tree error":
                    print(f"  {name:58s} {ms:.4f} ms")

    K, N = 2304, 9216
    w = (torch.randn(K, N, generator=gen, device=dev) / K ** 0.5).bfloat16()
    bias = torch.randn(N, generator=gen, device=dev)
    for M, group, variants in ((512, "rs", RS_VARIANTS),
                               (8, "stream", RS_STREAM_VARIANTS)):
        x = torch.randn(M, K, generator=gen, device=dev).bfloat16()
        out = torch.empty(M, N, device=dev)
        part = torch.empty(-(-K // rs.STREAM_K) * M * N, device=dev)
        row = {}
        for name in variants:
            lib = libs[("rs", "tree") if name == "tree" else (group, name)]
            fn = c_function(lib, "repro_rs_matmul")

            def call(fn=fn):
                _build.check(fn(x.data_ptr(), K, w.data_ptr(), N,
                                bias.data_ptr(), act_code("gelu"),
                                out.data_ptr(), 0, M, K, N, part.data_ptr(),
                                _build.stream_of(x)),
                             f"rs_matmul variant {name}")
            row[name] = timed(call)
            if name == "tree":
                call()
                want = rs.rs_matmul_plain(x, w, bias=bias, activation="gelu")
                row["tree error"] = cs.errors(out, want)[1]
        row["addmm + gelu"] = timed(lambda: torch.nn.functional.gelu(
            torch.addmm(bias.bfloat16(), x, w), approximate="tanh"))
        tag = f"M {M}, {K} -> {N}, bias + tanh-gelu"
        result["rs_matmul"][tag] = row
        print(f"rs_matmul {tag} (error {row['tree error']:.1e}):")
        for name, ms in row.items():
            if name != "tree error":
                print(f"  {name:58s} {ms:.4f} ms")

    # ---- the sliding window, parent and tree in turns, at the served
    # ratios (gemma2-2b local R 2, qwen2.5-3b causal R 8)
    if args.parent:
        for tag, (B, S, H, KV, D, window, cap) in {
                "gemma2-2b local": (1, 8192, 8, 4, 256, 4096, 50.0),
                "qwen2.5-3b causal": (2, 512, 16, 2, 128, 512, 0.0)}.items():
            q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
            k = torch.randn(B, S, KV, D, generator=gen,
                            device=dev).bfloat16()
            v = torch.randn(B, S, KV, D, generator=gen,
                            device=dev).bfloat16()
            out = torch.empty(B, S, H, D, device=dev)
            row = {}
            for name, key in (("parent", "parent"), ("tree", "tree"),
                              ("tree, again", "tree"),
                              ("parent, again", "parent")):
                path = jobs[(key, "swa") if key == "parent"
                            else ("swa", "tree")][0]
                fn = getattr(libs[(key, "swa")] if key == "parent"
                             else libs[("swa", "tree")],
                             "repro_sliding_window_attention")
                # a source from before the chunk mode takes no chunk, one
                # from before the lse output no lse pointer (null: unwritten)
                text = open(path).read()
                chunked = "int window, int chunk" in text
                with_lse = "void* lse" in text
                P, I = ctypes.c_void_p, ctypes.c_int
                fn.argtypes = [P] * (5 if with_lse else 4) \
                    + [I] * (7 if chunked else 6) \
                    + [ctypes.c_float, ctypes.c_float, P]
                fn.restype = ctypes.c_int

                def call(fn=fn, chunk=(0,) if chunked else (),
                         lse=(None,) if with_lse else ()):
                    _build.check(fn(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), *lse, B, S, H, KV, D, window, *chunk,
                        swa._score_mult(D, cap), cap, _build.stream_of(q)),
                        "sliding_window_attention")
                row[name] = timed(call)
            result["sliding_window_attention"][tag] = row
            show("sliding_window_attention", tag, row)
            del q, k, v, out
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
