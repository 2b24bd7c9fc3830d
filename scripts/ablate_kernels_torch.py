#!/usr/bin/env python3
"""What holds the fused BCSC MLP and rs_matmul back, by ablation on one GPU.

    python3 scripts/ablate_kernels_torch.py [--reps 10]

Each variant is the tree's ``csrc/bcsc_mlp.cu`` or ``csrc/rs_matmul.cu``
with a part removed or changed (a named text edit of the source), built by
nvcc into a library of its own (``-Drepro=repro_ablate_<n>``, so that no
variant resolves another's template symbols), all builds started together.
Every variant is timed beside the unchanged kernel in one process, at the
shapes ``chip_smoke.py`` times (the fused MLP at qwen2.5-3b's M 8 and 64 and
gemma2-2b's M 8; rs_matmul at 512 x 2304 -> 9216 with bias + tanh-gelu, its
streaming arm at M 8), with ``chip_smoke.time_ms``: device time, L2 flushed
before each launch, the card held busy while the host enqueues. A variant
that removes work computes a wrong result; only the unchanged kernel is
held against its plain version. The last line is a JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
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
RS_STREAM_VARIANTS = {
    "tree": [],
    "no combine kernel (the K parts are not added)": [
        ("    if (e != cudaSuccess || nk == 1) return (int)e;",
         "    return (int)e;")],
}


def build(jobs):
    """{key: (name of the source, edits)} -> {key: loaded library}."""
    from repro_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    shutil.copy(os.path.join(CSRC, "common.cuh"), OUT)
    procs = {}
    for i, (key, (source, edits)) in enumerate(jobs.items()):
        text = open(os.path.join(CSRC, source)).read()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{key}: edit target not in {source}: "
                                   f"{old[:60]!r}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text)
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
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    if not torch.cuda.is_available():
        print("ablate_kernels_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import bcsc_mlp as bmlp
    from repro_torch.kernels import rs_matmul as rs
    from repro_torch.kernels.epilogue import act_code

    jobs = {("mlp", k): ("bcsc_mlp.cu", e) for k, (e, _) in
            MLP_VARIANTS.items()}
    jobs.update({("rs", k): ("rs_matmul.cu", e)
                 for k, e in RS_VARIANTS.items()})
    jobs.update({("stream", k): ("rs_matmul.cu", e)
                 for k, e in RS_STREAM_VARIANTS.items() if k != "tree"})
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
              "bcsc_mlp": {}, "rs_matmul": {}}

    def timed(fn):
        return cs.time_ms(fn, flush, reps=args.reps)

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
            for name, (_, per_sm) in MLP_VARIANTS.items():
                fn = c_function(libs[("mlp", name)], "repro_bcsc_mlp")
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
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
