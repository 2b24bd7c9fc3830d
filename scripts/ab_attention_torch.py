#!/usr/bin/env python3
"""The training attention kernels of this tree against an earlier tree's,
in turns on one GPU: the sliding window with its log-sum-exp and the flash
backward, over every row (the query offset 0).

    python3 scripts/ab_attention_torch.py --parent DIR [--reps 10]

``DIR`` holds an earlier tree unpacked with ``git archive``. Its
``csrc/local_attention.cu`` and ``csrc/flash_backward.cu`` and the tree's
are each built into a library of their own
(``scripts/ablate_kernels_torch.build``: ``-Drepro=repro_ablate_<n>``, all
builds started together) and timed at ``chip_smoke.BACKWARD_SHAPES`` with
``chip_smoke.time_ms`` (device time, L2 flushed before each launch), in
turns: parent, tree, tree, parent. The parent is called through the C
interface it had before the offset (``S`` for both lengths), the tree
through the one the port calls (``Sq = Sk = S``, offset 0); the tree's
outputs must equal the parent's bit for bit. The last line is a JSON
object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C interfaces before the query offset
PARENT_SIGNATURES = {
    "repro_sliding_window_attention": [P] * 5 + [I] * 7 + [F, F, P],
    "repro_flash_backward": [P] * 12 + [I] * 7 + [F, F, F, P],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT,
                    os.path.join(ROOT, "scripts")]
    import torch
    if not torch.cuda.is_available():
        print("ab_attention_torch: no CUDA device", file=sys.stderr)
        return 1
    import ablate_kernels_torch as ablate
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import local_attention as swa

    pdir = os.path.join(os.path.abspath(args.parent), "src", "repro_torch",
                        "kernels", "csrc")
    jobs = {(side, name): (os.path.join(d, name), [])
            for side, d in (("parent", pdir), ("tree", CSRC))
            for name in ("local_attention.cu", "flash_backward.cu")}
    libs = ablate.build(jobs)

    def fn(side, src, name):
        f = getattr(libs[(side, src)], name)
        f.argtypes = PARENT_SIGNATURES[name] if side == "parent" \
            else _build.SIGNATURES[name]
        f.restype = ctypes.c_int
        return f
    calls = {"parent": (fn("parent", "local_attention.cu",
                           "repro_sliding_window_attention"),
                        fn("parent", "flash_backward.cu",
                           "repro_flash_backward")),
             "tree": (fn("tree", "local_attention.cu",
                         "repro_sliding_window_attention_q"),
                      fn("tree", "flash_backward.cu",
                         "repro_flash_backward"))}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {card}")
    result = {"device": torch.cuda.get_device_name(0), "card": card,
              "shapes": {}}
    for tag, (B, S, H, KV, D, window, chunk, cap) in \
            cs.BACKWARD_SHAPES.items():
        q, k, v, dout = (torch.randn(B, S, n, D, generator=gen,
                                     device=dev).bfloat16()
                         for n in (H, KV, KV, H))
        f32 = dict(dtype=torch.float32, device=dev)
        bufs = {side: dict(out=torch.empty(B, S, H, D, **f32),
                           lse=torch.empty(B, S, H, **f32),
                           dq=torch.empty(B, S, H, D, **f32),
                           dk=torch.empty(B, S, KV, D, **f32),
                           dv=torch.empty(B, S, KV, D, **f32),
                           drow=torch.empty(B, S, H, **f32),
                           dkp=torch.empty(B, S, H, D, **f32),
                           dvp=torch.empty(B, S, H, D, **f32))
                for side in calls}
        mult, scale = swa._score_mult(D, cap), 1.0 / math.sqrt(D)
        w = min(window, S)
        stream = _build.stream_of(q)

        def forward(side):
            b = bufs[side]
            lens = (S,) if side == "parent" else (S, S, 0)
            _build.check(calls[side][0](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), b["out"].data_ptr(),
                b["lse"].data_ptr(), B, *lens, H, KV, D, w, chunk, mult, cap,
                stream), f"sliding_window_attention ({side})")

        forward("parent")       # the backward's inputs: the parent's
        out16 = bufs["parent"]["out"].bfloat16()
        lse = bufs["parent"]["lse"].clone()

        def backward(side):
            b = bufs[side]
            lens = (S,) if side == "parent" else (S, S, 0)
            _build.check(calls[side][1](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out16.data_ptr(),
                lse.data_ptr(), dout.data_ptr(), b["dq"].data_ptr(),
                b["dk"].data_ptr(), b["dv"].data_ptr(), b["drow"].data_ptr(),
                b["dkp"].data_ptr(), b["dvp"].data_ptr(), B, *lens, H, KV, D,
                w, chunk, mult, cap, scale, stream),
                f"flash_backward ({side})")

        for side in calls:
            forward(side)
            backward(side)
        torch.cuda.synchronize()
        same = all(torch.equal(bufs["parent"][n], bufs["tree"][n])
                   for n in ("out", "lse", "dq", "dk", "dv"))
        row = {"same bits": same}
        for kernel, run in (("forward with lse", forward),
                            ("backward", backward)):
            for name, side in (("parent", "parent"), ("tree", "tree"),
                               ("tree, again", "tree"),
                               ("parent, again", "parent")):
                row[f"{kernel}: {name}"] = cs.time_ms(
                    lambda: run(side), flush, reps=args.reps)
        result["shapes"][tag] = row
        print(f"{tag} (B {B}, S {S}, {H} / {KV} heads of {D}, window "
              f"{window}, chunk {chunk}, softcap {cap:g}); the tree's "
              f"outputs the parent's bits: {same}")
        for name, ms in row.items():
            if name != "same bits":
                print(f"  {name:32s} {ms:.4f} ms")
        del q, k, v, dout, bufs, out16, lse
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
