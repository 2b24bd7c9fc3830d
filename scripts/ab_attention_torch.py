#!/usr/bin/env python3
"""The training attention kernels of this tree against an earlier tree's,
in turns on one GPU: the sliding window with its log-sum-exp and the flash
backward, over every row (the query offset 0), beside the library calls
that compute the same functions.

    python3 scripts/ab_attention_torch.py --parent DIR [--reps 10]

``DIR`` holds an earlier tree unpacked with ``git archive``; its C
interface must be that of commit f6b1c98 (``PARENT_SIGNATURES``: the
backward with per-head dk / dv shares as scratch). Its
``csrc/local_attention.cu`` and ``csrc/flash_backward.cu`` and the tree's
are each built into a library of their own
(``scripts/ablate_kernels_torch.build``: ``-Drepro=repro_ablate_<n>``, all
builds started together) and timed at ``chip_smoke.BACKWARD_SHAPES`` with
``chip_smoke.time_ms`` (device time, L2 flushed before each launch), in
turns: parent, tree, tree, parent. The tree's forward with the lse must
give the parent's bits; the tree's backward (from the parent forward's
outputs) must agree with the parent's within 2e-3 of each output's max
|value|, the kernel-vs-plain tolerance (the two kernels sum in other
orders). Beside them, SDPA's backward alone
(``chip_smoke._sdpa_backward_ms``) where SDPA computes the same function
(no softcap) and, at gemma2-2b's local shape (a tanh softcap and a
sliding window), ``torch.nn.attention.flex_attention`` compiled with
``torch.compile`` (a tanh ``score_mod`` and a sliding-window causal
``block_mask``): its forward, and its backward alone with the forward's
graph kept, its output checked against the plain version. The last line
is a JSON object with the parent's, the tree's and the library times side
by side.
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
# the C interfaces of commit f6b1c98
PARENT_SIGNATURES = {
    "repro_sliding_window_attention_q": [P] * 5 + [I] * 9 + [F, F, P],
    "repro_flash_backward": [P] * 12 + [I] * 9 + [F, F, F, P],
}
FLEX_SHAPE = "gemma2-2b local"


def flex_attention_times(cs, q, k, v, dout, window, softcap, flush, reps):
    """(forward ms, backward-alone ms, forward error) of ``flex_attention``
    at these shapes, compiled; the error is max |out - plain| over max
    |plain| less the bf16 rounding of its output (half an ulp of each
    value), checked by the caller at 1e-3."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    from repro_torch.kernels import local_attention as swa
    S = q.shape[1]

    def tanh_cap(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def band(b, h, q_idx, kv_idx):
        return (kv_idx <= q_idx) & (q_idx - kv_idx < window)
    mask = create_block_mask(band, B=None, H=None, Q_LEN=S, KV_LEN=S,
                             device=q.device)
    flex = torch.compile(flex_attention)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))

    def forward():
        return flex(qt, kt, vt, score_mod=tanh_cap, block_mask=mask,
                    enable_gqa=True)
    with torch.no_grad():
        got = forward().transpose(1, 2).float()
    want = swa.sliding_window_attention_plain(q, k, v, window=window,
                                              softcap=softcap)
    over = ((got - want).abs() - want.abs() * 2.0 ** -8).clamp_min(0)
    err = float(over.max()) / float(want.abs().max())
    del got, want, over
    with torch.no_grad():
        fwd_ms = cs.time_ms(forward, flush, reps=reps)
    o = forward()
    do = dout.transpose(1, 2)
    bwd_ms = cs.time_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), do, retain_graph=True), flush, reps=reps)
    return fwd_ms, bwd_ms, err


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
    from repro_torch.kernels import flash_backward as fb
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
    calls = {side: (fn(side, "local_attention.cu",
                       "repro_sliding_window_attention_q"),
                    fn(side, "flash_backward.cu", "repro_flash_backward"))
             for side in ("parent", "tree")}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {card}")
    result = {"device": torch.cuda.get_device_name(0), "card": card,
              "shapes": {}}
    ok = True
    for tag, (B, S, H, KV, D, window, chunk, cap) in \
            cs.BACKWARD_SHAPES.items():
        q, k, v, dout = (torch.randn(B, S, n, D, generator=gen,
                                     device=dev).bfloat16()
                         for n in (H, KV, KV, H))
        f32 = dict(dtype=torch.float32, device=dev)
        w = min(window, S)
        lc = fb.launch_config(B, S, H, KV, D, window=w, chunk=chunk,
                              sms=_build.sm_count(0))
        bufs = {side: dict(out=torch.empty(B, S, H, D, **f32),
                           lse=torch.empty(B, S, H, **f32),
                           dq=torch.empty(B, S, H, D, **f32),
                           dk=torch.empty(B, S, KV, D, **f32),
                           dv=torch.empty(B, S, KV, D, **f32))
                for side in calls}
        scratch = {"parent": (torch.empty(B, S, H, **f32),
                              torch.empty(B, S, H, D, **f32),
                              torch.empty(B, S, H, D, **f32)),
                   "tree": (torch.empty(lc["ws_floats"], **f32),)}
        mult, scale = swa._score_mult(D, cap), 1.0 / math.sqrt(D)
        stream = _build.stream_of(q)

        def forward(side):
            b = bufs[side]
            _build.check(calls[side][0](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), b["out"].data_ptr(),
                b["lse"].data_ptr(), B, S, S, 0, H, KV, D, w, chunk, mult,
                cap, stream), f"sliding_window_attention ({side})")

        forward("parent")       # the backward's inputs: the parent's
        out16 = bufs["parent"]["out"].bfloat16()
        lse = bufs["parent"]["lse"].clone()

        def backward(side):
            b = bufs[side]
            groups = () if side == "parent" else (lc["groups"],)
            _build.check(calls[side][1](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out16.data_ptr(),
                lse.data_ptr(), dout.data_ptr(), b["dq"].data_ptr(),
                b["dk"].data_ptr(), b["dv"].data_ptr(),
                *(t.data_ptr() for t in scratch[side]), B, S, S, 0, H, KV,
                D, w, chunk, *groups, mult, cap, scale, stream),
                f"flash_backward ({side})")

        for side in calls:
            forward(side)
            backward(side)
        torch.cuda.synchronize()
        same = all(torch.equal(bufs["parent"][n], bufs["tree"][n])
                   for n in ("out", "lse"))
        gaps = {n: cs.errors(bufs["tree"][n], bufs["parent"][n])[1]
                for n in ("dq", "dk", "dv")}
        ok &= same and max(gaps.values()) <= 2e-3
        row = {"forward with lse: the parent's bits": same,
               "backward vs parent (of max |value|)": gaps,
               "groups": lc["groups"]}
        for kernel, run in (("forward with lse", forward),
                            ("backward", backward)):
            for name, side in (("parent", "parent"), ("tree", "tree"),
                               ("tree, again", "tree"),
                               ("parent, again", "parent")):
                row[f"{kernel}: {name}"] = cs.time_ms(
                    lambda: run(side), flush, reps=args.reps)
        row["SDPA backward"] = None if cap else cs._sdpa_backward_ms(
            q, k, v, dout, window, chunk, flush)
        if tag == FLEX_SHAPE:
            try:
                f_ms, b_ms, err = flex_attention_times(
                    cs, q, k, v, dout, w, cap, flush, args.reps)
                row["flex_attention forward"] = f_ms
                row["flex_attention backward"] = b_ms
                row["flex_attention forward vs plain"] = err
                ok &= err <= 1e-3
            except Exception as exc:     # recorded, not fatal
                row["flex_attention error"] = \
                    f"{type(exc).__name__}: {str(exc)[:400]}"
        result["shapes"][tag] = row
        print(f"{tag} (B {B}, S {S}, {H} / {KV} heads of {D}, window "
              f"{window}, chunk {chunk}, softcap {cap:g}; {lc['groups']} "
              f"head group(s)): forward the parent's bits {same}; backward "
              f"vs parent " + ", ".join(f"{n} {g:.3g}" for n, g in
                                        gaps.items()) + " of max")
        for name, val in row.items():
            if isinstance(val, float):
                print(f"  {name:36s} {val:.4f}" + ("" if "vs plain" in name
                                                    else " ms"))
            elif name == "flex_attention error":
                print(f"  {name}: {val}")
        del q, k, v, dout, bufs, scratch, out16, lse
        torch.cuda.empty_cache()
    result["ok"] = bool(ok)
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
