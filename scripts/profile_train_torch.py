#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port spends its time, on one
GPU.

    python3 scripts/profile_train_torch.py [--arch qwen2.5-3b] [--seq 2048]
                                           [--remat full] [--layers N]

Builds the model as ``chip_smoke.py``'s training phase does (fp32 params
from seed 0 and their AdamW state on the card; ``--layers N`` keeps N
layers), one synthetic batch of ``--seq`` tokens (``data.pipeline``), and
runs two warm-up steps of ``train.loop.make_train_step`` (the reference's
optimizer defaults). Then:

* one step split by its parts, each synchronised: the forward and loss
  (``transformer.loss_fn``), the backward (``torch.autograd.grad``), the
  optimizer (``optimizer.adamw_update``), host clock;
* one whole step in a ``torch.profiler`` trace of the card: device time by
  kernel group and the 15 kernels with the most time, launches, and the
  share of the step's wall the card was busy.

Every line names the card and its power limit; the last line is a JSON
object with the same numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (   # kernel-name fragment -> group, first match wins
    ("fbwd_", "flash backward (port)"),
    ("swa_kernel", "sliding-window attention (port)"),
    ("gemm", "dense matmul (cuBLAS)"), ("nvjet", "dense matmul (cuBLAS)"),
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


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--layers", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as data_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.train import loop as train_loop
    from repro_torch.train import optimizer as opt_lib
    if not torch.cuda.is_available():
        print("profile_train_torch: needs a CUDA device", file=sys.stderr)
        return 2
    name = card()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt = train_loop.init_train_state(cfg, gen, dev)
    batch = data_lib.to_torch(data_lib.synth_batch(data_lib.DataConfig(
        seq_len=args.seq, global_batch=1, vocab_size=cfg.vocab_size), 0), dev)
    ocfg = opt_lib.OptimizerConfig()
    step = train_loop.make_train_step(cfg, ocfg, remat_policy=args.remat)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()

    # one step by its parts (train_loop.value_and_grad's, timed apart)
    leaves = list(opt_lib.leaves(params))
    parts = {}
    t0 = time.perf_counter()
    for p in leaves:
        p.requires_grad_(True)
    layered = train_loop._layered(params)
    loss, _ = tfm.loss_fn(layered, batch, cfg, remat_policy=args.remat)
    torch.cuda.synchronize()
    parts["forward and loss"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inputs = [t for leaf in opt_lib.leaves(layered)
              for t in train_loop._parts(leaf)]
    grads = torch.autograd.grad(loss, inputs)
    torch.cuda.synchronize()
    parts["backward"] = time.perf_counter() - t0
    for p in leaves:
        p.requires_grad_(False)
    del loss, grads, layered, inputs
    _, _, tree = train_loop.value_and_grad(train_loop.make_loss_fn(
        cfg, args.remat), params, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, _ = opt_lib.adamw_update(ocfg, params, tree, opt)
    torch.cuda.synchronize()
    parts["optimizer"] = time.perf_counter() - t0
    del tree

    # one whole step in a trace
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups, kernels = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.duration_ns() / 1e6
        g = groups.setdefault(group_of(e.name()), [0.0, 0])
        g[0] += ms
        g[1] += 1
        k = kernels.setdefault(e.name()[:90], [0.0, 0])
        k[0] += ms
        k[1] += 1
    busy = sum(g[0] for g in groups.values())
    print(f"{name}: {cfg.name}, {cfg.num_layers} layers, "
          f"{cfg.param_count():.4g} parameters, batch 1 x {args.seq}, "
          f"remat {args.remat}")
    print("  one step by its parts (host clock, synchronised): " + ", ".join(
        f"{k} {1e3 * v:.1f} ms" for k, v in parts.items()))
    print(f"  traced step: wall {1e3 * wall:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / (1e3 * wall):.1f} %), "
          f"{sum(g[1] for g in groups.values())} launches")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"    {g}: {ms:.1f} ms, {n} launches")
    print("  top kernels:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    for k, (ms, n) in top:
        print(f"    {ms:9.2f} ms {n:6d} x  {k}")
    print(json.dumps({
        "card": name, "arch": cfg.name, "layers": cfg.num_layers,
        "seq": args.seq, "remat": args.remat,
        "parts_ms": {k: 1e3 * v for k, v in parts.items()},
        "step_wall_ms": 1e3 * wall, "busy_ms": busy,
        "groups_ms": {g: v[0] for g, v in groups.items()},
        "launches": {g: v[1] for g, v in groups.items()},
        "top": [[k, v[0], v[1]] for k, v in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
