#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port spends its time, on one
GPU.

    python3 scripts/profile_train_torch.py [--arch qwen2.5-3b] [--seq 2048]
                                           [--remat full] [--layers N]
    python3 scripts/profile_train_torch.py --cells prefill decode train

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

With ``--cells`` it profiles the dry-run's cells instead: those of
``chip_smoke.py``'s ``phase_cells`` (``CELL_ARCH`` at published width and
depth, ``CELL_SHAPES``; ``launch.cell.build_cell`` on a one-card
``TrainMesh(1, 1)``), each one's arguments materialised on the card from
seed 0 (``chip_smoke._cell_args``), one warm-up step, then one step in the
same trace.

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


def traced(step, top_n: int):
    """One call of ``step`` in a ``torch.profiler`` trace of the card:
    (the call's result, its synchronised wall in s, device ms and launches
    by kernel group, the ``top_n`` kernels with the most time)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = step()
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top_n]
    return out, wall, groups, top


def report(head: str, wall: float, groups, top) -> dict:
    """Prints a traced step's lines under ``head``; returns its numbers."""
    busy = sum(g[0] for g in groups.values())
    print(f"  {head}: wall {1e3 * wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / (1e3 * wall):.1f} %), "
          f"{sum(g[1] for g in groups.values())} launches")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"    {g}: {ms:.1f} ms, {n} launches")
    print("  top kernels:")
    for k, (ms, n) in top:
        print(f"    {ms:9.2f} ms {n:6d} x  {k}")
    return {"wall_ms": 1e3 * wall, "busy_ms": busy,
            "groups_ms": {g: v[0] for g, v in groups.items()},
            "launches": {g: v[1] for g, v in groups.items()},
            "top": [[k, v[0], v[1]] for k, v in top]}


def profile_cells(name: str, kinds) -> int:
    """``--cells``: one traced step of each of ``chip_smoke.py``'s cells
    whose kind is in ``kinds``."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.cell import build_cell
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding.mesh import TrainMesh
    cfg = get_config(cs.CELL_ARCH)
    out = {"card": name, "arch": cfg.name, "cells": {}}
    print(f"{name}: {cfg.name}, {cfg.num_layers} layers, the dry-run's "
          "cells on a one-card mesh")
    for cell_name, kind, seq, batch in cs.CELL_SHAPES:
        if kind not in kinds:
            continue
        cell = build_cell(cs.CELL_ARCH, ShapeConfig(cell_name, kind, seq,
                                                    batch),
                          TrainMesh(1, 1, device="cuda"),
                          remat_policy=cs.TRAIN_REMAT, microbatches=1)
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        step_args = cs._cell_args(cell, gen, tfm.init_params(cfg, gen,
                                                             "cuda"))
        grad = torch.enable_grad() if kind == "train" else torch.no_grad()
        with grad:
            cell.fn(*step_args)
            torch.cuda.synchronize()
            _, wall, groups, top = traced(lambda: cell.fn(*step_args), 12)
        out["cells"][cell_name] = report(
            f"cell {cell_name} ({kind}, {batch} x {seq}), traced step", wall,
            groups, top)
        del step_args, cell
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--cells", nargs="+",
                    choices=["prefill", "decode", "train"])
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
    if args.cells:
        return profile_cells(name, args.cells)
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
    (params, opt, _), wall, groups, top = traced(
        lambda: step(params, opt, batch), 15)
    print(f"{name}: {cfg.name}, {cfg.num_layers} layers, "
          f"{cfg.param_count():.4g} parameters, batch 1 x {args.seq}, "
          f"remat {args.remat}")
    print("  one step by its parts (host clock, synchronised): " + ", ".join(
        f"{k} {1e3 * v:.1f} ms" for k, v in parts.items()))
    traced_step = report("traced step", wall, groups, top)
    print(json.dumps({
        "card": name, "arch": cfg.name, "layers": cfg.num_layers,
        "seq": args.seq, "remat": args.remat,
        "parts_ms": {k: 1e3 * v for k, v in parts.items()},
        "step_wall_ms": traced_step["wall_ms"],
        "busy_ms": traced_step["busy_ms"],
        "groups_ms": traced_step["groups_ms"],
        "launches": traced_step["launches"], "top": traced_step["top"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
