"""Training driver: ``--arch <id> [--reduced]`` under the fault-tolerant
Supervisor (the port's copy of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --steps 5

Trains on the card unless ``--device cpu`` is given (the kernels' plain
versions then run). As the reference's mesh is all of its devices, the job
is one rank a card (``sharding.dist``, NCCL), every visible card by
default; under torchrun it takes torchrun's ranks, and ``--nproc N``
spawns N ranks itself (gloo on the CPU; ``--backend gloo`` for ranks that
share one card, ``--device cuda:0``). Each rank builds the mesh over the
ranks (``sharding.mesh.make_local_mesh``: data = the ranks; one process on
one device gives data=1), plans the model for it
(``core.planner.plan_model``) and, on a mesh of more than one device,
makes the sharding hints (``sharding.autoshard.make_hints``); each rank
trains on its rows of every batch and the gradients are summed over the
ranks (``train.loop.make_train_step`` on a process mesh). Checkpoints,
restarts, straggler detection and metrics are the reference's; rank 0
alone prints and writes checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --steps 5 --nproc 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch ...
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import planner
from repro_torch.data import pipeline as data_lib
from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                                 Supervisor)
from repro_torch.serve.engine import resolve_device
from repro_torch.sharding import autoshard, dist
from repro_torch.sharding.mesh import make_local_mesh, mesh_desc
from repro_torch.train import loop as train_loop, optimizer as opt_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks to spawn (default: one a visible card; "
                         "1 on the CPU)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend by name (default: nccl "
                         "on the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    if dist.in_torchrun():
        group = dist.init(device=args.device or "cuda",
                          backend=args.backend)
        try:
            return train(group, args)
        finally:
            dist.destroy()
    device = resolve_device(args.device)
    world = args.nproc or (torch.cuda.device_count()
                           if device.type == "cuda" and device.index is None
                           else 1)
    if world > 1:
        return dist.spawn(train, world, args, device=device,
                          backend=args.backend)[0]
    return train(None, args)


def train(group, args):
    """The training run of ``args`` in this process: rank ``group.rank``
    of a process group (``dist.spawn`` calls it so), or the whole job when
    ``group`` is None. Returns the Supervisor's result."""
    cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
    if group is None:
        device = resolve_device(args.device)
        mesh = make_local_mesh(device=device.type)
    else:
        device = group.device
        mesh = make_local_mesh(group=group)
    lead = group is None or group.rank == 0
    shape = planner.ShapeConfig("cli", "train", args.seq, args.batch)
    plan = planner.plan_model(cfg, shape, mesh_desc(mesh))
    hints = (autoshard.make_hints(plan, mesh, args.batch)
             if mesh.size > 1 else None)
    opt_cfg = opt_lib.OptimizerConfig(peak_lr=args.lr,
                                      warmup_steps=min(20, args.steps // 5),
                                      total_steps=args.steps)
    step_fn = train_loop.make_train_step(cfg, opt_cfg,
                                         remat_policy=args.remat,
                                         microbatches=args.microbatches,
                                         hints=hints, mesh=mesh)
    dcfg = data_lib.DataConfig(
        seq_len=args.seq, global_batch=args.batch,
        vocab_size=cfg.vocab_size, seed=args.seed,
        num_codebooks=cfg.num_codebooks,
        num_patches=cfg.num_patches if cfg.frontend == "vision" else 0,
        d_model=cfg.d_model, cond_len=cfg.cross_attn_cond)

    def data_fn(step: int):
        return data_lib.to_torch(data_lib.synth_batch(dcfg, step), device)

    def wrapped_step(state, batch):
        params, opt_state = state
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        return (params, opt_state), metrics

    def init_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return train_loop.init_train_state(cfg, gen, device)

    ckpt_dir = args.ckpt_dir or os.path.join(
        "results", "ckpt", cfg.name.replace("/", "_"))
    sup = Supervisor(
        FaultToleranceConfig(checkpoint_dir=ckpt_dir,
                             checkpoint_every=args.ckpt_every),
        step_fn=wrapped_step, data_fn=data_fn, init_state_fn=init_state,
        group=group)

    t0 = time.time()
    result = sup.run(args.steps)
    dt = time.time() - t0
    if not lead:
        return result
    for m in result["metrics"]:
        if m["step"] % args.log_every == 0 or m["step"] == args.steps - 1:
            print(f"step {m['step']:5d} loss={m.get('loss', 0):.4f} "
                  f"acc={m.get('accuracy', 0):.4f} "
                  f"gnorm={m.get('grad_norm', 0):.2f}")
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {dt:.1f}s, {toks / dt:.0f} tok/s, "
          f"restarts={result['restarts']}, ranks="
          f"{1 if group is None else group.world}")
    return result


if __name__ == "__main__":
    main()
