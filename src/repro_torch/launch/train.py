"""Training driver: ``--arch <id> [--reduced]`` under the fault-tolerant
Supervisor (the port's copy of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --steps 5

Trains on the card unless ``--device cpu`` is given (the kernels' plain
versions then run). As the reference does, it builds the mesh over the
devices there are (``sharding.mesh.make_local_mesh``: data = the cards, or
the one CPU), plans the model for it (``core.planner.plan_model``) and,
on a mesh of more than one device, makes the sharding hints
(``sharding.autoshard.make_hints``); the step runs every shard in this
process. Checkpoints, restarts, straggler detection and metrics are the
reference's.
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
from repro_torch.sharding import autoshard
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
    device = resolve_device(args.device)
    mesh = make_local_mesh(device=device.type)
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
                                         hints=hints)
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
        step_fn=wrapped_step, data_fn=data_fn, init_state_fn=init_state)

    t0 = time.time()
    result = sup.run(args.steps)
    dt = time.time() - t0
    for m in result["metrics"]:
        if m["step"] % args.log_every == 0 or m["step"] == args.steps - 1:
            print(f"step {m['step']:5d} loss={m.get('loss', 0):.4f} "
                  f"acc={m.get('accuracy', 0):.4f} "
                  f"gnorm={m.get('grad_norm', 0):.2f}")
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {dt:.1f}s, {toks / dt:.0f} tok/s, "
          f"restarts={result['restarts']}")
    return result


if __name__ == "__main__":
    main()
