"""End-to-end training driver for the PyTorch/CUDA port: train a decoder LM
for a few hundred steps with the full substrate — fault-tolerant
supervisor, atomic checkpoints, stateless-indexable data pipeline, cosine
schedule (the port's counterpart of ``examples/train_lm.py``).

Presets:
    tiny  (~5M params)   — a few hundred steps in minutes on a CPU
    100m  (~116M params) — the deliverable scale; same code path, on a card

Runs on the card by default (attention through the sliding-window and
flash backward kernels); ``--device cpu`` runs their plain versions:

    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
        --preset tiny --steps 300
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import pipeline as data_lib
from repro_torch.runtime.fault_tolerance import (FaultToleranceConfig,
                                                 Supervisor)
from repro_torch.serve.engine import resolve_device
from repro_torch.train import loop as train_loop, optimizer as opt_lib

PRESETS = {
    # (layers, d_model, heads, kv, head_dim, d_ff, vocab, seq, batch)
    "tiny": (4, 256, 4, 2, 64, 1024, 4096, 128, 8),
    "100m": (12, 768, 12, 4, 64, 3072, 16384, 512, 16),
}


def make_cfg(preset: str):
    L, d, H, KV, hd, ff, V, seq, batch = PRESETS[preset]
    base = get_config("qwen2.5-3b")       # plain GQA decoder family
    cfg = dataclasses.replace(
        base, name=f"lm-{preset}", num_layers=L, d_model=d, num_heads=H,
        num_kv_heads=KV, head_dim=hd, d_ff=ff, vocab_size=V, qkv_bias=False,
        max_seq_len=seq)
    return cfg, seq, batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="results/ckpt/torch_train_lm")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg, seq, batch = make_cfg(args.preset)
    print(f"{cfg.name}: {cfg.param_count():,} params, "
          f"{batch}x{seq} tokens/step, {args.steps} steps on {device}")

    ocfg = opt_lib.OptimizerConfig(peak_lr=args.lr, warmup_steps=20,
                                   total_steps=args.steps)
    step = train_loop.make_train_step(cfg, ocfg)
    dcfg = data_lib.DataConfig(seq_len=seq, global_batch=batch,
                               vocab_size=cfg.vocab_size)

    def data_fn(i):
        # narrow synthetic distribution => the LM can actually learn it
        b = data_lib.synth_batch(dataclasses.replace(dcfg, seed=i % 64),
                                 step=0)
        return data_lib.to_torch(b, device)

    def step_fn(state, b):
        p, o = state
        p, o, m = step(p, o, b)
        return (p, o), m

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(0)
        return train_loop.init_train_state(cfg, gen, device)

    sup = Supervisor(
        FaultToleranceConfig(checkpoint_dir=args.ckpt_dir,
                             checkpoint_every=100),
        step_fn, data_fn, init_fn)
    t0 = time.time()
    result = sup.run(args.steps)
    dt = time.time() - t0

    losses = [m["loss"] for m in result["metrics"]]
    for m in result["metrics"]:
        if m["step"] % args.log_every == 0 or m["step"] == args.steps - 1:
            print(f"step {m['step']:5d} loss={m['loss']:.4f} "
                  f"acc={m['accuracy']:.3f} lr={m['lr']:.2e}")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    toks = args.steps * batch * seq
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first * 0.95 else 'no descent!'}); "
          f"{toks / dt:.0f} tok/s on {device}")
    return result


if __name__ == "__main__":
    main()
