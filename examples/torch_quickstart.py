"""Quickstart for the PyTorch/CUDA port: the public API in ~60 lines.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Builds a reduced gemma2-family model, plans its sharding with the HM-mesh
planner (the paper's per-layer NoC configuration) over the devices there
are (``sharding.mesh.make_local_mesh``), trains a few steps, and greedily
decodes a few tokens from the trained weights with ``DecodeEngine``. Runs
on the card by default; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import plan as plan_lib
from repro_torch.core import planner
from repro_torch.data import pipeline as data_lib
from repro_torch.serve.engine import DecodeEngine, Request, resolve_device
from repro_torch.sharding.mesh import make_local_mesh, mesh_desc
from repro_torch.train import loop as train_loop, optimizer as opt_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. pick an architecture (any of the 10 assigned ids; -reduced = CPU-size)
    cfg = get_config("gemma2-2b-reduced")
    print(f"arch={cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"params={cfg.param_count():,}")

    # 2. the planner decides the per-layer NoC/sharding modes (paper Fig. 9)
    mesh = make_local_mesh(device=device.type)
    shape = planner.ShapeConfig("train_4k", "train", 4096, 256)
    plan = planner.plan_model(cfg, shape, mesh_desc(mesh))
    print("planner:", plan.describe().splitlines()[0])

    # 3. train a few steps on synthetic data
    gen = torch.Generator(device=device).manual_seed(0)
    params, opt_state = train_loop.init_train_state(cfg, gen, device)
    step = train_loop.make_train_step(
        cfg, opt_lib.OptimizerConfig(peak_lr=1e-3, warmup_steps=2,
                                     total_steps=20))
    for i in range(8):
        batch = data_lib.to_torch(data_lib.batch_for_arch(
            cfg, seq_len=64, global_batch=4, step=i), device)
        params, opt_state, metrics = step(params, opt_state, batch)
        if i % 2 == 0:
            print(f"step {i}: loss={float(metrics['loss']):.3f}")

    # 4. serve greedily from the trained weights (plan-driven dispatch)
    eng = DecodeEngine(cfg, params,
                       plan_lib.plan_for_engine(cfg, slots=2, cache_len=48),
                       eos_id=-1, device=device)
    done = eng.run([Request(0, [5, 6, 7], max_new=8)])
    print("decoded:", done[0].out)
    return done[0].out


if __name__ == "__main__":
    main()
