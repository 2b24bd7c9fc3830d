"""Serving command line: ``--arch <id> [--reduced]`` batched continuous
decoding on the drain engine (the port's copy of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --reduced --device cpu --requests 16 --max-new 24

Serves on the card unless ``--device cpu`` is given (the kernels' plain
versions then run); without a card and without that request it raises
rather than fall back. Weights are random, from ``--seed``; prompts are
drawn from a numpy generator of the same seed, as the reference draws
them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import plan as plan_lib
from repro_torch.models import transformer as tfm
from repro_torch.serve.engine import DecodeEngine, Request, resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def requests_for(cfg, args) -> list:
    """``--requests`` prompts of ``--prompt-len`` tokens in [2, vocab),
    from ``np.random.default_rng(--seed)``."""
    rng = np.random.default_rng(args.seed)
    return [Request(rid=i,
                    prompt=[int(t) for t in rng.integers(
                        2, cfg.vocab_size, size=args.prompt_len)],
                    max_new=args.max_new)
            for i in range(args.requests)]


def serve(cfg, params, args) -> list:
    """Serve ``requests_for(cfg, args)`` on ``params`` (the reference's
    layout, e.g. ``transformer.init_params`` or ``bridge.params_from_numpy``)
    through ``DecodeEngine`` on ``plan_for_engine``; prints the rate and
    the first requests' tokens and returns the finished requests."""
    device = resolve_device(args.device)
    params = tfm.compute_copy(tfm.to_device(params, device))
    engine = DecodeEngine(cfg, params,
                          plan_lib.plan_for_engine(cfg, slots=args.slots,
                                                   cache_len=args.cache_len),
                          temperature=args.temperature, device=device)
    t0 = time.time()
    done = engine.run(requests_for(cfg, args), seed=args.seed + 1)
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {total_new} tokens "
          f"in {dt:.1f}s ({total_new / dt:.1f} tok/s)")
    for r in done[:4]:
        print(f"  req {r.rid}: {len(r.out)} new tokens, "
              f"first 8 = {r.out[:8]}")
    return done


def main(argv=None) -> list:
    args = parse_args(argv)
    cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
    device = resolve_device(args.device)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    return serve(cfg, params, args)


if __name__ == "__main__":
    main()
