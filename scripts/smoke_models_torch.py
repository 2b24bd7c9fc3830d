#!/usr/bin/env python3
"""Dev harness for the PyTorch/CUDA port: every arch's reduced loss,
prefill and one decode step (the port's counterpart of
``scripts/smoke_models.py``).

    PYTHONPATH=src python scripts/smoke_models_torch.py [--device cpu] [arch ...]

For each arch (all by default) at its ``-reduced`` size: seeded params
(``transformer.init_params``), a random batch of 2 x 64 tokens (with the
vision patches or the conditioning sequence its config asks for), the
training loss, a prefill into a cache of 72 positions and one decode step
(``models.decoding.prefill`` / ``serve_step``), each checked finite. Runs
on the card by default; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import sys

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import decoding, frontend, transformer as tfm
from repro_torch.serve.engine import resolve_device
from repro_torch.train import optimizer as opt_lib

B, S = 2, 64


def make_batch(gen, cfg, device):
    """tokens (as labels too) and the frontend inputs the config takes."""
    s_text = S - cfg.num_patches if cfg.frontend == "vision" else S
    shape = (B, cfg.num_codebooks, s_text) if cfg.num_codebooks > 1 \
        else (B, s_text)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=gen,
                         device=device)
    batch = {"tokens": toks, "labels": toks}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = frontend.synth_patch_embeds(gen, B, cfg,
                                                            device)
    if cfg.cross_attn_cond:
        batch["cond"] = frontend.synth_cond_embeds(gen, B, cfg, device)
    return batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("archs", nargs="*")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for name in args.archs or ARCH_NAMES:
        cfg = get_config(name).reduced()
        gen = torch.Generator(device=device).manual_seed(0)
        params = tfm.init_params(cfg, gen, device)
        n_params = sum(p.numel() for p in opt_lib.leaves(params))
        batch = make_batch(gen, cfg, device)
        with torch.no_grad():
            total, _ = tfm.loss_fn(params, batch, cfg)
            assert torch.isfinite(total), (name, total)
            logits, cache = decoding.prefill(
                params, batch["tokens"], cfg, S + 8,
                patch_embeds=batch.get("patch_embeds"),
                cond=batch.get("cond"))
            assert bool(torch.isfinite(logits.float()).all()), name
            tok = batch["tokens"][..., -1:]
            logits2, _ = decoding.serve_step(
                params, cache, tok, torch.tensor(S, device=device), cfg,
                cond=batch.get("cond"))
            assert bool(torch.isfinite(logits2.float()).all()), name
        print(f"OK {name:28s} params={n_params:>10,} "
              f"loss={float(total):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
