"""Sparse processing with the port (paper §IV): prune an MLP weight, encode
it block-CSC and run the sparse kernels, which skip zero blocks entirely;
report the paper's scalar-CSC compression ratio beside it.

Runs on the card by default (the CUDA kernels: the GEMM above 8 rows, the
GEMV at 8 and below), or on the CPU with the kernels' plain versions:

    PYTHONPATH=src python examples/torch_sparse_inference.py
    PYTHONPATH=src python examples/torch_sparse_inference.py --device cpu \\
        --arch qwen2.5-3b-reduced
"""
import argparse

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core import dataflow
from repro_torch.core import sparsity as sp
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--sparsity", type=float, default=0.75)
    ap.add_argument("--rows", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    d, ff, b = cfg.d_model, cfg.d_ff, 16
    # an MLP up-projection, block-pruned so that the skip is whole tiles
    w = torch.randn(d, ff, generator=gen, device=dev) / d ** 0.5
    w = sp.block_magnitude_prune(w, args.sparsity, b, b)
    # the kernels take bf16 operands: hold them to a dense product of the
    # same bf16 values
    w = w.bfloat16().float()
    m = sp.bcsc_encode(w, b, b)
    nb_total = (d // b) * (ff // b)
    print(f"weight ({d}, {ff}) block-pruned to {args.sparsity:.0%}: "
          f"{m.nnzb}/{nb_total} blocks kept ({nb_total / m.nnzb:.1f}x "
          "fewer block products than dense)")

    # the paper's scalar CSC (count bits + data + address) of an int8 view
    # of one 256-column slice (the encoder walks every entry on the host)
    part = (w[:, :256] * 100).round().to(torch.int64).cpu().numpy()
    csc = sp.csc_encode(part)
    print(f"scalar CSC of a ({d}, 256) slice: {csc.nnz} entries, "
          f"{csc.storage_bits()} bits, compression "
          f"{csc.compression_ratio():.2f}x over 8-bit dense")

    x = torch.randn(args.rows, d, generator=gen, device=dev).bfloat16()
    dense = torch.matmul(x.float(), w)
    ops.reset_launches()
    y = ops.bcsc_matmul(x, m)
    err = float((y - dense).abs().max() / dense.abs().max())
    route = dataflow.matmul_path(args.rows)
    print(f"bcsc_matmul at M {args.rows} ({route}): max |err| over max "
          f"|dense| {err:.2e}")

    x1 = x[:1]
    y1 = ops.bcsc_gemv(x1, m, activation="silu")
    err1 = float((y1 - F.silu(dense[:1])).abs().max()
                 / F.silu(dense[:1]).abs().max())
    print(f"bcsc_gemv at M 1 with fused silu: max |err| over max |dense| "
          f"{err1:.2e}; kernel launches {ops.launch_counts()}")


if __name__ == "__main__":
    main()
