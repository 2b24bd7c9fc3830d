"""Streaming LM serving through the port's ``repro_torch.serve.LLM``.

Resolve a ServePlan once from the model config and the serving budget
(``core.plan.plan_serve``: every dispatch decision with its Eyexam-style
rationale, printed by ``plan.explain()``), hand it to ``LLM`` and stream.
Requests arrive on a Poisson process behind a shared system prompt, share
a page pool provisioned for the expected occupancy, and stream their tokens
through a per-request callback. The MLPs are block-pruned and packed in
BCSC, so decode runs the sparse kernels.

With ``--replicas N`` the same front door serves through the fleet
(``serve.replica.ReplicaSet``): N schedulers on the one device and the one
copy of the weights, requests placed by prefix affinity and queue depth,
heartbeats audited every sync window; ``--kill-replica-at STEP`` kills
replica 0 at that virtual step, and its unfinished requests migrate by
recompute to the survivors.

Runs on the card by default, at the full width of ``--arch``; on the CPU
(``--device cpu``, where the kernels' plain versions run) use a
``-reduced`` config:

    PYTHONPATH=src python examples/torch_serve_lm.py
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu \\
        --arch qwen2.5-3b-reduced --cache-len 128
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu \\
        --arch qwen2.5-3b-reduced --cache-len 128 --replicas 3 \\
        --kill-replica-at 8
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import plan as plan_lib
from repro_torch.models import transformer as tfm
from repro_torch.serve import LLM, StreamRequest
from repro_torch.serve.chaos import ReplicaChaosConfig
from repro_torch.serve.sparse import sparsify_mlp_params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=512)
    ap.add_argument("--hbm", default="40GB",
                    help="the plan's memory budget (e.g. 40GB, 2GiB)")
    ap.add_argument("--sparsity", type=float, default=0.75,
                    help="MLP block sparsity the weights are pruned to")
    ap.add_argument("--mean-gap", type=float, default=4.0,
                    help="mean Poisson inter-arrival gap, in decode steps")
    ap.add_argument("--prefix-len", type=int, default=16,
                    help="shared system-prompt length (0 disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="scheduler replicas behind the router (>1 serves "
                         "through the fleet)")
    ap.add_argument("--kill-replica-at", type=float, default=None,
                    help="kill replica 0 at this virtual step (needs "
                         "--replicas > 1); its requests migrate by "
                         "recompute")
    args = ap.parse_args()
    if args.kill_replica_at is not None and args.replicas < 2:
        ap.error("--kill-replica-at needs --replicas > 1 (killing the "
                 "only replica just respawns it)")

    cfg = get_config(args.arch)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params, stats = sparsify_mlp_params(
        tfm.init_params(cfg, gen, args.device), cfg, sparsity=args.sparsity)

    plan = plan_lib.plan_serve(
        cfg, hbm_budget_bytes=plan_lib._parse_bytes(args.hbm),
        expected_batch=args.rows,
        expected_len_dist={"mean": args.cache_len // 2,
                           "max": args.cache_len},
        sparsity_stats=stats)
    print(plan.explain())
    print()
    llm = LLM(cfg, params, plan, eos_id=-1, device=args.device,
              replicas=args.replicas)
    del params

    first = {}

    def on_token(req, tok):
        if req.rid not in first:
            first[req.rid] = tok
            print(f"  req {req.rid} (arrived t={req.arrival:.0f}, admitted "
                  f"t={req.admitted_at:.0f}) first token: {tok}")

    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(args.mean_gap, args.requests))
    prefix = [int(t) for t in rng.integers(2, cfg.vocab_size,
                                           args.prefix_len)]
    room = plan.cache_len - args.prefix_len - args.max_new
    reqs = [StreamRequest(
        rid=i, prompt=prefix + [int(t) for t in rng.integers(
            2, cfg.vocab_size, int(rng.integers(4, max(room, 5))))],
        max_new=int(rng.integers(4, args.max_new + 1)),
        arrival=float(arrivals[i]), on_token=on_token)
        for i in range(args.requests)]

    chaos = None
    if args.kill_replica_at is not None:
        chaos = ReplicaChaosConfig(kill_at_step={0: args.kill_replica_at})
    t0 = time.perf_counter()
    done = llm.stream(reqs, chaos=chaos)
    wall = time.perf_counter() - t0
    st = llm.phase_stats
    counters = st.get("fleet", st)     # a fleet's summed scheduler counters
    generated = sum(len(r.out) for r in done)
    lat = [r.finished_at - r.arrival for r in done]
    rate = (f"decode {generated / max(st['decode_s'], 1e-9):.1f} tokens/s"
            if "decode_s" in st else f"{generated / wall:.1f} tokens/s wall")
    print(f"{len(done)} requests, {generated} tokens in {wall:.2f} s wall "
          f"on {llm.device}; {rate}, prefill "
          f"{counters['prefill_real_tokens']} tokens")
    print(f"latency p50 {np.percentile(lat, 50):.0f} / p99 "
          f"{np.percentile(lat, 99):.0f} steps; preemptions "
          f"{counters['preemptions']}; outcomes "
          + ", ".join(f"{k} {v}" for k, v in st["outcomes"].items() if v))
    if args.replicas > 1:
        print(f"fleet: {st['replicas_spawned']} replicas spawned, "
              f"{st['replicas_final']} live at the end; failovers "
              f"{st['failovers']}"
              + (f" {st['failover_reasons']}" if st["failovers"] else "")
              + f", {st['migrated_requests']} requests migrated; router "
              f"{st['router']['affinity_hits']}/{st['router']['placements']}"
              " placements on their prefix's replica")
    drift = llm.telemetry().last_drift
    if drift is not None:
        print(f"drift: {len(drift.confirmed)} CONFIRMED / "
              f"{len(drift.findings)} compared")


if __name__ == "__main__":
    main()
