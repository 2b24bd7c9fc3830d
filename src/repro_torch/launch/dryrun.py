"""The dry-run: every (architecture x input shape x mesh) cell's cost per
device, with no device at all (the port's counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k --mesh multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each cell is built on the ``meta`` device over a logical production mesh
(``launch.mesh``, ``launch.cell.build_cell``) and writes one JSON record
under ``--out`` (a cell whose record exists is skipped unless ``--force``,
so a sweep resumes). The record keeps the reference's keys. Where the
reference reads a compiled XLA program, the port counts:

* ``memory``: argument, output and alias bytes per device, summed over
  the leaves' ``Layout.local_shape`` (the reference's XLA figures to the
  byte for arguments and aliases; its output figure also holds XLA's tuple
  tables); ``temp_size_in_bytes`` is null, as there is no compiled
  program, so ``hbm_per_chip_gb`` (arguments + outputs - aliases)
  excludes temporaries (``hbm_per_chip_note``);
* ``flops_per_chip``: the step's matrix-product FLOPs at global shapes
  (``CellBuild.trace``, ``torch.utils.flop_counter``) over the devices;
* ``hbm_bytes_per_chip``: the bytes per device the step must move at
  least: each argument read once, each output written once, a donated
  argument's output counted by what the step writes into it
  (``written_bytes``), not by its whole size;
* ``coll_bytes_per_chip`` / ``coll_by_op``: collectives counted from the
  specs and the plan (``collective_terms``, each rule beside its code),
  in ring bytes;
* the three roofline terms at ``core.eyexam.H100_SXM``.

A cell whose step cannot run on ``meta`` (a value read to the host) is
recorded ``status: "error"`` with the cause; it gets no guess.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Iterator, List, NamedTuple, Tuple, Union

import torch

from repro_torch.configs import (ARCH_NAMES, SHAPES, ShapeConfig,
                                 cell_is_runnable, get_config)
from repro_torch.core import eyexam
from repro_torch.launch.cell import CellBuild, build_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import specs as sh

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
ACT_BYTES = 2                      # bf16 activations
# products whose contraction dimension a tensor-parallel cut leaves partial
# sums in: their outputs are summed over the model axis
ROW_PARALLEL = ("wo", "wd", "w2", "out_proj")


def model_flops(cfg, shape) -> float:
    """The step's useful FLOPs: 2 x active parameters per token (6 with the
    backward), over every token of the step (one per row in decode)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


# ------------------------------------------------------------ bytes
def _leaves(tree, layouts, path=()) -> Iterator[Tuple[tuple, torch.Tensor,
                                                      sh.Layout]]:
    """(path, tensor, layout) of every leaf of ``tree`` beside its layout
    tree (dicts, NamedTuples and tuples in the same shape)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree, layouts
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, layouts[k], path + (k,))
    else:
        for i, (v, lay) in enumerate(zip(tree, layouts)):
            yield from _leaves(v, lay, path + (i,))


def local_bytes(t: torch.Tensor, layout: sh.Layout) -> int:
    """Bytes of ``t``'s shard on one device under ``layout``."""
    return math.prod(layout.local_shape(tuple(t.shape))) * t.element_size()


def tree_bytes(tree, layouts) -> int:
    return sum(local_bytes(t, lay) for _, t, lay in _leaves(tree, layouts))


def memory(cell: CellBuild) -> Dict:
    """Argument, output and alias (donated argument) bytes per device."""
    outs = cell.trace()[0]
    args = [tree_bytes(a, lay)
            for a, lay in zip(cell.abstract_args, cell.in_layouts)]
    return {"argument_size_in_bytes": float(sum(args)),
            "output_size_in_bytes": float(tree_bytes(outs,
                                                     cell.out_layouts)),
            "temp_size_in_bytes": None,
            "alias_size_in_bytes": float(sum(args[i]
                                             for i in cell.donate_argnums))}


def written_bytes(cell: CellBuild) -> int:
    """Bytes per device the step writes into its donated arguments (the
    outputs that alias them): a train step rewrites every parameter and
    AdamW moment; a decode step writes one position a row of each K/V
    leaf, (..., rows, positions, KV, D), and the whole of a recurrent
    state. The reference's ``hloparse`` counts such an in-place update by
    its slice likewise."""
    n = 0
    for i in cell.donate_argnums:
        for path, t, lay in _leaves(cell.abstract_args[i],
                                    cell.in_layouts[i]):
            size = local_bytes(t, lay)
            if cell.kind == "decode" and path[-1] in ("k", "v"):
                size //= lay.local_shape(tuple(t.shape))[-3]
            n += size
    return n


def hbm_bytes(cell: CellBuild, mem: Dict) -> float:
    """The least bytes per device a step moves: every argument read once,
    every output written once, but an output that aliases a donated
    argument only as far as the step writes it (``written_bytes``)."""
    return (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            - mem["alias_size_in_bytes"] + written_bytes(cell))


# ------------------------------------------------------------ collectives
def _axis_parts(layout: sh.Layout, shape, axes) -> int:
    """Shards of ``shape`` over the mesh axes in ``axes``."""
    sizes = sh.mesh_axis_sizes(layout.mesh)
    n = 1
    for entry in layout.spec[:len(shape)]:
        for a in sh.entry_axes(entry):
            if a in axes:
                n *= sizes[a]
    return n


def _entry_has(layout: sh.Layout, dim: int, axis: str) -> bool:
    return dim < len(layout.spec) and axis in sh.entry_axes(layout.spec[dim])


class Term(NamedTuple):
    """One collective of a step, ``times`` over: ``operand`` bytes per
    device go in (the reference's ``hloparse`` counts these), over groups
    of ``n`` devices; ``rule`` names the rule that counts it."""
    op: str
    rule: str
    operand: float
    n: int
    times: int

    @property
    def ring_bytes(self) -> float:
        """Bytes through each device of a ring collective, once: an
        all-gather receives the n-1 shards it lacks, a reduce-scatter
        moves (n-1)/n of its operand, an all-reduce twice that."""
        share = (self.n - 1) / self.n
        return self.operand * {"all-gather": self.n - 1,
                               "reduce-scatter": share,
                               "all-reduce": 2 * share}[self.op]


def collective_terms(cell: CellBuild, *, remat_policy: str,
                     microbatches: int) -> List[Term]:
    """Every collective of one step, counted from the cell's specs and
    plan (the reference reads them out of XLA's program), one ``Term`` a
    rule and leaf."""
    cfg, shape = cell.cfg, cell.shape
    params, p_layouts = cell.abstract_args[0], cell.in_layouts[0]
    mesh = next(_leaves(params, p_layouts))[2].mesh
    sizes = sh.mesh_axis_sizes(mesh)
    dp = sh.dp_axes(sizes)
    n_dp = sh.axes_size(sizes, dp)
    m = sizes.get("model", 1)
    train = cell.kind == "train"
    k = microbatches if train else 1
    # the passes that read each weight: the forward; in training the
    # backward's products, and the forward again where remat "full"
    # recomputes it ("dots" keeps the products' outputs)
    weight_passes = 1 if not train else 2 + (remat_policy == "full")
    # the activations' all-reduces: the forward's, the backward's (the
    # cotangent of a row-parallel product's input), and the forward's
    # again where remat "full" recomputes it
    act_passes = 1 + (2 if train and remat_policy == "full"
                      else 1 if train else 0)
    terms: List[Term] = []

    def add(op, rule, operand, n, times):
        if operand > 0 and times > 0 and n > 1:
            terms.append(Term(op, rule, float(operand), n, int(times)))

    b_ax = cell.hints.act[0] if cell.hints is not None else None
    b_shards = sh.axes_size(sizes, sh.entry_axes(b_ax) or None)
    rows = shape.global_batch / b_shards / k        # per microbatch
    tokens = rows * (1 if cell.kind == "decode" else shape.seq_len)
    act = tokens * cfg.d_model * ACT_BYTES
    for path, t, lay in _leaves(params, p_layouts):
        shp = tuple(t.shape)
        local = local_bytes(t, lay)
        n_fsdp = _axis_parts(lay, shp, dp)
        if n_fsdp > 1:
            # FSDP: each pass that reads the leaf gathers it over the dp
            # axes that cut it ...
            add("all-gather", "fsdp weights", local, n_fsdp,
                weight_passes * k)
            # ... and its gradient leaves by a reduce-scatter
            if train:
                add("reduce-scatter", "fsdp grads", local * n_fsdp, n_fsdp,
                    k)
        elif train:
            # a gradient replicated over the dp axes: all-reduced
            add("all-reduce", "dp grads", local, n_dp, k)
        name = str(path[-1])
        stacked = 1 if path[0] == "blocks" else 0
        layers_ = shp[0] if stacked else 1
        if m <= 1:
            continue
        if name in ("wd", "w2") and len(shp) - stacked == 3:
            if _entry_has(lay, stacked, "model"):
                # expert parallel as the reference's program runs it: the
                # tokens stay whole on every device of the model axis, each
                # device applies its experts to their routed copies, and
                # the copies' outputs are all-reduced over the axis, per
                # MoE layer and pass
                add("all-reduce", "expert outputs",
                    act * cfg.experts_per_token, m, layers_ * act_passes * k)
                continue
            contraction = stacked + 1
        elif name in ROW_PARALLEL:
            contraction = stacked
        elif name == "embed":
            # a vocab-cut table: each device's lookup holds its rows' part
            contraction = len(shp) - 2
        else:
            continue
        if _entry_has(lay, contraction, "model"):
            # tensor parallel: the product's partial sums all-reduced over
            # the model axis, once per layer and pass
            add("all-reduce", "row-parallel outputs", act, m,
                layers_ * act_passes * k)
    if cell.kind != "train" and cell.plan.shard_vocab:
        # a vocab-cut head: its logits gathered whole over the model axis
        # (the cell's outputs keep the vocabulary whole)
        logits = cell.trace()[0][0]
        add("all-gather", "logits", local_bytes(
            logits, cell.out_layouts[0]) / m, m, 1)
    if cell.kind == "decode":
        terms += _cut_cache_terms(cell, sizes, rows)
    if cell.kind != "train" and m > 1:
        terms += _state_terms(cell, m)
    return terms


def _state_terms(cell: CellBuild, m: int) -> List[Term]:
    """An RG-LRU layer's state (its conv window and ``h``) that the step
    writes into the cache: the layer computes it cut over the model axis
    along its width (``in_x`` is column-parallel), the cache keeps it whole
    there (``autoshard.cache_spec``), so it is all-gathered over the axis,
    once a step."""
    params, p_layouts = cell.abstract_args[0], cell.in_layouts[0]
    if cell.kind == "decode":
        cache, layouts = cell.abstract_args[1], cell.in_layouts[1]
    else:
        cache, layouts = cell.trace()[0][1], cell.out_layouts[1]
    terms = []
    for path, t, lay in _leaves(cache, layouts):
        if path[-1] not in ("conv", "h"):
            continue
        block = params
        for key in path[:-1]:
            block = block[key]
        if "rglru" not in block:
            continue
        p_lay = p_layouts
        for key in path[:-1] + ("rglru", "in_x"):
            p_lay = p_lay[key]
        if _entry_has(p_lay, len(p_lay.spec) - 1, "model"):
            terms.append(Term("all-gather", "recurrent state",
                              local_bytes(t, lay) / m, m, 1))
    return terms


def _cut_cache_terms(cell: CellBuild, sizes, rows: float) -> List[Term]:
    """A decode step over a cache whose positions are cut over mesh axes
    (``autoshard.cache_spec`` where the KV heads do not divide the model
    axis): each attention layer's device reads its slice of the positions
    for every head, so the step gathers the query's heads where they are
    cut over the model axis, and all-reduces each head's partial softmax
    (its max and its sum, fp32) and its partial output (fp32) over the
    devices that hold the positions."""
    cfg, plan = cell.cfg, cell.plan
    H, D = cfg.num_heads, cfg.head_dim
    m = sizes.get("model", 1)
    terms = []
    for path, t, lay in _leaves(cell.abstract_args[1], cell.in_layouts[1]):
        if path[-1] != "k":
            continue
        stacked = 1 if path[0] == "blocks" else 0
        pos = stacked + 1                  # (.., rows, positions, KV, D)
        n = sh.axes_size(sizes, sh.entry_axes(lay.spec[pos]) or None) \
            if pos < len(lay.spec) else 1
        if n <= 1:
            continue
        layers_ = t.shape[0] if stacked else 1
        if plan.shard_heads and m > 1:
            terms.append(Term("all-gather", "cut cache: query heads",
                              rows * H / m * D * ACT_BYTES, m, layers_))
        terms.append(Term("all-reduce", "cut cache: softmax max, sum",
                          rows * H * 4, n, 2 * layers_))
        terms.append(Term("all-reduce", "cut cache: partial outputs",
                          rows * H * D * 4, n, layers_))
    return terms


def collectives(cell: CellBuild, *, remat_policy: str,
                microbatches: int) -> Tuple[Dict[str, float],
                                            Dict[str, int]]:
    """Bytes and counts per device of each collective of one step
    (``collective_terms``), in ring bytes (``Term.ring_bytes``)."""
    by_op = {op: 0.0 for op in COLLECTIVES}
    counts = {op: 0 for op in COLLECTIVES}
    for term in collective_terms(cell, remat_policy=remat_policy,
                                 microbatches=microbatches):
        by_op[term.op] += term.ring_bytes * term.times
        counts[term.op] += term.times
    return by_op, counts


# ------------------------------------------------------------ one cell
def run_cell(arch: str, shape_name: Union[str, ShapeConfig],
             multi_pod: bool = False, *, remat_policy: str = "dots",
             microbatches: int = 1, plan=None, mesh=None) -> Dict:
    """The record of one cell: ``shape_name`` names one of ``SHAPES`` (or
    is a ``ShapeConfig``), on the production mesh unless ``mesh`` is
    given."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(n) for n in mesh.shape)
    rec: Dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                 "kind": shape.kind}
    if not cell_is_runnable(arch, shape.name):
        rec.update(status="skipped",
                   reason="pure full-attention arch at 500k ctx "
                          "(long_500k applicability)")
        return rec
    t0 = time.monotonic()
    cfg = get_config(arch)
    try:
        cell = build_cell(arch, shape, mesh, remat_policy=remat_policy,
                          microbatches=microbatches, plan=plan)
        _, flops = cell.trace()
        mem = memory(cell)
        coll, counts = collectives(cell, remat_policy=remat_policy,
                                   microbatches=microbatches)
        chips = mesh.size
        roof = eyexam.Roofline(
            flops=flops / chips,
            hbm_bytes=hbm_bytes(cell, mem),
            coll_bytes=sum(coll.values()),
            per_op_coll={k: int(v) for k, v in coll.items()}, chips=chips)
        mf = model_flops(cfg, shape)
        rec.update(
            status="ok",
            compile_s=round(time.monotonic() - t0, 1),
            chips=chips,
            plan_rule=cell.plan.param_rule,
            plan_flags={
                "experts": cell.plan.shard_experts,
                "heads": cell.plan.shard_heads,
                "kv_heads": cell.plan.shard_kv_heads,
                "ffn": cell.plan.shard_ffn,
                "vocab": cell.plan.shard_vocab,
                "cache_seq": cell.plan.cache_seq_sharded,
            },
            memory=mem,
            hbm_per_chip_gb=round(
                (mem["argument_size_in_bytes"]
                 + mem["output_size_in_bytes"]
                 - mem["alias_size_in_bytes"]) / 1e9, 3),
            hbm_per_chip_note="arguments + outputs - aliases; temporaries "
                              "excluded (no compiled program)",
            flops_per_chip=roof.flops,
            hbm_bytes_per_chip=roof.hbm_bytes,
            coll_bytes_per_chip=roof.coll_bytes,
            coll_by_op=roof.per_op_coll,
            coll_counts=counts,
            t_compute_s=roof.t_compute,
            t_memory_s=roof.t_memory,
            t_collective_s=roof.t_collective,
            bound=roof.bound,
            model_flops_total=mf,
            model_flops_per_chip=mf / chips,
            useful_flops_ratio=(mf / chips) / max(roof.flops, 1.0),
            roofline_fraction=roof.fraction_of_roofline(mf / chips),
        )
    except Exception as e:  # noqa: BLE001 - the record keeps the failure
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   compile_s=round(time.monotonic() - t0, 1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = ([(a, s) for a in ARCH_NAMES for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"SKIP {tag} (exists)")
                continue
            rec = run_cell(arch, shape, mp, remat_policy=args.remat,
                           microbatches=args.microbatches)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = rec["status"]
            extra = (f" bound={rec.get('bound')} "
                     f"t=({rec.get('t_compute_s', 0):.2e},"
                     f"{rec.get('t_memory_s', 0):.2e},"
                     f"{rec.get('t_collective_s', 0):.2e})"
                     if status == "ok"
                     else rec.get("error", rec.get("reason")))
            print(f"{status.upper():7s} {tag} {extra}", flush=True)


if __name__ == "__main__":
    main()
