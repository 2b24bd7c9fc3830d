"""The dry-run's cells in the port (``configs.shapes``, ``launch.mesh``,
``launch.cell``, ``launch.dryrun``) against the reference on the CPU.

The reference runs in one subprocess for this file, on 512 forced host
devices (``XLA_FLAGS`` set before JAX starts, as in
``tests/test_torch_mesh_train.py``): it builds and compiles its cells
(``repro.launch.cell.build_cell``, ``lower(...).compile()`` with excess
precision off) on a (2, 4) and a (1, 1) mesh of them and reads XLA's
memory analysis and ``hloparse``; a full-size cell's per-device bytes
come from ``NamedSharding.shard_shape`` on the 16 x 16 / 2 x 16 x 16
mesh, with no compile. The port builds the same cells on the ``meta``
device over logical ``TrainMesh``es. Tolerances, and why:

* the registry (shapes, skips, reduced shapes, the 40 cells as a set),
  ``train_flops_per_token``, ``model_flops``, ``input_specs``, the plans,
  the layout trees, ``abstract_cache`` and the ``dataflow`` helpers:
  equal; ``dequantize_i8``: equal bit for bit;
* argument and alias bytes: equal to XLA's per device, except that
  ``jax.jit`` drops the arguments a step never reads from its program
  (``keep_unused=False``): mamba2's MLP pre-norms (its SSD layers have no
  MLP, the reference keeps the norm) and, in decode, the position (its
  layers read none), which the port's record counts (``_unread``);
* output bytes: XLA's less its tuple table, 8 B an output leaf;
* FLOPs per device at a 1 x 1 mesh (``FlopCounterMode`` of the step
  against ``hloparse``'s dot FLOPs): prefill and decode within
  ``FLOPS_TOL`` (1 %; measured equal for qwen2.5-3b, 0.998 for mixtral's
  decode); a train step equal once the products XLA's program merges or
  drops are taken off the port's count (``_train_products_xla_merges``:
  the loss chunk's logits, one QKᵀ an attention layer, a dense MLP
  layer's recomputed down projection);
* collective bytes per device on the (2, 4) mesh, in ``hloparse``'s
  measure (operand bytes; ``launch.dryrun.collective_terms``): per op,
  all-gathers and all-reduces each within ``COLL_FACTOR`` (2) of the
  reference's, the total too; the resharding moves that XLA adds and no
  spec names (all-to-all, collective-permute) at most ``UNNAMED_SHARE``
  of its bytes; mamba2 per op excepted (``RESHARDED``);
* the roofline's bytes: a donated buffer once, by what the step writes
  into it;
* the slice as a whole, reduced qwen2.5-3b on a 1 x 1 mesh with the
  reference's params bridged: prefill and decode logits within
  ``LOGIT_TOL`` (1e-2 of max |logit|, ``tests/test_torch_model.py``'s),
  the train cell's first-step loss within ``LOSS_TOL`` (1e-4 relative,
  ``tests/test_torch_train.py``'s).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import (ARCH_NAMES, LONG_CONTEXT_SKIP, SHAPES,
                                 all_cells, cell_is_runnable, get_config,
                                 reduced_shape, train_flops_per_token)
from repro_torch.core import dataflow
from repro_torch.launch import dryrun
from repro_torch.launch.cell import build_cell, input_specs
from repro_torch.launch.mesh import (make_production_mesh, make_scaled_mesh)
from repro_torch.models import decoding
from repro_torch.sharding.mesh import TrainMesh
from repro_torch.train import optimizer as popt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOPS_TOL = 1e-2
COLL_FACTOR = 2.0
UNNAMED_SHARE = 0.25
LOGIT_TOL = 1e-2
LOSS_TOL = 1e-4
TUPLE_ENTRY = 8                  # bytes of one entry of XLA's tuple table
ARCH = "qwen2.5-3b"
TRAIN_ARCHS = ("qwen2.5-3b", "mixtral-8x7b", "mamba2-130m")
FLOP_ARCHS = ("qwen2.5-3b", "mixtral-8x7b")
# (arch, shape, mesh) of every reduced cell both packages build
CELLS = ([(a, "prefill_32k", "2x4") for a in ARCH_NAMES]
         + [(a, "decode_32k", "2x4") for a in ARCH_NAMES]
         + [(a, "train_4k", "2x4") for a in TRAIN_ARCHS]
         + [(a, s, "1x1") for a in FLOP_ARCHS
            for s in ("prefill_32k", "decode_32k", "train_4k")])
# (arch, kind, seq, batch) of reduced cells long enough for the reference's
# sequence-sharded attention on the (2, 4) mesh (S / model >= 128), the
# route the full-size cells take
SEQ_ROUTE = (("qwen2.5-3b", "prefill", 512, 2),
             ("qwen2.5-3b", "train", 512, 2))
FULL = (("qwen2.5-3b", "decode_32k", False),
        ("mixtral-8x7b", "train_4k", True))

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import (ARCH_NAMES, LONG_CONTEXT_SKIP, SHAPES, ShapeConfig,
                           all_cells, get_config, reduced_shape,
                           train_flops_per_token)
from repro.core import dataflow, hloparse
from repro.launch.cell import build_cell, input_specs
from repro.launch.dryrun import model_flops
from repro.models import decoding, transformer as tfm
from repro.train import optimizer as opt_lib

try:
    from jax.sharding import AxisType
    kw = lambda n: {"axis_types": (AxisType.Auto,) * n}
except ImportError:
    kw = lambda n: {}
STRICT = {"xla_allow_excess_precision": False}
d = sys.argv[1]
cells, full, arch = json.loads(sys.argv[2]), json.loads(sys.argv[3]), \
    sys.argv[4]
devs = jax.devices()
out, arrays = {}, {}

def mesh(shape, axes):
    return jax.make_mesh(shape, axes, devices=devs[:int(np.prod(shape))],
                         **kw(len(axes)))

def key(path):
    return "/".join(str(getattr(e, "key", getattr(e, "name",
                                                  getattr(e, "idx", e))))
                    for e in path)

def specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {key(p): [list(e) if isinstance(e, tuple) else e
                     for e in s.spec] for p, s in flat}

def shard_bytes(args, shardings):
    leaves = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
        x, jax.sharding.NamedSharding))
    return int(sum(int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
                   for a, s in zip(jax.tree.leaves(args), leaves)))

def shapes_of(tree):
    return {key(p): [list(a.shape), str(a.dtype)]
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}

out["shapes"] = {k: [s.name, s.kind, s.seq_len, s.global_batch]
                 for k, s in SHAPES.items()}
out["reduced"] = {k: list(vars(reduced_shape(s)).values())
                  for k, s in SHAPES.items()}
out["skip"] = sorted(LONG_CONTEXT_SKIP)
out["cells"] = [[a, s.name, r] for a, s, r in all_cells()]
out["tfpt"] = {a: train_flops_per_token(get_config(a)) for a in ARCH_NAMES}
out["model_flops"] = {f"{a}|{s}": model_flops(get_config(a), SHAPES[s])
                      for a in ARCH_NAMES for s in SHAPES}
out["inputs"] = {f"{a}{r}|{s}": shapes_of(input_specs(
    get_config(a + r), reduced_shape(SHAPES[s]) if r else SHAPES[s]))
    for a in ARCH_NAMES for s in SHAPES for r in ("", "-reduced")}
out["abstract_cache"] = {a: shapes_of(decoding.abstract_cache(
    get_config(a + "-reduced"), 2, 64)) for a in ARCH_NAMES}

meshes = {"2x4": mesh((2, 4), ("data", "model")),
          "1x1": mesh((1, 1), ("data", "model"))}
out["built"], compiled = {}, {}
for a, s, mname in cells:
    m = meshes[mname]
    cell = build_cell(a + "-reduced", reduced_shape(SHAPES[s]), m,
                      remat_policy="full", microbatches=1)
    comp = compiled[a, s, mname] = cell.lower(m).compile(
        compiler_options=STRICT)
    mem = comp.memory_analysis()
    cost = hloparse.analyze(comp.as_text())
    pl = cell.plan
    out["built"][f"{a}|{s}|{mname}"] = dict(
        rule=pl.param_rule,
        flags=[pl.shard_experts, pl.shard_heads, pl.shard_kv_heads,
               pl.shard_ffn, pl.shard_vocab, pl.cache_seq_sharded],
        in_specs=specs(cell.in_shardings),
        out_specs=specs(cell.out_shardings),
        donate=list(cell.donate_argnums),
        arg=int(mem.argument_size_in_bytes),
        alias=int(mem.alias_size_in_bytes),
        outb=int(mem.output_size_in_bytes), flops=float(cost.flops),
        coll={k: float(v) for k, v in cost.coll_bytes.items()})
out["seq"] = {}
for a, kind, S, B in json.loads(sys.argv[5]):
    cell = build_cell(a + "-reduced", ShapeConfig(f"{kind}_{S}", kind, S, B),
                      meshes["2x4"], remat_policy="full", microbatches=1)
    cost = hloparse.analyze(cell.lower(meshes["2x4"]).compile(
        compiler_options=STRICT).as_text())
    out["seq"][f"{a}|{kind}"] = {k: float(v)
                                 for k, v in cost.coll_bytes.items()}
out["full"] = {}
for a, s, multi in full:
    m = mesh((2, 16, 16), ("pod", "data", "model")) if multi else \
        mesh((16, 16), ("data", "model"))
    cell = build_cell(a, SHAPES[s], m, remat_policy="full", microbatches=4)
    out["full"][f"{a}|{s}"] = shard_bytes(cell.abstract_args,
                                          cell.in_shardings)

grid = {}
for M in (1, 7, 8, 100, 512, 4096):
    for K in (64, 128, 1000, 4096):
        for N in (64, 300, 2048):
            for db, budget in ((2, dataflow.VMEM_BYTES), (4, 1 << 20)):
                try:
                    t = dataflow.rs_matmul_tiling(M, K, N, db, budget)
                    grid[f"{M},{K},{N},{db},{budget}"] = [
                        t.bm, t.bk, t.bn, t.vmem_bytes,
                        dataflow.spad_fit_report(M * K * N, 0.75, t)]
                except AssertionError:
                    grid[f"{M},{K},{N},{db},{budget}"] = "refused"
out["tiling"] = grid
out["round_down"] = [dataflow._round_down(x, m) for x in (0, 1, 7, 8, 9,
                     127, 128, 300, 1000) for m in (8, 128)]
out["kv"] = [[dataflow.paged_kv_tokens(ls, ps), dataflow.dense_kv_tokens(
    len(ls), c)] for ls in ([], [1], [5, 64, 65, 300], [0, 1000, 4097])
    for ps in (1, 16, 64) for c in (64, 4096)]
out["transient"] = [dataflow.prefill_kv_transient_bytes(b, s, kv, hd, n, db)
                    for b in (1, 8) for s in (64, 4096) for kv in (2, 8)
                    for hd in (64, 128) for n in (1, 36) for db in (1, 2)]
out["consts"] = [dataflow.LANE, dataflow.SUBLANE, dataflow.VMEM_BYTES]

rng = np.random.default_rng(3)
q = rng.integers(-127, 128, (4, 64, 2, 16)).astype(np.int8)
scale = rng.uniform(0.0, 3.0, (4, 1, 2, 1)).astype(np.float32)
arrays["dq/q"], arrays["dq/scale"] = q, scale
arrays["dq/out"] = np.asarray(decoding.dequantize_i8(jnp.asarray(q),
                                                     jnp.asarray(scale)))

# the slice as a whole: reduced qwen2.5-3b's three cells on one device
cfg = get_config(arch + "-reduced")
params = tfm.init_params(jax.random.PRNGKey(0), cfg)
for p, v in jax.tree_util.tree_flatten_with_path(params)[0]:
    arrays["p/" + key(p)] = np.asarray(v)
rng = np.random.default_rng(0)
pre = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)}
logits, _ = compiled[arch, "prefill_32k", "1x1"](params, pre)
arrays["pre/tokens"], arrays["pre/logits"] = pre["tokens"], \
    np.asarray(logits)
cache = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape),
                                           a.dtype),
                     decoding.abstract_cache(cfg, 2, 64))
for p, v in jax.tree_util.tree_flatten_with_path(cache)[0]:
    arrays["cache/" + key(p)] = np.asarray(v.astype(jnp.float32))
dec = {"tokens": rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)}
logits, _ = compiled[arch, "decode_32k", "1x1"](params, cache, dec,
                                                jnp.int32(40))
arrays["dec/tokens"], arrays["dec/logits"] = dec["tokens"], \
    np.asarray(logits)
toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
_, _, metrics = compiled[arch, "train_4k", "1x1"](
    params, opt_lib.init_adamw(params), batch)
arrays["train/tokens"], arrays["train/labels"] = batch["tokens"], \
    batch["labels"]
out["train_loss"] = float(metrics["loss"])

json.dump(out, open(os.path.join(d, "out.json"), "w"))
np.savez(os.path.join(d, "out.npz"), **arrays)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results (see ``_REF``)."""
    d = tmp_path_factory.mktemp("cells")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _REF, str(d), json.dumps(CELLS),
         json.dumps(FULL), ARCH, json.dumps(SEQ_ROUTE)], env=env,
        capture_output=True, text=True,
        timeout=900, cwd=ROOT)
    assert "REF_OK" in r.stdout, r.stdout + r.stderr[-4000:]
    return (json.load(open(d / "out.json")),
            dict(np.load(d / "out.npz")))


@pytest.fixture(scope="module")
def built():
    """The port's cells, on logical meshes of the ``meta`` device."""
    meshes = {"2x4": TrainMesh(2, 4, device="meta"),
              "1x1": TrainMesh(1, 1, device="meta")}
    return {f"{a}|{s}|{m}": build_cell(a + "-reduced",
                                       reduced_shape(SHAPES[s]), meshes[m],
                                       remat_policy="full", microbatches=1)
            for a, s, m in CELLS}


def _flat(tree, prefix=""):
    """Leaves of a tree of tensors or layouts, by '/'-joined path."""
    if isinstance(tree, (torch.Tensor, dryrun.sh.Layout)):
        return {prefix[:-1]: tree}
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _specs(layouts):
    return {k: [list(e) if isinstance(e, tuple) else e for e in v.spec]
            for k, v in _flat(layouts).items()}


def _shapes(tree):
    return {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
            for k, v in _flat(tree).items()}


def _unflatten(arrays, prefix):
    tree = {}
    for k, v in arrays.items():
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


# ----------------------------------------------------------- the registry
def test_shape_registry_equals_reference(ref):
    want = ref[0]
    assert {k: [s.name, s.kind, s.seq_len, s.global_batch]
            for k, s in SHAPES.items()} == want["shapes"]
    assert {k: list(vars(reduced_shape(s)).values())
            for k, s in SHAPES.items()} == want["reduced"]
    assert sorted(LONG_CONTEXT_SKIP) == want["skip"]
    got = {(a, s.name, r) for a, s, r in all_cells()}
    assert got == {tuple(c) for c in want["cells"]}
    assert len(got) == 40 and sum(not r for *_, r in got) == 4
    assert all(r == cell_is_runnable(a, s) for a, s, r in got)


def test_model_flops_equal_reference(ref):
    want = ref[0]
    for a in ARCH_NAMES:
        assert train_flops_per_token(get_config(a)) == want["tfpt"][a]
        for s in SHAPES:
            assert dryrun.model_flops(get_config(a), SHAPES[s]) == \
                want["model_flops"][f"{a}|{s}"], (a, s)


@pytest.mark.parametrize("reduced", ["", "-reduced"])
def test_input_specs_equal_reference(ref, reduced):
    """Every kind, vision ``patch_embeds`` (text shortened by the patches)
    and musicgen's (B, K, S) tokens and ``cond`` among them."""
    for a in ARCH_NAMES:
        for s in SHAPES:
            shape = reduced_shape(SHAPES[s]) if reduced else SHAPES[s]
            got = _shapes(input_specs(get_config(a + reduced), shape))
            assert got == ref[0]["inputs"][f"{a}{reduced}|{s}"], (a, s)
            assert all(t.device.type == "meta" for t in
                       input_specs(get_config(a + reduced), shape).values())


def test_meshes():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert (single.axis_names, single.shape) == (("data", "model"), (16, 16))
    assert (multi.axis_names, multi.shape) == (("pod", "data", "model"),
                                               (2, 16, 16))
    assert not single.backed and not multi.backed
    scaled = make_scaled_mesh(512, model=16, pods=2)
    assert scaled.shape == (2, 16, 16)
    assert make_scaled_mesh(64, model=8).shape == (8, 8)
    with pytest.raises(ValueError):
        make_scaled_mesh(100, model=16)


# ------------------------------------------------------------ the cells
@pytest.mark.parametrize("key", [f"{a}|{s}|{m}" for a, s, m in CELLS])
def test_cell_equals_reference(ref, built, key):
    """Plan, layouts, donations and bytes per device against the
    reference's compiled cell."""
    want, cell = ref[0]["built"][key], built[key]
    pl = cell.plan
    assert pl.param_rule == want["rule"]
    assert [pl.shard_experts, pl.shard_heads, pl.shard_kv_heads,
            pl.shard_ffn, pl.shard_vocab, pl.cache_seq_sharded] == \
        want["flags"]
    assert _specs(cell.in_layouts) == want["in_specs"]
    assert _specs(cell.out_layouts) == want["out_specs"]
    assert list(cell.donate_argnums) == want["donate"]
    mem = dryrun.memory(cell)
    assert mem["argument_size_in_bytes"] - _unread(cell) == want["arg"]
    assert mem["alias_size_in_bytes"] == want["alias"]
    n_out = len(_flat(cell.trace()[0]))
    assert mem["output_size_in_bytes"] + TUPLE_ENTRY * n_out == want["outb"]


def _unread(cell) -> int:
    """Bytes of the arguments the step never reads, which ``jax.jit``
    drops from the reference's program: the MLP pre-norms of SSD layers
    (no MLP follows them) and, in a decode step of a config whose layers
    read no position, the position."""
    n = 0
    if cell.kind == "train":
        return 0
    for key, t in _flat(cell.abstract_args[0]).items():
        if key.endswith("pre_norm_mlp") and "ssm" in _flat_keys(
                cell.abstract_args[0], key):
            lay = _flat(cell.in_layouts[0])[key]
            n += dryrun.local_bytes(t, lay)
    if cell.kind == "decode" and all(k == "ssm"
                                     for k in cell.cfg.attn_pattern):
        n += 4
    return n


def _flat_keys(params, key):
    """The keys beside ``key``'s leaf in its layer."""
    node = params
    for k in key.split("/")[:-1]:
        node = node[k]
    return set(node)


def _train_products_xla_merges(cfg, shape) -> float:
    """FLOPs of the products a reduced train step (remat "full", one flash
    block and one loss chunk of S positions) runs once more in the port
    than in the reference's compiled program:

    * the loss chunk's logits, 2·B·S·d·Vp: XLA computes them once for the
      forward and its checkpointed recomputation, which have the same
      inputs in one computation; ``torch.utils.checkpoint`` runs both;
    * per attention layer, QKᵀ, 2·B·H·S²·D: the remat forward's and the
      backward's own recomputation of it are one product in XLA's program
      at one block (the same q and k block in one loop body);
    * per dense MLP layer, the down projection, 2·B·S·d_ff·d: nothing in
      the backward reads its output in the recomputed forward, so XLA drops
      it; the port's checkpoint recomputes the layer whole. An MoE layer's
      expert outputs feed its gates' gradient, so both keep them."""
    from repro_torch.kernels.local_attention import block_size
    from repro_torch.models.transformer import LOSS_CHUNK
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    assert block_size(S) == S and S <= LOSS_CHUNK
    n = 2.0 * B * S * d * cfg.vocab_padded
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) in ("global", "local"):
            n += 2.0 * B * cfg.num_heads * S * S * cfg.head_dim
        if not cfg.is_moe_layer(i):
            n += 2.0 * B * S * cfg.d_ff * d
    return n


@pytest.mark.parametrize("arch", FLOP_ARCHS)
@pytest.mark.parametrize("kind", ["prefill_32k", "decode_32k", "train_4k"])
def test_flops_per_chip_against_hloparse(ref, built, arch, kind):
    key = f"{arch}|{kind}|1x1"
    got = built[key].trace()[1]
    want = ref[0]["built"][key]["flops"]
    if kind == "train_4k":
        cell = built[key]
        assert got - _train_products_xla_merges(cell.cfg, cell.shape) == \
            want, (got, want)
    else:
        assert abs(got / want - 1.0) <= FLOPS_TOL, got / want


# rules whose bf16 operands XLA's CPU program all-reduces in fp32 (its
# promoted reductions, ``clone_promoted``)
PROMOTED = ("row-parallel outputs", "expert outputs")
# mamba2's FSDP-cut SSD projections: XLA moves them onto the model axis by
# collective-permute and all-reduces partial sums, where the port gathers
# them over the data axis (2.1-10.5x the reference's all-gather bytes)
RESHARDED = ("mamba2-130m",)


def _operand_bytes(cell) -> dict:
    """The port's collectives in ``hloparse``'s measure: operand bytes per
    op, bf16 all-reduces at fp32 as XLA's CPU program runs them, gradient
    reduce-scatters among the all-reduces (the reference's program reduces
    gradients over the data axis by all-reduce)."""
    got = {op: 0.0 for op in dryrun.COLLECTIVES}
    for t in dryrun.collective_terms(cell, remat_policy="full",
                                     microbatches=1):
        scale = 4 / dryrun.ACT_BYTES if t.rule in PROMOTED else 1
        op = "all-reduce" if t.op == "reduce-scatter" else t.op
        got[op] += t.operand * t.times * scale
    return got


@pytest.mark.parametrize("key", [f"{a}|{s}|2x4" for a, s, m in CELLS
                                 if m == "2x4"])
def test_collective_bytes_against_hloparse(ref, built, key):
    """Per op against ``hloparse``'s bytes of the reference's program:
    all-gathers and all-reduces within ``COLL_FACTOR`` each (but in
    ``RESHARDED``), the total too. The port counts no all-to-all or
    collective-permute: in the reference's program these are resharding
    moves no spec names (the embedding lookup over a vocab-cut table, the
    K/V projections' layouts), at most ``UNNAMED_SHARE`` of its bytes."""
    want = dict(ref[0]["built"][key]["coll"])
    want["all-reduce"] += want.pop("reduce-scatter")
    got = _operand_bytes(built[key])
    assert got["all-to-all"] == got["collective-permute"] == 0
    assert 1 / COLL_FACTOR <= sum(got.values()) / sum(want.values()) \
        <= COLL_FACTOR, (got, want)
    by_op, counts = dryrun.collectives(built[key], remat_policy="full",
                                       microbatches=1)
    assert all(counts[op] > 0 for op, b in by_op.items() if b > 0)
    if key.split("|")[0] in RESHARDED:
        return
    for op in ("all-gather", "all-reduce"):
        assert 1 / COLL_FACTOR <= got[op] / want[op] <= COLL_FACTOR, \
            (op, got[op], want[op])
    unnamed = want["all-to-all"] + want["collective-permute"]
    assert unnamed <= UNNAMED_SHARE * sum(want.values()), unnamed


@pytest.mark.parametrize("arch,kind,seq,batch", SEQ_ROUTE)
def test_collective_bytes_on_the_sequence_route(ref, arch, kind, seq,
                                                batch):
    """At a length that takes the reference's sequence-sharded attention,
    its program keeps activations cut along the sequence over the model
    axis: where the port all-reduces a row-parallel product's output, it
    gathers the sequence before the next column-parallel product (a
    reduce-scatter and an all-gather of the same bytes as an all-reduce).
    So the all-gathers and all-reduces are held together, and the total,
    within ``COLL_FACTOR``; the unnamed moves as in the cells above."""
    from repro_torch.configs import ShapeConfig
    want = ref[0]["seq"][f"{arch}|{kind}"]
    cell = build_cell(arch + "-reduced", ShapeConfig(f"{kind}_{seq}", kind,
                                                     seq, batch),
                      TrainMesh(2, 4, device="meta"), remat_policy="full",
                      microbatches=1)
    got = _operand_bytes(cell)
    pair = ("all-gather", "all-reduce", "reduce-scatter")
    ratio = sum(got[op] for op in pair) / sum(want[op] for op in pair)
    assert 1 / COLL_FACTOR <= ratio <= COLL_FACTOR, (got, want)
    assert 1 / COLL_FACTOR <= sum(got.values()) / sum(want.values()) \
        <= COLL_FACTOR, (got, want)
    unnamed = want["all-to-all"] + want["collective-permute"]
    assert unnamed <= UNNAMED_SHARE * sum(want.values()), unnamed


@pytest.mark.parametrize("kind", ["decode_32k", "train_4k", "prefill_32k"])
def test_hbm_bytes_count_a_donated_buffer_once(built, kind):
    """The roofline's bytes: each argument read once, each output written
    once, but a donated argument's aliased output only as far as the step
    writes it: a decode step one position a row of every K/V leaf, a train
    step all of its parameters and moments; a prefill donates nothing."""
    cell = built[f"{ARCH}|{kind}|1x1"]
    cfg, mem = cell.cfg, dryrun.memory(cell)
    rows = cell.shape.global_batch
    written = {"decode_32k": cfg.num_layers * 2 * rows * cfg.num_kv_heads
               * cfg.head_dim * 2,                     # bf16 K and V
               "train_4k": mem["alias_size_in_bytes"],
               "prefill_32k": 0}[kind]
    assert dryrun.written_bytes(cell) == written
    assert dryrun.hbm_bytes(cell, mem) == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        - mem["alias_size_in_bytes"] + written)


@pytest.mark.parametrize("arch,shape,multi", FULL)
def test_full_size_record(ref, arch, shape, multi):
    """A full-size cell on the production mesh: its arguments' bytes per
    device equal the reference's shard sum. The arguments do not depend
    on the microbatches, so the train cell runs one (a quarter of the
    meta run's time)."""
    rec = dryrun.run_cell(arch, shape, multi, remat_policy="full",
                          microbatches=1)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == (512 if multi else 256)
    assert rec["memory"]["argument_size_in_bytes"] == \
        ref[0]["full"][f"{arch}|{shape}"]
    assert rec["memory"]["temp_size_in_bytes"] is None
    assert rec["bound"] in ("compute", "memory", "collective")
    assert math.isfinite(rec["roofline_fraction"])


def test_serve_partition_specs_read_the_plan():
    """The serving placement is the frozen plan's
    (``serve.shard.partition_specs``), never a re-run of the planner."""
    from repro_torch.core import plan as pplan
    from repro_torch.launch.cell import serve_partition_specs
    from repro_torch.serve import shard
    plan = pplan.plan_serve(get_config("mixtral-8x7b-reduced"),
                            hbm_budget_bytes=1 << 30, expected_batch=4,
                            expected_len_dist=[64, 128], mesh="tp=2,ep=2")
    got = serve_partition_specs(plan)
    assert got == shard.partition_specs(plan)
    assert got["kv_pages"]["spec"] == (None, None, "tp", None)
    assert got["experts"]["spec"] == ("ep", None, None)


def test_skipped_record():
    rec = dryrun.run_cell("qwen2.5-3b", "long_500k", False)
    assert rec["status"] == "skipped" and "500k" in rec["reason"]


@pytest.mark.parametrize("B,S,H,KV,D,window,chunk,offset,Sq", [
    (2, 300, 4, 2, 16, 300, 0, 0, 0), (1, 1024, 6, 2, 32, 100, 0, 0, 0),
    (2, 700, 4, 1, 16, 700, 128, 0, 0), (1, 1024, 4, 2, 16, 1024, 0, 256, 256),
    (1, 2048, 8, 2, 16, 300, 0, 512, 512)])
def test_meta_attention_counts_the_plain_schedule(B, S, H, KV, D, window,
                                                  chunk, offset, Sq):
    """On ``meta`` the plain sliding window and flash backward issue their
    block schedule's products at once: the same FLOPs (``FlopCounterMode``)
    as their block loops on the CPU, the same output shapes and dtypes.
    Causal, window, chunk and query-offset modes."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import flash_backward as fb
    from repro_torch.kernels import local_attention as la
    runs = []
    for dev in ("cpu", "meta"):
        g = torch.Generator().manual_seed(0)

        def draw(*shape):
            return torch.randn(*shape, generator=g).to(torch.bfloat16).to(dev)
        q, k, v = draw(B, Sq or S, H, D), draw(B, S, KV, D), draw(B, S, KV, D)
        with FlopCounterMode(display=False) as fwd:
            out, lse = la.sliding_window_attention_plain(
                q, k, v, window=window, chunk=chunk, return_lse=True,
                q_offset=offset)
        with FlopCounterMode(display=False) as bwd:
            grads = fb.flash_backward_plain(
                q, k, v, out.to(torch.bfloat16), lse, draw(B, Sq or S, H, D),
                window=window, chunk=chunk, q_offset=offset)
        runs.append((fwd.get_total_flops(), bwd.get_total_flops(),
                     [(tuple(t.shape), t.dtype) for t in (out, lse) + grads]))
    assert runs[0] == runs[1]


# ----------------------------------------------- the smaller module names
def test_dataflow_helpers_equal_reference(ref):
    want = ref[0]
    for k, w in want["tiling"].items():
        M, K, N, db, budget = map(int, k.split(","))
        if w == "refused":
            with pytest.raises(ValueError):
                dataflow.rs_matmul_tiling(M, K, N, db, budget)
            continue
        t = dataflow.rs_matmul_tiling(M, K, N, db, budget)
        assert [t.bm, t.bk, t.bn, t.vmem_bytes,
                dataflow.spad_fit_report(M * K * N, 0.75, t)] == w, k
    assert want["round_down"] == [dataflow._round_down(x, m) for x in (
        0, 1, 7, 8, 9, 127, 128, 300, 1000) for m in (8, 128)]
    assert want["kv"] == [[dataflow.paged_kv_tokens(ls, ps),
                           dataflow.dense_kv_tokens(len(ls), c)]
                          for ls in ([], [1], [5, 64, 65, 300],
                                     [0, 1000, 4097])
                          for ps in (1, 16, 64) for c in (64, 4096)]
    assert want["transient"] == [
        dataflow.prefill_kv_transient_bytes(b, s, kv, hd, n, db)
        for b in (1, 8) for s in (64, 4096) for kv in (2, 8)
        for hd in (64, 128) for n in (1, 36) for db in (1, 2)]
    assert want["consts"] == [dataflow.LANE, dataflow.SUBLANE,
                              dataflow.VMEM_BYTES]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_cache_equals_eval_shape(ref, arch):
    got = decoding.abstract_cache(get_config(arch + "-reduced"), 2, 64)
    assert all(t.device.type == "meta" for t in _flat(got).values())
    assert _shapes(got) == ref[0]["abstract_cache"][arch]


def test_dequantize_i8_bit_for_bit(ref):
    arrays = ref[1]
    got = decoding.dequantize_i8(torch.from_numpy(arrays["dq/q"]),
                                 torch.from_numpy(arrays["dq/scale"]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  arrays["dq/out"].view(np.int32))


# ----------------------------------------------------- the slice as a whole
def _cpu_cell(kind):
    """The cell the reference's numbers came from, on the CPU."""
    return build_cell(ARCH + "-reduced", reduced_shape(SHAPES[kind]),
                      TrainMesh(1, 1, device="cpu"), remat_policy="full",
                      microbatches=1)


def _params(arrays):
    return bridge.params_from_numpy(_unflatten(arrays, "p/"))


def _close(got, want, frac):
    got = got.float().numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= frac, err


def test_prefill_and_decode_cells_match_reference(ref):
    arrays = ref[1]
    params = _params(arrays)
    cell = _cpu_cell("prefill_32k")
    logits, cache = cell.fn(params, {"tokens": torch.from_numpy(
        arrays["pre/tokens"])})
    _close(logits, arrays["pre/logits"], LOGIT_TOL)
    got_shapes = {k: tuple(v.shape) for k, v in _flat(cache).items()}
    assert got_shapes == {k: tuple(v.shape) for k, v in _flat(
        cell.trace()[0][1]).items()}

    cell = _cpu_cell("decode_32k")
    # qwen2.5-3b's cache is bf16 K / V only, carried as fp32 numpy
    cache = _bf16(bridge.params_from_numpy(_unflatten(arrays, "cache/")))
    logits, _ = cell.fn(params, cache, {"tokens": torch.from_numpy(
        arrays["dec/tokens"])}, torch.tensor(40, dtype=torch.int32))
    _close(logits, arrays["dec/logits"], LOGIT_TOL)


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


def test_train_cell_first_step_matches_reference(ref):
    out, arrays = ref
    params = _params(arrays)
    cell = _cpu_cell("train_4k")
    batch = {"tokens": torch.from_numpy(arrays["train/tokens"]),
             "labels": torch.from_numpy(arrays["train/labels"])}
    _, _, metrics = cell.fn(params, popt.init_adamw(params), batch)
    loss = float(metrics["loss"])
    assert abs(loss - out["train_loss"]) <= LOSS_TOL * abs(out["train_loss"])
