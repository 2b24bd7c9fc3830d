"""The port's multi-device training against the reference on the CPU.

The port runs every shard of a mesh in one process; the reference runs its
multi-device side on eight host devices, in one subprocess for this file
(``XLA_FLAGS=--xla_force_host_platform_device_count=8`` must be set before
JAX starts, as in ``tests/test_seqshard.py``), whose results a
module-scoped fixture loads from an npz. Inputs are numpy-seeded; weights
are the port's ``init_params`` given to both sides as numpy. The
reference's programs compile with XLA's excess precision off, as in
``tests/test_torch_train.py``. Tolerances, and why:

* spec trees (params, caches, batches) and the hints' specs: equal, leaf
  for leaf;
* sequence-sharded attention in the plain versions against one launch
  over every row: forward, log-sum-exp and dq bit for bit (each row's
  blocks and sums are the same); dk and dv within ``SHARD_DKV_TOL`` (1e-5)
  of their max, the shards' fp32 shares summed in shard order;
* the hinted step on data=2, model=4 at S 512 against the reference's
  (its hints set around the trace, as ``launch/cell.py`` sets them:
  sequence-sharded attention under ``shard_map``, and pins that XLA
  answers by partitioning the products over the mesh, another order of
  sums and roundings than the port's whole products): the training
  tolerances of ``tests/test_torch_train.py``, the loss within
  ``LOSS_TOL`` (1e-4) relative and every gradient leaf within
  ``GRAD_TOL`` (2e-2) of its max |value|;
* the compressed DP step at dp=4: the loss within ``LOSS_TOL``, the
  first moment (the clipped gradient times 1 - b1) of every leaf within
  ``GRAD_TOL`` of its max (an int8 rounding that a bf16-level gradient
  difference flips moves a payload by one step, ~1/127 of its max);
* an elastic restore of either package's checkpoint by the other: the
  values equal, the specs the re-plan's.
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES, get_config as rget_config
from repro.core import planner as rplanner
from repro.data import pipeline as rdata
from repro.models import decoding as rdecoding
from repro.models import transformer as rtfm
from repro.sharding import autoshard as rautoshard

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import planner
from repro_torch.data import pipeline as pdata
from repro_torch.kernels import flash_backward as pfb
from repro_torch.kernels import local_attention as pswa
from repro_torch.launch import train as plaunch
from repro_torch.models import decoding as pdecoding
from repro_torch.models import layers as players
from repro_torch.models import transformer as ptfm
from repro_torch.runtime import elastic
from repro_torch.sharding import autoshard, specs
from repro_torch.sharding.mesh import TrainMesh, mesh_desc
from repro_torch.sharding.specs import P
from repro_torch.train import grad_compression as gc
from repro_torch.train import loop as ploop
from repro_torch.train import optimizer as popt

LOSS_TOL = 1e-4
GRAD_TOL = 2e-2
SHARD_DKV_TOL = 1e-5
QWEN, GEMMA = "qwen2.5-3b-reduced", "gemma2-2b-reduced"
SEQ, BATCH = 512, 2            # the hinted step: S // model = 128 rows
DP_SEQ, DP = 64, 4             # the compressed step: one row a replica
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint.manager import CheckpointManager
from repro.configs import get_config
from repro.configs.shapes import ShapeConfig
from repro.core import planner
from repro.launch.cell import mesh_desc
from repro.models import layers, transformer as tfm
from repro.runtime import elastic
from repro.sharding import autoshard
from repro.train import grad_compression, loop, optimizer as opt_lib

try:
    from jax.sharding import AxisType
    kw = lambda n: {"axis_types": (AxisType.Auto,) * n}
except ImportError:
    kw = lambda n: {}
STRICT = {"xla_allow_excess_precision": False}
d = sys.argv[1]
inp = dict(np.load(os.path.join(d, "in.npz")))
out = {}

def tree(prefix):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node = t
            *path, leaf = k[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return t

def entry(e):
    for attr in ("key", "name", "idx"):
        if hasattr(e, attr):
            return str(getattr(e, attr))
    return str(e)

def put(prefix, t):
    for (path, leaf) in jax.tree_util.tree_flatten_with_path(t)[0]:
        out[prefix + "/".join(entry(e) for e in path)] = np.asarray(leaf)

mesh = jax.make_mesh((2, 4), ("data", "model"), **kw(2))
for arch in ("qwen2.5-3b-reduced", "gemma2-2b-reduced"):
    cfg = get_config(arch)
    params, batch = tree(f"p/{arch}/"), tree(f"b/{arch}/")
    B, S = batch["tokens"].shape
    plan = planner.plan_model(cfg, ShapeConfig("t", "train", S, B),
                              mesh_desc(mesh))
    hints = autoshard.make_hints(plan, mesh, B)
    vg = jax.value_and_grad(lambda p, b: tfm.loss_fn(
        p, b, cfg, hints=hints), has_aux=True)
    token = layers.set_hints(hints)
    try:
        (loss, metrics), grads = jax.jit(vg, compiler_options=STRICT)(
            params, batch)
    finally:
        layers.reset_hints(token)
    out[f"hinted/{arch}/loss"] = np.asarray(loss)
    put(f"hinted/{arch}/metrics/", metrics)
    put(f"hinted/{arch}/grads/", grads)

# the compressed DP step at dp=4
arch = "qwen2.5-3b-reduced"
cfg = get_config(arch)
dmesh = jax.make_mesh((4,), ("data",), devices=jax.devices()[:4], **kw(1))
params, batch = tree(f"p/{arch}/"), tree("dp/")
ef = grad_compression.init_error_feedback(dmesh, params)
step = grad_compression.make_compressed_dp_train_step(
    dmesh, lambda p, b: tfm.loss_fn(p, b, cfg), opt_lib.OptimizerConfig())
p1, o1, ef1, m1 = jax.jit(step, compiler_options=STRICT)(
    params, opt_lib.init_adamw(params), batch, ef)
put("dp/metrics/", m1)
put("dp/mu/", o1.mu)
put("dp/ef/", ef1)

# elastic: the port's checkpoint onto this mesh; this package's own
shape = ShapeConfig("t", "train", 64, 8)
abstract = loop.abstract_train_state(cfg)
state, _ = elastic.restore_elastic(CheckpointManager(os.path.join(
    d, "port_ckpt")), abstract, cfg, shape, mesh)
put("elastic/", state)
specs = {}
for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
    name = "__".join(entry(e) for e in path)
    specs[name] = [list(x) if isinstance(x, tuple) else x
                   for x in tuple(leaf.sharding.spec)]
out["elastic_specs"] = np.asarray(json.dumps(specs))
mine = loop.init_train_state(jax.random.PRNGKey(7), cfg)
CheckpointManager(os.path.join(d, "ref_ckpt")).save(5, mine)
put("mine/", mine)
np.savez(os.path.join(d, "out.npz"), **out)
print("REF_OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{pre}{k}/"))
        return out
    return {pre[:-1]: tree}


def _init(arch, seed=0):
    return ptfm.init_params(get_config(arch),
                            torch.Generator().manual_seed(seed), "cpu")


def _batch(arch, seq, batch):
    return {k: v for k, v in rdata.batch_for_arch(
        rget_config(arch), seq, batch, 0).items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's results on eight host devices (see ``_REF``)."""
    d = tmp_path_factory.mktemp("mesh_train")
    inp = {}
    for arch in (QWEN, GEMMA):
        for k, v in _flat(_numpy(_init(arch))).items():
            inp[f"p/{arch}/{k}"] = v
        for k, v in _batch(arch, SEQ, BATCH).items():
            inp[f"b/{arch}/{k}"] = v
    for k, v in _batch(QWEN, DP_SEQ, DP).items():
        inp[f"dp/{k}"] = v
    np.savez(d / "in.npz", **inp)
    params = _init(QWEN, seed=3)
    CheckpointManager(str(d / "port_ckpt")).save(
        3, (params, popt.init_adamw(params)))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF, str(d)], env=env,
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert "REF_OK" in r.stdout, r.stdout + r.stderr[-4000:]
    return dict(np.load(d / "out.npz")), d


def _assert_grads_close(grads, ref_out, prefix):
    got = {k: v.numpy() for k, v in _flat(grads).items()}
    want = {k[len(prefix):]: v for k, v in ref_out.items()
            if k.startswith(prefix)}
    assert got.keys() == want.keys()
    for name, w in want.items():
        err = np.abs(got[name] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (name, err)


# ------------------------------------------------------------- spec trees
def _ref_specs(spec_tree):
    from jax.sharding import PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(e.key) for e in p): tuple(s) for p, s in flat}


def _port_specs(spec_tree):
    return {k: tuple(v) for k, v in _flat(spec_tree).items()}


MESH_AXES = {"data": 16, "model": 16}
MESH_AXES_MP = {"pod": 2, "data": 16, "model": 16}


def _plans(arch, shape_name, mesh_axes):
    rshape = SHAPES[shape_name]
    md = dict(pod=mesh_axes.get("pod", 1), data=mesh_axes["data"],
              model=mesh_axes["model"])
    shape = planner.ShapeConfig(rshape.name, rshape.kind, rshape.seq_len,
                                rshape.global_batch)
    return (planner.plan_model(get_config(arch), shape, planner.MeshDesc(**md)),
            rplanner.plan_model(rget_config(arch), rshape,
                                rplanner.MeshDesc(**md)))


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x7b", "mamba2-130m",
                                  "recurrentgemma-2b", "musicgen-large",
                                  "llama4-maverick-400b-a17b"])
@pytest.mark.parametrize("mesh_axes", [MESH_AXES, MESH_AXES_MP])
def test_param_specs_equal_reference(arch, mesh_axes):
    """``autoshard.param_specs`` over ``abstract_params`` (meta tensors)
    against the reference's over ``jax.eval_shape``, leaf for leaf, at the
    plan both planners give for train_4k (the rule fields do not depend on
    the device rates)."""
    plan, rplan = _plans(arch, "train_4k", mesh_axes)
    for field in ("param_rule", "shard_experts", "shard_heads",
                  "shard_kv_heads", "shard_ffn", "shard_vocab", "act_axes"):
        assert getattr(plan, field) == getattr(rplan, field), field
    got = _port_specs(autoshard.param_specs(
        ptfm.abstract_params(get_config(arch)), plan, mesh_axes))
    want = _ref_specs(rautoshard.param_specs(
        rtfm.abstract_params(rget_config(arch)), rplan, mesh_axes))
    assert got == want


@pytest.mark.parametrize("arch,shape", [("gemma2-2b", "decode_32k"),
                                        ("mamba2-130m", "decode_32k"),
                                        ("gemma3-12b", "decode_32k"),
                                        ("gemma3-12b", "long_500k")])
def test_cache_specs_equal_reference(arch, shape):
    """``cache_spec`` over the port's cache on the meta device against the
    reference's over ``abstract_cache``, leaf for leaf (B=1 at long_500k
    spreads the KV sequence over the dp and model axes)."""
    plan, rplan = _plans(arch, shape, MESH_AXES)
    B, T = SHAPES[shape].global_batch, SHAPES[shape].seq_len
    got = _port_specs(autoshard.cache_spec(
        pdecoding.init_cache(get_config(arch), B, T, "meta"), plan,
        MESH_AXES))
    want = _ref_specs(rautoshard.cache_spec(
        rdecoding.abstract_cache(rget_config(arch), B, T), rplan, MESH_AXES))
    assert got == want


@pytest.mark.parametrize("B", [1, 7, 32, 256])
def test_batch_specs_and_hints_equal_reference(B):
    """``batch_spec``, ``act_batch_axes`` and ``make_hints``' specs and
    fields against the reference's, for a dense and an all-SSM plan (whose
    tokens go over every axis) on the multi-pod mesh."""
    mesh = SimpleNamespace(axis_names=("pod", "data", "model"),
                           devices=np.empty((2, 16, 16)))
    pmesh = TrainMesh(pod=2, data=16, model=16, device="cpu")
    for arch in ("gemma2-2b", "mamba2-130m"):
        plan, rplan = _plans(arch, "train_4k", MESH_AXES_MP)
        batch = {"tokens": np.zeros((B, 7), np.int32),
                 "labels": np.zeros((B, 7), np.int32)}
        got = _port_specs(autoshard.batch_spec(batch, plan, MESH_AXES_MP))
        want = _ref_specs(rautoshard.batch_spec(
            {k: jax.ShapeDtypeStruct(v.shape, jnp.int32)
             for k, v in batch.items()}, rplan, MESH_AXES_MP))
        assert got == want
        h = autoshard.make_hints(plan, pmesh, B)
        rh = rautoshard.make_hints(rplan, mesh, B)
        assert (tuple(h.act), tuple(h.logits), h.model_size, h.tp) == (
            tuple(rh.act), tuple(rh.logits), rh.model_size, rh.tp)


# --------------------------------------------------- sequence-sharded flash
SHARD_CASES = {     # B, S, H, KV, D, window, chunk, softcap, shards
    "causal R2, 4 shards": (2, 512, 4, 2, 16, 512, 0, 0.0, 4),
    "causal R8, shard < block": (1, 1024, 16, 2, 16, 1024, 0, 0.0, 8),
    "window softcap, 2 shards": (1, 1024, 4, 1, 32, 300, 0, 30.0, 2),
    "chunk R3, 4 shards": (1, 512, 6, 2, 16, 512, 96, 0.0, 4),
}


@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_seq_sharded_plain_equals_one_launch(case):
    """The plain forward and backward over ``shards`` slices of the query
    rows at their offsets (``q_offset``) against one call over every row:
    out, lse and dq bit for bit; dk and dv, the shards' shares summed in
    order, within ``SHARD_DKV_TOL``. ``models.flash.flash_attention`` with
    ``shards`` gives the same (its dK / dV summed once in fp32)."""
    B, S, H, KV, D, window, chunk, cap, n = SHARD_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()
    q, do = bf16(B, S, H, D), bf16(B, S, H, D)
    k, v = bf16(B, S, KV, D), bf16(B, S, KV, D)
    kw = dict(window=window, chunk=chunk, softcap=cap)
    out, lse = pswa.sliding_window_attention_plain(q, k, v, return_lse=True,
                                                   **kw)
    o16 = out.bfloat16()
    dq, dk, dv = pfb.flash_backward_plain(q, k, v, o16, lse, do, **kw)
    L = S // n
    parts = []
    for i in range(n):
        rows = slice(i * L, (i + 1) * L)
        o_i, l_i = pswa.sliding_window_attention_plain(
            q[:, rows], k, v, return_lse=True, q_offset=i * L, **kw)
        assert torch.equal(o_i, out[:, rows]) and torch.equal(l_i, lse[:, rows])
        parts.append(pfb.flash_backward_plain(
            q[:, rows], k, v, o16[:, rows], lse[:, rows], do[:, rows],
            q_offset=i * L, **kw))
    assert torch.equal(torch.cat([p[0] for p in parts], 1), dq)
    for i, want in ((1, dk), (2, dv)):
        got = parts[0][i]
        for p in parts[1:]:
            got = got + p[i]
        assert float((got - want).abs().max()) \
            <= SHARD_DKV_TOL * float(want.abs().max())
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    from repro_torch.models import flash as pflash
    o = pflash.flash_attention(qs, ks, vs, shards=n, **kw)
    o.backward(do)
    assert torch.equal(o, o16)
    assert torch.equal(qs.grad, dq.bfloat16())
    assert float((ks.grad.float() - dk).abs().max()) \
        <= 2 ** -7 * float(dk.abs().max())


def test_reference_shard_schedule_below_a_block():
    """Shards shorter than flash's block take the reference's block
    schedule as its ``_flash_call`` gives it (q blocks of min(block, S //
    model), ``_offsets`` counted for them): in window mode a q block that
    starts a kv block then visits one kv block too few, as the reference's
    does (S 1024, window 300, 8 shards of 128: the rows from 512 lose the
    keys before 512). The plain version repeats it, bit for bit the
    reference's shard in fp32 but for exp and sums (1e-6 of max |out|),
    and both part from one call over every row; the kernels do not."""
    from repro.models import flash as rflash
    qb, kb, nq, causal, visits = pswa.band_schedule(1024, 300, 0, 128, 512)
    assert (qb, kb, nq, causal) == (128, 512, 1, False)
    assert visits(0) == [512]
    assert pswa.band_schedule(1024, 300, 0)[4](1) == [512, 0]
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((1, 1024, 1, 16)).astype(np.float32)
               for _ in range(3))
    t = lambda a: torch.from_numpy(a).bfloat16()           # noqa: E731
    shard = pswa.sliding_window_attention_plain(
        t(q[:, 512:640]), t(k), t(v), window=300, q_offset=512)
    whole = pswa.sliding_window_attention_plain(t(q), t(k), t(v),
                                                window=300)[:, 512:640]
    bq, bk, bv = (jnp.asarray(a, jnp.bfloat16).transpose(0, 2, 1, 3)
                  for a in (q, k, v))
    want = rflash._fwd_impl(bq[:, :, None, 512:640], bk, bv,
                            jnp.arange(512, 640, dtype=jnp.int32), "window",
                            300, 0.0, 128, 512)[0]
    want = np.asarray(want)[:, :, 0].transpose(0, 2, 1, 3)
    np.testing.assert_allclose(shard.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert float((shard - whole).abs().max()) > 1e-2


# ------------------------------------------------------------ hinted step
def _hints(arch, mesh):
    plan = planner.plan_model(get_config(arch), planner.ShapeConfig(
        "t", "train", SEQ, BATCH), mesh_desc(mesh))
    return autoshard.make_hints(plan, mesh, BATCH)


@pytest.fixture(scope="module")
def hinted():
    """The port's hinted loss, metrics and gradients on data=2, model=4,
    and the number of plain attention calls a forward makes."""
    mesh = TrainMesh(data=2, model=4, device="cpu")
    out = {}
    for arch in (QWEN, GEMMA):
        hints = _hints(arch, mesh)
        assert players.seq_shards(SEQ, 4, 2) == 1      # no hints active
        calls = []
        real = pswa.sliding_window_attention_plain

        def counted(*a, **kw):
            calls.append(kw.get("q_offset", 0))
            return real(*a, **kw)
        pswa.sliding_window_attention_plain = counted
        try:
            loss, metrics, grads = ploop.value_and_grad(
                ploop.make_loss_fn(get_config(arch), "none", hints),
                _init(arch), pdata.to_torch(_batch(arch, SEQ, BATCH)))
        finally:
            pswa.sliding_window_attention_plain = real
        out[arch] = (float(loss), {k: float(v) for k, v in metrics.items()},
                     grads, calls)
    return out


@pytest.mark.parametrize("arch", [QWEN, GEMMA])
def test_hinted_step_matches_reference(ref, hinted, arch):
    """The port's step under ``make_hints`` on data=2, model=4 (every
    attention layer sequence-sharded in 4: 2 KV heads do not divide 4)
    against the reference's hinted step: the loss and metrics at
    ``LOSS_TOL``, every gradient leaf at ``GRAD_TOL``."""
    out, _ = ref
    loss, metrics, grads, calls = hinted[arch]
    layers = get_config(arch).num_layers
    assert calls == [i * SEQ // 4 for i in range(4)] * layers
    np.testing.assert_allclose(loss, out[f"hinted/{arch}/loss"],
                               rtol=LOSS_TOL)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, out[f"hinted/{arch}/metrics/{k}"],
                                   rtol=LOSS_TOL, atol=1e-7)
    _assert_grads_close(grads, out, f"hinted/{arch}/grads/")


def test_hints_change_only_attention_sharding():
    """Under the hints the forward's loss is the unhinted one bit for bit
    (each row's attention is the same sums); without tensor parallelism
    (``tp`` off) or with heads that divide the model axis, attention is
    not sharded."""
    cfg = get_config(QWEN)
    params, batch = _init(QWEN), pdata.to_torch(_batch(QWEN, SEQ, BATCH))
    mesh = TrainMesh(data=2, model=4, device="cpu")
    hints = _hints(QWEN, mesh)
    with torch.no_grad():
        a, _ = ptfm.loss_fn(params, batch, cfg, hints=hints)
        b, _ = ptfm.loss_fn(params, batch, cfg)
    assert torch.equal(a, b)
    with players.hints_context(hints):
        assert players.seq_shards(SEQ, 4, 2) == 4
        assert players.seq_shards(SEQ, 8, 4) == 1        # 4 divides both
        assert players.seq_shards(256, 4, 2) == 1        # 64 rows a shard
    import dataclasses
    with players.hints_context(dataclasses.replace(hints, tp=False)):
        assert players.seq_shards(SEQ, 4, 2) == 1


# ------------------------------------------------------ compressed DP step
def test_compressed_dp_step_matches_reference(ref):
    """``make_compressed_dp_train_step`` at dp=4 (one row of 64 tokens a
    replica) against the reference's under ``shard_map`` on four devices:
    the loss and metrics at ``LOSS_TOL``, each leaf's first moment after
    the step (the clipped, dequantized gradient sum times 1 - b1) at
    ``GRAD_TOL`` of its max; the error-feedback buffers finite, nonzero
    and (n_dp, ...) per leaf."""
    out, _ = ref
    cfg = get_config(QWEN)
    mesh = TrainMesh(data=DP, device="cpu")
    params = _init(QWEN)
    opt = popt.init_adamw(params)
    ef = gc.init_error_feedback(mesh, params)
    step = gc.make_compressed_dp_train_step(
        mesh, ploop.make_loss_fn(cfg, "none"), popt.OptimizerConfig())
    _, opt, ef, m = step(params, opt, pdata.to_torch(_batch(QWEN, DP_SEQ,
                                                            DP)), ef)
    for k in ("loss", "loss_total", "grad_norm", "accuracy"):
        np.testing.assert_allclose(float(m[k]), out[f"dp/metrics/{k}"],
                                   rtol=LOSS_TOL, atol=1e-7)
    _assert_grads_close(opt.mu, out, "dp/mu/")
    for name, e in _flat(ef).items():
        assert e.shape[0] == DP and bool(torch.isfinite(e).all())
        assert float(e.abs().max()) > 0, name
    assert gc.payload_bytes(params, DP) == DP * sum(
        p.numel() + 4 for p in popt.leaves(params))


# ---------------------------------------------------------------- elastic
def test_reference_restores_the_ports_checkpoint_elastically(ref):
    """The port's checkpoint restored by the reference's
    ``restore_elastic`` on data=2, model=4: the values equal, and the
    restored arrays' specs equal the port's re-plan for the same mesh."""
    out, d = ref
    cfg = get_config(QWEN)
    mesh = TrainMesh(data=2, model=4, device="cpu")
    abstract = ploop.abstract_train_state(cfg)
    state, manifest = elastic.restore_elastic(
        CheckpointManager(str(d / "port_ckpt")), abstract, cfg,
        planner.ShapeConfig("t", "train", 64, 8), mesh)
    assert manifest["step"] == 3
    params = _init(QWEN, seed=3)
    for name, v in _flat(params).items():
        assert np.array_equal(out[f"elastic/0/{name}"], v.numpy())
        assert torch.equal(_flat(state[0])[name], v)
    want = json.loads(str(out["elastic_specs"]))
    p_specs, o_specs = manifest["specs"]
    got = {f"0__{k.replace('/', '__')}": v
           for k, v in _port_specs(p_specs).items()}
    got.update({f"1__mu__{k.replace('/', '__')}": v
                for k, v in _port_specs(o_specs.mu).items()})
    got.update({f"1__nu__{k.replace('/', '__')}": v
                for k, v in _port_specs(o_specs.nu).items()})
    got["1__step"] = tuple(o_specs.step)

    def norm(spec):      # trailing Nones are the same placement
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)
    assert {k: norm(v) for k, v in got.items()} == \
        {k: norm(v) for k, v in want.items()}


def test_port_restores_the_references_checkpoint_elastically(ref):
    """The reference's checkpoint restored by the port's
    ``restore_elastic`` at data=1 and at data=2, model=4: the values the
    reference saved, on the mesh's device."""
    out, d = ref
    cfg = get_config(QWEN)
    for mesh in (TrainMesh(device="cpu"),
                 TrainMesh(data=2, model=4, device="cpu")):
        state, manifest = elastic.restore_elastic(
            CheckpointManager(str(d / "ref_ckpt")),
            ploop.abstract_train_state(cfg), cfg,
            planner.ShapeConfig("t", "train", 64, 8), mesh)
        assert manifest["step"] == 5
        for name, v in _flat(state[0]).items():
            assert v.device.type == "cpu"
            assert np.array_equal(v.numpy(), out[f"mine/0/{name}"])
        for name, v in _flat(state[1].mu).items():
            assert np.array_equal(v.numpy(), out[f"mine/1/mu/{name}"])


def test_restore_checks_each_layout(tmp_path):
    """A layout that does not divide its leaf is refused; the abstract
    state holds no memory."""
    cfg = get_config(QWEN)
    params = _init(QWEN)
    ck = CheckpointManager(str(tmp_path))
    ck.save(0, (params, popt.init_adamw(params)))
    abstract = ploop.abstract_train_state(cfg)
    assert all(t.device.type == "meta" for t in popt.leaves(abstract[0]))
    mesh = TrainMesh(data=3, device="cpu")

    def every(spec):
        return popt.map_tree(lambda _: spec, abstract[0])
    bad = specs.tree_named(mesh, (every(P("data")), type(abstract[1])(
        step=P(), mu=every(P()), nu=every(P()))))
    with pytest.raises(ValueError, match="does not divide"):
        ck.restore(abstract, shardings=bad)


def test_launch_train_plans_a_mesh_and_passes_hints(monkeypatch, tmp_path,
                                                    capsys):
    """``launch.train`` builds the mesh over the devices there are, plans
    the model for it and, on a mesh of more than one device, passes the
    hints to the step (a logical data=2, model=4 mesh here)."""
    seen = {}
    real = ploop.make_train_step

    def spy(*a, **kw):
        seen["hints"] = kw.get("hints")
        return real(*a, **kw)
    monkeypatch.setattr(plaunch, "make_local_mesh",
                        lambda device: TrainMesh(data=2, model=4,
                                                 device=device))
    monkeypatch.setattr(plaunch.train_loop, "make_train_step", spy)
    plaunch.main(["--arch", "qwen2.5-3b", "--reduced", "--device", "cpu",
                  "--steps", "1", "--batch", "2", "--seq", "512",
                  "--ckpt-dir", str(tmp_path)])
    assert "done: 1 steps" in capsys.readouterr().out
    h = seen["hints"]
    assert h.model_size == 4 and tuple(h.act) == ("data", None, None)


# ------------------------------------------------ examples and dev harness
NEW_ENTRY_POINTS = ("examples/torch_train_lm.py", "examples/torch_quickstart.py",
                    "scripts/smoke_models_torch.py",
                    "scripts/ab_attention_torch.py")


def _load(relpath):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.basename(relpath)[:-3], os.path.join(ROOT, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("relpath", NEW_ENTRY_POINTS)
def test_entry_points_import_no_jax_or_reference(relpath):
    """The port's training examples and harnesses stand alone, as
    ``tests/test_torch_imports.py`` holds the package."""
    import ast
    tree = ast.parse(open(os.path.join(ROOT, relpath)).read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names] + [n.module for n in ast.walk(tree)
                                 if isinstance(n, ast.ImportFrom)
                                 and n.level == 0]
    assert not [m for m in mods if m.split(".")[0] in
                ("jax", "jaxlib", "repro")], mods


def test_examples_and_harness_run_on_the_cpu(tmp_path, capsys):
    """``examples/torch_quickstart.py`` (planner on the local mesh, 8
    steps, ``DecodeEngine`` from the trained weights),
    ``examples/torch_train_lm.py`` (a step under the Supervisor) and
    ``scripts/smoke_models_torch.py`` (two archs' loss, prefill and a
    decode step) with ``--device cpu``."""
    out = _load("examples/torch_quickstart.py").main(["--device", "cpu"])
    assert len(out) == 8
    result = _load("examples/torch_train_lm.py").main(
        ["--device", "cpu", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert len(result["metrics"]) == 1 and result["restarts"] == 0
    assert _load("scripts/smoke_models_torch.py").main(
        ["--device", "cpu", "gemma2-2b", "musicgen-large"]) == 0
    text = capsys.readouterr().out
    assert "decoded:" in text and text.count("OK ") == 2
