"""Sharded serving in the port against the reference on the CPU.

The mesh stage of the plan (``core.plan``: ``tp`` KV-head shards, ``ep``
expert shards), the serve mesh and the sharded page pool
(``serve.shard``), the shard-by-shard decode math
(``sharding.tensor_parallel``), the HM-mesh planner (``core.planner``),
the NoC modes (``core.hmmesh``) and the serve CLI (``launch.serve``):

* plans (``to_json()`` and ``explain()`` at ``TPU_V5E`` rates), their
  ``ValueError``s, the sharded snapshots, the planner's layer and model
  choices: equal to the reference's;
* the sharded pool's lockstep, divergence, gauges and byte accounting, the
  collective model: the reference's values;
* each sharded function equal to its unsharded call bit for bit (the plain
  versions: the tensors lie on the CPU);
* the slice as a whole: ``LLM.stream`` of ``gemma2-2b-reduced`` at tp=2 and
  ``mixtral-8x7b-reduced`` at ep=4 on the reference's weights, bridged,
  equal to the port's tp=1 stream bit for bit and to the reference's
  sharded stream token for token (a parting allowed only at a reference
  near-tie, ``torch_dense_parity.compare_streams``); the sharding report,
  metrics and trace signature equal to the reference's.

The reference's serving runs compile with XLA's excess precision off (as
``test_torch_moe.py`` explains) and are shared in a module-scoped fixture.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES
from repro.configs import get_config as rget_config
from repro.core import hmmesh as rhmmesh
from repro.core import plan as rplan
from repro.core import planner as rplanner
from repro.core import reuse as rreuse
from repro.models import transformer as rtfm
from repro.serve import LLM as RLLM
from repro.serve import shard as rshard
from repro.serve import telemetry as rtelemetry

from repro_torch import bridge
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import hmmesh, planner
from repro_torch.core import plan as pplan
from repro_torch.core import reuse
from repro_torch.core.eyexam import TPU_V5E
from repro_torch.kernels import ops as pops
from repro_torch.models import layers as players
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as ptfm
from repro_torch.serve import LLM, DecodeEngine, shard, telemetry
from repro_torch.serve import engine as peng
from repro_torch.serve.paging import PageAllocator
from repro_torch.sharding import tensor_parallel as tpar
import torch_dense_parity as tdp
from test_torch_moe import _strict_reference
from test_torch_recurrent import _HostReads

GEMMA2, MIXTRAL = "gemma2-2b-reduced", "mixtral-8x7b-reduced"
PLAN_KW = dict(hbm_budget_bytes=1 << 30, expected_batch=3,
               expected_len_dist={"mean": 10, "max": 64}, page_size=4,
               sync_every=4)
# the reference's acceptance runs (tests/test_shard_serve.py)
STREAMS = {
    GEMMA2: ("tp=2", 0, [([5, 7, 11], 12), ([3, 2, 9, 4], 10)]),
    MIXTRAL: ("ep=4", 1, [([5, 7, 11], 10), ([3, 2, 9, 4], 8)]),
}


def _outcome(fn):
    """("ok", value) or ("raises", exception type name, message)."""
    try:
        return "ok", fn()
    except Exception as e:
        return "raises", type(e).__name__, str(e)


def _plans(arch, mesh, **kw):
    return (rplan.plan_serve(rget_config(arch), mesh=mesh, **{**PLAN_KW,
                                                              **kw}),
            pplan.plan_serve(get_config(arch), mesh=mesh, rates=TPU_V5E,
                             **{**PLAN_KW, **kw}))


# -------------------------------------------------------------- the plan
@pytest.mark.parametrize("arch,mesh", [
    (GEMMA2, "tp=3"), (GEMMA2, "ep=2"), (MIXTRAL, "ep=3"),
    ("mamba2-130m-reduced", "tp=2")])
def test_mesh_validation_matches_reference(arch, mesh):
    """The reference's plan-time ``ValueError``s, message for message."""
    want = _outcome(lambda: rplan.plan_serve(rget_config(arch), mesh=mesh,
                                             **PLAN_KW))
    got = _outcome(lambda: pplan.plan_serve(get_config(arch), mesh=mesh,
                                            **PLAN_KW))
    assert want[:2] == ("raises", "ValueError") and got == want


def test_drain_engine_refuses_a_mesh():
    """The drain engine is single-device: ``plan_for_engine``,
    ``DecodeEngine`` and ``LLM.generate`` raise the reference's
    ``ValueError`` for a mesh; ``LLM.stream`` serves it."""
    rcfg, cfg = rget_config(GEMMA2), get_config(GEMMA2)
    want = _outcome(lambda: rplan._resolve(
        rcfg, rcfg.name, 2, 64, mean_len=10, page_size=4, num_pages=None,
        attn_path="paged", share_prefix=None, kv_quant=None, sync_every=4,
        sparsity_stats=None, drain_only=True, mesh="tp=2"))
    assert want[:2] == ("raises", "ValueError")
    assert _outcome(lambda: pplan.plan_for_engine(
        cfg, slots=2, cache_len=64, mesh="tp=2")) == want
    plan = pplan.plan_serve(cfg, mesh="tp=2", **PLAN_KW)
    assert _outcome(lambda: DecodeEngine(cfg, {}, plan, device="cpu")) == want
    params = ptfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    llm = LLM(cfg, params, plan, device="cpu")
    assert _outcome(lambda: llm.generate([([1, 2], 2)])) == want
    assert len(llm.stream([([1, 2], 2)])[0].out) == 2


@pytest.mark.parametrize("arch,mesh", [(GEMMA2, "tp=2"), (MIXTRAL, "ep=4"),
                                       (MIXTRAL, "tp=2,ep=2"),
                                       ("qwen2.5-3b-reduced", "tp=2")])
def test_sharded_plan_matches_reference(arch, mesh):
    """Every dispatch field and decision (mesh, NoC modes, pool shard),
    the rendered report, and ``replan_from_lengths`` keeping the mesh."""
    ref, mine = _plans(arch, mesh)
    assert mine.sharded and mine.mesh_devices == ref.mesh_devices
    assert mine.to_json() == ref.to_json()
    assert mine.explain() == ref.explain()
    lengths = [20, 30, 40, 50] * 8
    assert pplan.replan_from_lengths(get_config(arch), mine, lengths,
                                     rates=TPU_V5E).to_json() == \
        rplan.replan_from_lengths(rget_config(arch), ref, lengths).to_json()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_sharded_snapshots_match_reference(arch):
    """``snapshot_sharded_plan`` at both snapshot meshes: the reference's
    plan where it resolves one, its exception where it refuses."""
    assert pplan.SHARDED_SNAPSHOT_CONFIGS == rplan.SHARDED_SNAPSHOT_CONFIGS
    assert pplan.SHARDED_SNAPSHOT_MESHES == rplan.SHARDED_SNAPSHOT_MESHES
    for mesh in pplan.SHARDED_SNAPSHOT_MESHES:
        want = _outcome(lambda: rplan.snapshot_sharded_plan(arch, mesh)
                        .to_json())
        got = _outcome(lambda: pplan.snapshot_sharded_plan(
            arch, mesh, rates=TPU_V5E).to_json())
        assert got == want, (arch, mesh)


# ------------------------------------------------------------ host side
def test_sharded_pool_matches_reference():
    """Lockstep mutation on every shard, divergence after an out-of-band
    change, the lockstep assertion on a call that parts, the gauges: the
    reference's values, step for step."""
    pools = [mod.ShardedPagePool(8, 4, shards=2) for mod in (rshard, shard)]
    for pool in pools:
        assert (pool.num_pages, pool.page_size) == (8, 4)
        assert pool.ensure(0, 10) and pool.pages_of(0) == 3
        assert all(s.pages_of(0) == 3 for s in pool.shards)
        pool.set_length(0, 10)
    assert [p.lockstep_divergence() for p in pools] == [0, 0]
    assert [p.stats() for p in pools][0] == pools[1].stats()
    assert pools[0].block_table_rows([0, -1], 4).tolist() == \
        pools[1].block_table_rows([0, -1], 4).tolist()
    assert pools[0].live_requests() == pools[1].live_requests() == [0]
    regs = [rtelemetry.MetricsRegistry(), telemetry.MetricsRegistry()]
    for pool, m in zip(pools, regs):
        pool.observe(m)
    assert regs[0].gauges == regs[1].gauges
    assert regs[1].gauges["shard_pages_used_max"] == 3
    for pool in pools:
        pool.shards[1].ensure(99, 4)
    assert [p.lockstep_divergence() for p in pools] == [1, 1]
    for pool in pools:
        with pytest.raises(AssertionError, match="lockstep"):
            pool.ensure(100, 20)
        with pytest.raises(AttributeError):
            pool.no_such_method


def test_make_pool_bytes_and_collectives_match_reference():
    """``make_pool`` by plan, ``per_device_kv_bytes`` (exactly 1/tp),
    ``chunk_collectives`` and ``sharding_stats``: the reference's values."""
    for arch, mesh in ((GEMMA2, "tp=2"), (GEMMA2, None), (MIXTRAL, "ep=4"),
                       (MIXTRAL, "tp=2,ep=2"), ("qwen2.5-3b-reduced",
                                                "tp=2")):
        rp, pp = _plans(arch, mesh, kv_quant="int8" if arch[0] == "q"
                        else None)
        rcfg, cfg = rget_config(arch), get_config(arch)
        if pp.paged:
            assert isinstance(shard.make_pool(pp), shard.ShardedPagePool) \
                == isinstance(rshard.make_pool(rp), rshard.ShardedPagePool)
            assert (type(shard.make_pool(pp)) is PageAllocator) == \
                (not pp.sharded)
        assert shard.per_device_kv_bytes(cfg, pp) == \
            rshard.per_device_kv_bytes(rcfg, rp)
        assert shard.chunk_collectives(pp, steps=4, tokens=6) == \
            rshard.chunk_collectives(rp, steps=4, tokens=6)
        got = shard.sharding_stats(cfg, pp, device="cpu")
        assert got == rshard.sharding_stats(rcfg, rp)
        if pp.paged and pp.tp > 1:
            assert got["kv_bytes_per_device"] * pp.tp == \
                got["kv_bytes_single_device"]
    assert shard.make_pool(pp, 5).num_pages == 5
    assert isinstance(shard.make_pool(pp, 5), shard.ShardedPagePool)


def test_partition_specs_and_modes_match_reference():
    """Modes per data type and specs equal to ``tuple(PartitionSpec)``;
    ``hmmesh.spec_for`` / ``mode_axes`` / ``divisible`` likewise."""
    for arch, mesh in ((MIXTRAL, "tp=2,ep=2"), (GEMMA2, "tp=2"),
                       (GEMMA2, None)):
        rp, pp = _plans(arch, mesh)
        want, got = rshard.partition_specs(rp), shard.partition_specs(pp)
        assert set(got) == set(want)
        for key in got:
            assert got[key]["mode"].value == want[key]["mode"].value
            assert got[key]["spec"] == tuple(want[key]["spec"])
            assert got[key].get("note") == want[key].get("note")
    assert shard.partition_specs(pp)["kv_pages"]["spec"] == \
        (None, None, None, None)
    mesh_shape = {"pod": 2, "data": 4, "model": 8}
    for mode in hmmesh.Mode:
        rmode = rhmmesh.Mode(mode.value)
        for multi in (False, True):
            assert hmmesh.mode_axes(mode, multi) == \
                rhmmesh.mode_axes(rmode, multi)
            for ndim, dim in ((2, 0), (3, 1), (4, 2)):
                assert hmmesh.spec_for(mode, ndim, dim, multi) == \
                    tuple(rhmmesh.spec_for(rmode, ndim, dim, multi))
            for size in (1, 6, 8, 64):
                assert hmmesh.divisible(size, mode, mesh_shape, multi) == \
                    rhmmesh.divisible(size, rmode, mesh_shape, multi)
    assert hmmesh.spec_for(hmmesh.Mode.GROUPED_MC, 4, 2, False) == \
        (None, None, "model", None)


def test_serve_mesh_backing(monkeypatch):
    """``backed`` asks the serving device's backend: one CPU backs only one
    device; on CUDA the card count decides. ``device_mesh`` raises when
    the mesh is not backed."""
    m = shard.ServeMesh(tp=2, ep=4, device="cpu")
    assert m.devices == 8 and not m.trivial and not m.backed
    assert shard.ServeMesh(device="cpu").backed
    assert shard.ServeMesh(device="cpu").device_mesh() == \
        [[torch.device("cpu")]]
    with pytest.raises(RuntimeError, match="needs 8 device"):
        m.device_mesh()
    assert "logical" in m.describe()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    g = shard.ServeMesh.from_plan(
        pplan.plan_serve(get_config(MIXTRAL), mesh="tp=2,ep=4", **PLAN_KW),
        "cuda")
    assert g.backed and "backed" in g.describe()
    assert g.device_mesh() == [[torch.device("cuda", 2 * e + t)
                                for t in range(2)] for e in range(4)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="device_count"):
        g.device_mesh()


# ------------------------------------------------------------ device side
def _pool_case(KV, R, D, int8, seed=0):
    """Pools of 12 pages of 4 tokens, a permuted table, rows of 0 to 11
    tokens, q (B,1,H,D)."""
    rng = np.random.default_rng(seed)
    lengths = [0, 1, 7, 11]
    B, ps, P, MP = len(lengths), 4, 12, 3
    q = torch.from_numpy(rng.standard_normal((B, 1, KV * R, D))).bfloat16()
    shape = (P, ps, KV, D)
    if int8:
        pools = [torch.from_numpy(rng.integers(-127, 128, shape)).to(
            torch.int8) for _ in range(2)]
        kw = dict(k_scale=torch.from_numpy(rng.random((P, KV)) * 3).float(),
                  v_scale=torch.from_numpy(rng.random((P, KV)) * 3).float())
    else:
        pools = [torch.from_numpy(rng.standard_normal(shape)).bfloat16()
                 for _ in range(2)]
        kw = {}
    table = torch.from_numpy(rng.permutation(P)[:B * MP].reshape(B, MP)
                             .astype(np.int32))
    return q, pools, table, torch.tensor(lengths, dtype=torch.int32), kw


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_paged_attention_is_exact(int8, tp):
    """tp shards over the unsliced pools, concatenated, equal the one call
    bit for bit; each shard equals the call on its sliced pools."""
    q, (kp, vp), bt, lens, kw = _pool_case(4, 2, 16, int8)
    want = pops.paged_attention(q, kp, vp, bt, lens, softcap=30.0, **kw)
    got = tpar.sharded_paged_attention(q, kp, vp, bt, lens, tp,
                                       softcap=30.0, **kw)
    assert torch.equal(got, want)
    per = 4 // tp
    heads = slice(per, 2 * per)
    skw = {k: v[:, heads].contiguous() for k, v in kw.items()}
    alone = pops.paged_attention(
        tpar.shard_slice(q, 2, 1, tp), kp[:, :, heads].contiguous(),
        vp[:, :, heads].contiguous(), bt, lens, softcap=30.0, **skw)
    assert torch.equal(alone, tpar.shard_slice(want, 2, 1, tp))


def test_paged_attention_needs_every_head_without_offset():
    """Only a call that names its head slice (``kv_offset``) may pass a q
    of fewer KV heads than the pool: a mis-shaped q still raises."""
    q, (kp, vp), bt, lens, kw = _pool_case(4, 2, 16, True)
    q2 = tpar.shard_slice(q, 2, 0, 2)              # 2 of the 4 KV heads
    with pytest.raises(ValueError, match="vs pools"):
        pops.paged_attention(q2, kp, vp, bt, lens, kv_heads=2, **kw)
    with pytest.raises(ValueError, match="vs pools"):
        pops.paged_attention(q2, kp, vp, bt, lens, kv_offset=3, kv_heads=2,
                             **kw)
    got = pops.paged_attention(q2, kp, vp, bt, lens, kv_offset=0,
                               kv_heads=2, **kw)
    assert torch.equal(got, tpar.shard_slice(
        pops.paged_attention(q, kp, vp, bt, lens, **kw), 2, 0, 2))


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_decode_attention_is_exact(tp):
    """The contiguous path (rings, dense slots) over tp KV-head shards, on
    gemma2's softcap."""
    cfg = get_config(GEMMA2)
    rng = np.random.default_rng(tp)
    B, T, KV, R, D = 3, 10, 4, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, 1, KV * R, D))).bfloat16()
    k, v = (torch.from_numpy(rng.standard_normal((B, T, KV, D))).bfloat16()
            for _ in range(2))
    mask = torch.from_numpy(rng.random((B, T)) < 0.7)
    mask[:, 0] = True
    want = players.decode_attention(q, k, v, mask, cfg)
    assert torch.equal(tpar.sharded_decode_attention(q, k, v, mask, cfg, tp),
                       want)
    assert torch.equal(tpar.sharded_decode_attention(q, k, v, mask, cfg, 1),
                       want)


@pytest.mark.parametrize("ep", [2, 4])
def test_sharded_expert_mlp_is_exact(ep):
    """ep expert shards gathered along E equal every expert at once, and
    the MoE decode layer at ep equals it at one device."""
    cfg = get_config(MIXTRAL)
    params = ptfm.compute_copy(pmoe.init_moe_params(
        cfg, torch.Generator().manual_seed(ep), "cpu"))
    x = torch.from_numpy(np.random.default_rng(ep).standard_normal(
        (2, 3, cfg.d_model))).bfloat16()
    act = pmoe._act(cfg)
    got = tpar.sharded_expert_mlp(x, params["wg"], params["wu"],
                                  params["wd"], act=act, ep=ep)
    want = torch.stack([pmoe.gated_mlp(x, params["wg"][e], params["wu"][e],
                                       params["wd"][e], act, torch.float32)
                        for e in range(cfg.num_experts)])
    assert len(got) == cfg.num_experts
    assert torch.equal(torch.stack(got), want)
    y1, _ = pmoe.moe_layer_decode(params, x, cfg)
    y2, _ = pmoe.moe_layer(params, x, cfg, ep=ep)
    assert torch.equal(y1, y2)
    with pytest.raises(ValueError, match="must divide"):
        tpar.sharded_expert_mlp(x, params["wg"], params["wu"], params["wd"],
                                act=act, ep=3)


@pytest.mark.parametrize("kv_quant", ["fp", "int8"])
def test_sharded_decode_step_is_exact_and_capturable(kv_quant):
    """gemma2's decode step (paged global layers, local rings) at tp=2
    gives the tp=1 step's logits bit for bit over four steps, and makes no
    host read (a CUDA graph can hold it)."""
    cfg = get_config(GEMMA2)
    params = ptfm.compute_copy(ptfm.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    base = pplan.plan_for_scheduler(cfg, rows=3, cache_len=64, page_size=4,
                                    share_prefix=False, attn_path="paged",
                                    kv_quant=kv_quant, sync_every=4)
    logits = []
    for plan in (base, dataclasses.replace(base, tp=2)):
        loop = peng.DecodeLoop(cfg, params, plan, temperature=0.0,
                               eos_id=-1, device=torch.device("cpu"),
                               paged=True, sync_every=4)
        state = loop.start(3)
        table = np.full((3, plan.max_pages), -1, np.int32)
        table[0, :6], table[2, :7] = range(0, 12, 2), range(1, 14, 2)
        bt = loop.set_block_table(table)
        toks = np.zeros((2, 16), np.int32)
        toks[0, :9], toks[1, :13] = range(2, 11), range(20, 33)
        peng.refill_rows(params, cfg, plan, state, toks, np.array([9, 13]),
                         np.array([0, 2]), np.array([8, 8]), block_table=bt)
        steps = []
        with _HostReads() as mode:
            for _ in range(4):
                loop.step()
                steps.append(state[1].clone())
        assert mode.seen == []
        logits.append(steps)
    for a, b in zip(*logits):
        assert torch.equal(a, b)


# ------------------------------------------------------- the whole slice
def _stream_requests(reqs):
    return [(list(p), n) for p, n in reqs]


@pytest.fixture(scope="module")
def reference_streams():
    """The reference's sharded ``LLM.stream`` per arch (default guard and
    tracer, strict compilation): streams, sharding report, metrics, trace
    signature and categories, and its weights."""
    out = {}
    for arch, (mesh, seed, reqs) in STREAMS.items():
        rcfg = rget_config(arch)
        rparams = rtfm.init_params(jax.random.PRNGKey(seed), rcfg)
        plan = rplan.plan_serve(rcfg, mesh=mesh, **PLAN_KW)
        with _strict_reference():
            llm = RLLM(rcfg, rparams, plan)
            done = llm.stream(_stream_requests(reqs),
                              rng=jax.random.PRNGKey(42))
        tel = llm.telemetry()
        out[arch] = dict(
            rcfg=rcfg, rparams=rparams, outs=[r.out for r in done],
            report=llm.sharding_report(),
            metrics=tel.metrics.snapshot().as_dict(),
            signature=tel.tracer.signature(),
            cats={e.cat for e in tel.tracer.events})
    return out


@pytest.mark.parametrize("arch", sorted(STREAMS))
def test_sharded_stream_matches_reference(reference_streams, arch):
    """The port's sharded ``LLM.stream`` (CPU, default guard and tracer)
    equals its tp=1 stream bit for bit and the reference's sharded stream
    token for token; the sharding report, the ``collective_*`` counters,
    the ``shard_*`` gauges, every metric and the trace signature equal the
    reference's."""
    mesh, _, reqs = STREAMS[arch]
    ref = reference_streams[arch]
    cfg = get_config(arch)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                   ref["rparams"]))
    outs = []
    for m in (None, mesh):
        plan = pplan.plan_serve(cfg, mesh=m, rates=TPU_V5E, **PLAN_KW)
        llm = LLM(cfg, params, plan, device="cpu")
        pops.reset_launches()
        outs.append([r.out for r in llm.stream(_stream_requests(reqs))])
        assert sum(pops.launch_counts().values()) == 0
    assert outs[1] == outs[0]
    tdp.compare_streams(ref["rcfg"], ref["rparams"], [p for p, _ in reqs],
                        outs[1], ref["outs"])
    assert llm.mesh == shard.ServeMesh.from_plan(plan, "cpu")
    assert llm.sharding_report() == ref["report"]
    tel = llm.telemetry()
    got = tel.metrics.snapshot().as_dict()
    assert got == ref["metrics"]
    assert tel.tracer.signature() == ref["signature"]
    assert {e.cat for e in tel.tracer.events} == ref["cats"]
    assert "collective" in ref["cats"]
    assert got["counters"]["collective_ops"] > 0
    assert got["gauges"].get("shard_lockstep_divergence", 0) == 0
    if arch == GEMMA2:
        rep = llm.sharding_report()
        assert rep["shards"] == 2 and rep["lockstep_divergence"] == 0
        assert rep["kv_bytes_per_device"] * 2 == rep["kv_bytes_single_device"]


# ---------------------------------------------------------------- planner
PLANNER_MESH = dict(pod=1, data=16, model=16)


def _layer_fields(lp):
    return (lp.layer, lp.weight_mode.value, lp.iact_mode.value, lp.est_time,
            lp.terms, lp.note)


def test_planner_layers_match_reference():
    """``plan_layer`` on the shapes of ``tests/test_planner.py`` (FC at a
    small batch, a training MLP of 2^20 tokens, a depth-wise conv) at the
    reference's rates: the same modes, times and notes."""
    mesh, rmesh = planner.MeshDesc(**PLANNER_MESH), \
        rplanner.MeshDesc(**PLANNER_MESH)
    for make, args, training in (
            ("gemm", ("fc", 16, 4096, 4096), False),
            ("gemm", ("mlp", 1 << 20, 4096, 16384), True),
            ("gemm", ("moe", 64, 4096, 14336, 16), False),
            ("conv", ("dw", 16, 1, 1, 16, 16, 3, 3), False)):
        kw = dict(groups=64) if make == "conv" else {}
        got = planner.plan_layer(getattr(reuse, make)(*args, **kw), mesh,
                                 training, rates=TPU_V5E)
        want = rplanner.plan_layer(getattr(rreuse, make)(*args, **kw),
                                   rmesh, training)
        assert _layer_fields(got) == _layer_fields(want), args
    assert planner.plan_layer(reuse.gemm("fc", 16, 4096, 4096), mesh,
                              False).weight_mode != hmmesh.Mode.BROADCAST


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x7b", "mamba2-130m",
                                  "llama4-maverick-400b-a17b", "qwen2.5-3b",
                                  "recurrentgemma-2b"])
def test_planner_models_match_reference(arch):
    """``plan_model`` over every shape of the reference's ``SHAPES``: the
    same rule, shard flags, activation axes and layer plans."""
    mesh, rmesh = planner.MeshDesc(**PLANNER_MESH), \
        rplanner.MeshDesc(**PLANNER_MESH)
    for name, shape in SHAPES.items():
        got = planner.plan_model(get_config(arch), shape, mesh,
                                 rates=TPU_V5E)
        want = rplanner.plan_model(rget_config(arch), shape, rmesh)
        for key in ("param_rule", "shard_experts", "shard_heads",
                    "shard_kv_heads", "shard_ffn", "shard_vocab",
                    "cache_seq_sharded", "act_axes"):
            assert getattr(got, key) == getattr(want, key), (name, key)
        assert [_layer_fields(lp) for lp in got.layers] == \
            [_layer_fields(lp) for lp in want.layers], name
        assert got.describe() == want.describe()


# -------------------------------------------------------------------- CLI
def test_serve_cli_matches_reference(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced
    --device cpu`` on the reference CLI's weights (bridged) serves the
    reference ``DecodeEngine``'s streams; its own main seeds the port's
    weights, and without a card and ``--device`` it raises."""
    import sys
    from repro.launch import serve as rserve
    from repro_torch.launch import serve
    argv = ["--arch", "qwen2.5-3b", "--reduced", "--requests", "5",
            "--slots", "2", "--prompt-len", "9", "--max-new", "6",
            "--cache-len", "32"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    want = sorted(rserve.main(), key=lambda r: r.rid)
    rcfg = rget_config("qwen2.5-3b-reduced")
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    args = serve.parse_args(argv + ["--device", "cpu"])
    cfg = get_config("qwen2.5-3b-reduced")
    got = sorted(serve.serve(cfg, bridge.params_from_numpy(
        jax.tree.map(np.asarray, rparams)), args), key=lambda r: r.rid)
    assert [r.prompt for r in got] == [[int(t) for t in r.prompt]
                                       for r in want]
    tdp.compare_streams(rcfg, rparams, [r.prompt for r in got],
                        [r.out for r in got],
                        [[int(t) for t in r.out] for r in want])
    assert "served 5 requests" in capsys.readouterr().out
    done = serve.main(["--arch", "qwen2.5-3b", "--reduced", "--device",
                       "cpu", "--requests", "2"])
    assert [len(r.out) for r in done] == [16, 16]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(argv)
