"""The port's plan surface, Eyexam and capacity accounting against the
reference.

* ``parse_mesh`` through both packages: the same ``(tp, ep)`` or the same
  exception type, and ``plan_serve`` serving every one-device spelling;
* ``plan_serve`` at the reference's device rates (``eyexam.TPU_V5E``):
  ``to_json()`` string-equal and ``explain()`` line-equal, over
  ``test_torch_spec.PLAN_CASES``, full-size qwen2.5-3b, ``sparsity_stats=``
  and ``arch=``, and decisions pinned against their rules (each branch of
  the ``spec`` prose among them); ``snapshot_plan("gemma2-2b")`` against
  ``scripts/golden_plans.json``;
* at the H100's rates (the default) qwen2.5-3b's default plan makes the
  reference default's choices; only the budget, ``rows_fitting_budget``
  and the MLP roofline's seconds (bytes over 3.35e12 B/s plus launches
  times ``launch_s``) differ;
* ``mlp_roofline``, ``seven_steps``, ``layer_cycles``,
  ``network_performance``, ``reuse`` and ``model_gemms`` equal the
  reference's (exact: the same float operations in the same order), the
  recurrent archs (``recurrentgemma-2b``, ``mamba2-130m``, full and
  reduced) among them, whose plans are contiguous with exact-length
  prefill;
* ``ArchConfig.param_count``, ``kvcache.cache_bytes``,
  ``paged_cache_bytes``, ``max_slots`` and ``report`` (with a pager after
  the same allocations) equal the reference's;
* the frontend architectures (internvl2-26b, musicgen-large) get the
  reference's plans, and the port's serving loops (``LLM.stream`` and
  ``generate``, ``DecodeEngine``, the scheduler) refuse them with a
  ``ValueError`` naming the entry points that serve them, as the
  reference's loops cannot serve them;
* the plan-less front door: ``LLM(cfg, params)`` resolves the reference's
  default plan and serves a short stream with the reference's tokens (or a
  parting at a reference near-tie, ``torch_dense_parity.compare_streams``);
  ``replicas`` below 1 raises the reference's ``ValueError``, 2 serves
  through the fleet;
* the CLI ``python -m repro_torch.core.plan`` prints the reference CLI's
  report at ``--rates tpu-v5e``.
"""
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest

from repro.configs import get_config as rget_config
from repro.core import eyexam as reyexam
from repro.core import plan as rplan
from repro.core import reuse as rreuse
from repro.models import transformer as rtfm
from repro.serve import LLM as RLLM
from repro.serve import kvcache as rkv

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import eyexam, reuse
from repro_torch.core import plan as pplan
from repro_torch.serve import LLM
from repro_torch.serve import kvcache
from test_torch_prefix import Pair
from test_torch_spec import PLAN_CASES
from torch_dense_parity import compare_streams

ROOT = pathlib.Path(__file__).resolve().parents[1]
REDUCED = "qwen2.5-3b-reduced"
V5E = eyexam.TPU_V5E
RECURRENT = ("recurrentgemma-2b", "mamba2-130m")
MOE = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
FRONTENDS = ("internvl2-26b", "musicgen-large")
CONFIGS = ("qwen2.5-3b", "gemma2-2b", "mistral-nemo-12b",
           "gemma3-12b") + RECURRENT + MOE + FRONTENDS
REDUCED_ALL = (REDUCED,) + tuple(a + "-reduced"
                                 for a in RECURRENT + MOE + FRONTENDS)


# ------------------------------------------------------------------- mesh
MESHES = [None, "", {}, [1, 1], (1, 1), "tp=1", "ep=1,tp=1", "tp=x",
          {"dp": 2}, (0, 1)]


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:          # the exception's type is the outcome
        return "raises", type(e).__name__


@pytest.mark.parametrize("mesh", MESHES, ids=repr)
def test_parse_mesh_matches_reference(mesh):
    """The same (tp, ep) or the same exception type; ``plan_serve`` then
    resolves the reference's plan on every one-device spelling and raises
    its exception type on a malformed one."""
    got = _outcome(lambda: pplan.parse_mesh(mesh))
    assert got == _outcome(lambda: rplan.parse_mesh(mesh))
    kw = dict(hbm_budget_bytes=1 << 30, expected_batch=2,
              expected_len_dist={"mean": 24, "max": 64}, page_size=8,
              mesh=mesh)
    mine = _outcome(lambda: pplan.plan_serve(get_config(REDUCED), rates=V5E,
                                             **kw).to_json())
    ref = _outcome(lambda: rplan.plan_serve(rget_config(REDUCED),
                                            **kw).to_json())
    assert mine == ref
    assert (got[0] == "ok") == (mine[0] == "ok")


def test_larger_mesh_is_not_ported():
    """A mesh of more than one device runs the mesh stage: the reference's
    plan, or the reference's exception (``ep`` on a dense config)."""
    kw = dict(hbm_budget_bytes=1 << 30, expected_batch=2,
              expected_len_dist={"mean": 24, "max": 64})
    for mesh in ("tp=2", {"ep": 2}, (2, 2)):
        mine = _outcome(lambda: pplan.plan_serve(
            get_config(REDUCED), rates=V5E, mesh=mesh, **kw).to_json())
        ref = _outcome(lambda: rplan.plan_serve(
            rget_config(REDUCED), mesh=mesh, **kw).to_json())
        assert mine == ref
    assert mine == ("raises", "ValueError")


# -------------------------------------------------------- plan parity
QWEN_DEFAULT = dict(hbm_budget_bytes=int(reyexam.HBM_CAP // 2),
                    expected_batch=8,
                    expected_len_dist={"mean": 256, "max": 512})
PINNED_CASES = [
    # the reference's own default for full-size qwen2.5-3b
    ("qwen2.5-3b", QWEN_DEFAULT),
    ("qwen2.5-3b", dict(QWEN_DEFAULT, sparsity_stats={
        "sparsity": 0.5, "packing_efficiency": 0.8}, arch="qwen-sparse")),
    # attention paged and kv int8 against their rules
    ("qwen2.5-3b", dict(hbm_budget_bytes=8 << 30, expected_batch=8,
                        expected_len_dist={"mean": 1800, "max": 2048},
                        attn_path="paged", kv_quant="int8")),
    # speculation pinned off at one row, where the rule picks k 8
    ("qwen2.5-3b", dict(hbm_budget_bytes=8 << 30, expected_batch=1,
                        expected_len_dist={"mean": 512, "max": 2048},
                        spec_k=0)),
    # contiguous pinned against the rule, on local layers (not eligible)
    ("gemma2-2b", dict(hbm_budget_bytes=8 << 30, expected_batch=2,
                       expected_len_dist={"mean": 256, "max": 512},
                       attn_path="contiguous")),
    # one row of the reduced config at a long cache, whose share of the
    # step's bytes puts the modelled gain under the bar
    (REDUCED, dict(hbm_budget_bytes=1 << 30, expected_batch=1,
                   expected_len_dist={"mean": 24, "max": 1024})),
    (REDUCED, dict(hbm_budget_bytes=1 << 30, expected_batch=4,
                   expected_len_dist=[10, 20, 64], page_size=8,
                   num_pages=20, share_prefix=False, sync_every=4)),
    # the recurrent archs: no global layer, so contiguous whatever is
    # asked, exact-length prefill, no int8 rung, never speculative
    ("recurrentgemma-2b", dict(hbm_budget_bytes=8 << 30, expected_batch=4,
                               expected_len_dist={"mean": 1024,
                                                  "max": 4096})),
    ("recurrentgemma-2b", dict(hbm_budget_bytes=8 << 30, expected_batch=1,
                               expected_len_dist={"mean": 100, "max": 8192},
                               attn_path="paged", kv_quant="int8")),
    ("mamba2-130m", dict(QWEN_DEFAULT, expected_len_dist={"mean": 256,
                                                          "max": 2048})),
    ("recurrentgemma-2b-reduced", dict(hbm_budget_bytes=1 << 30,
                                       expected_batch=2,
                                       expected_len_dist={"mean": 24,
                                                          "max": 64})),
    ("mamba2-130m-reduced", dict(hbm_budget_bytes=1 << 30,
                                 expected_batch=1,
                                 expected_len_dist=[10, 20, 64],
                                 sync_every=4)),
    # the MoE archs: mixtral all local (contiguous), llama4 one global
    # layer in four (paged, sharing on, spec off: not all global)
    ("mixtral-8x7b", dict(hbm_budget_bytes=8 << 30, expected_batch=4,
                          expected_len_dist={"mean": 1024, "max": 8192})),
    ("llama4-maverick-400b-a17b", dict(hbm_budget_bytes=8 << 30,
                                       expected_batch=1,
                                       expected_len_dist={"mean": 512,
                                                          "max": 2048})),
    ("mixtral-8x7b-reduced", dict(hbm_budget_bytes=1 << 30,
                                  expected_batch=2,
                                  expected_len_dist={"mean": 24,
                                                     "max": 96})),
    ("llama4-maverick-400b-a17b-reduced", dict(
        hbm_budget_bytes=1 << 30, expected_batch=4,
        expected_len_dist=[10, 40, 96], page_size=8)),
]


@pytest.mark.parametrize("arch,kw", PLAN_CASES + PINNED_CASES)
def test_plan_json_and_explain_match_reference(arch, kw):
    ref = rplan.plan_serve(rget_config(arch), **kw)
    mine = pplan.plan_serve(get_config(arch), rates=V5E, **kw)
    assert mine.to_json() == ref.to_json()
    assert mine.explain().splitlines() == ref.explain().splitlines()


@pytest.mark.parametrize("arch", RECURRENT + tuple(a + "-reduced"
                                                for a in RECURRENT))
def test_recurrent_plans_match_reference(arch):
    """``plan_for_scheduler`` and ``plan_for_engine`` for the recurrent
    archs at the reference's rates: contiguous, exact-length prefill, no
    int8 rung, ``to_json()`` and ``explain()`` equal to the reference's."""
    cfg, rcfg = get_config(arch), rget_config(arch)
    for mine, ref in (
            (pplan.plan_for_scheduler(cfg, rows=4, cache_len=4096, rates=V5E),
             rplan.plan_for_scheduler(rcfg, rows=4, cache_len=4096)),
            (pplan.plan_for_engine(cfg, slots=4, cache_len=4096, rates=V5E),
             rplan.plan_for_engine(rcfg, slots=4, cache_len=4096))):
        assert mine.to_json() == ref.to_json()
        assert mine.explain().splitlines() == ref.explain().splitlines()
        assert not mine.paged and mine.prefill_exact
        assert "int8_kv" not in mine.degrade and mine.spec_k == 0


@pytest.mark.parametrize("arch", MOE + tuple(a + "-reduced" for a in MOE))
def test_moe_plans_match_reference(arch):
    """``plan_for_scheduler`` and ``plan_for_engine`` for the MoE archs at
    the reference's rates, ``to_json()`` and ``explain()`` equal: power-of-
    two prefill tiers, no speculation; the scheduler's plan contiguous for
    mixtral (no global layer) and paged with prefix sharing for llama4,
    the engine's contiguous for both."""
    cfg, rcfg = get_config(arch), rget_config(arch)
    sched = pplan.plan_for_scheduler(cfg, rows=4, cache_len=4096, rates=V5E)
    eng = pplan.plan_for_engine(cfg, slots=4, cache_len=4096, rates=V5E)
    for mine, ref in (
            (sched, rplan.plan_for_scheduler(rcfg, rows=4, cache_len=4096)),
            (eng, rplan.plan_for_engine(rcfg, slots=4, cache_len=4096))):
        assert mine.to_json() == ref.to_json()
        assert mine.explain().splitlines() == ref.explain().splitlines()
        assert not mine.prefill_exact and mine.tier(37) == 64
        assert mine.spec_k == 0
    llama4 = arch.startswith("llama4")
    assert sched.paged == sched.share_prefix == llama4
    assert not eng.paged


def test_explain_shows_each_spec_branch():
    """The cases above reach every branch of the ``spec`` prose."""
    whys = [{d.name: d.why for d in pplan.plan_serve(
        get_config(arch), rates=V5E, **kw).decisions}["spec"]
        for arch, kw in PLAN_CASES + PINNED_CASES]
    for branch in ("pinned off by caller", "batch-1 decode is weight-stream",
                   "requires an all-global", "batch rows already amortize",
                   "modeled gain"):
        assert any(branch in why for why in whys), branch


def test_snapshot_matches_golden():
    golden = json.loads((ROOT / "scripts" / "golden_plans.json").read_text())
    got = json.loads(pplan.snapshot_plan("gemma2-2b", rates=V5E).to_json())
    assert got == golden["gemma2-2b"]


def test_h100_default_plan_keeps_the_choices():
    """qwen2.5-3b's default plan on the card (half of 80e9 B) against the
    reference's default (half of 16e9 B at the TPU's rates): every choice
    and bound equal; the numbers too, but the budget, the rows it fits and
    the MLP roofline's seconds, which divide by 3.35e12 B/s."""
    cfg = get_config("qwen2.5-3b")
    h100 = eyexam.H100_SXM
    mine = pplan.plan_serve(cfg, hbm_budget_bytes=int(h100.hbm_cap // 2),
                            expected_batch=8,
                            expected_len_dist={"mean": 256, "max": 512})
    ref = rplan.plan_serve(rget_config("qwen2.5-3b"), **QWEN_DEFAULT)
    a, b = mine.as_dict(), ref.as_dict()
    assert {k: v for k, v in a.items() if k != "decisions"} == \
        {k: v for k, v in b.items() if k != "decisions"}
    for d, r in zip(mine.decisions, ref.decisions):
        assert (d.name, d.choice, d.bound) == (r.name, r.choice, r.bound)
        differ = {k for k in d.numbers if d.numbers[k] != r.numbers[k]}
        if d.name == "capacity":
            assert differ == {"hbm_budget_bytes", "rows_fitting_budget"}
            assert d.numbers["hbm_budget_bytes"] == 40_000_000_000
        elif d.name == "mlp":
            assert differ == {"per_layer_time_s", "speedup"}
        else:
            assert not differ and d.why == r.why, d.name
    mlp = {d.name: d for d in mine.decisions}["mlp"].numbers
    b_ = mlp["per_layer_bytes"]
    t = mlp["per_layer_time_s"]
    assert t["fused_sparse"] == pytest.approx(
        (b_["weights_sparse_real"] + b_["act_in_out"]) / 3.35e12 + 2e-6,
        rel=1e-12)
    assert t["dense"] == pytest.approx(
        (b_["weights_dense"] + b_["hidden_roundtrip"] + b_["act_in_out"])
        / 3.35e12 + 3 * 2e-6, rel=1e-12)


# -------------------------------------------------------- eyexam / reuse
def test_device_rates():
    assert (V5E.peak_flops, V5E.hbm_bw, V5E.link_bw, V5E.hbm_cap) == (
        reyexam.PEAK_FLOPS, reyexam.HBM_BW, reyexam.ICI_BW, reyexam.HBM_CAP)
    assert V5E.launch_s == rplan.KERNEL_LAUNCH_S
    h = eyexam.H100_SXM
    assert (h.peak_flops, h.hbm_bw, h.hbm_cap) == (989e12, 3.35e12, 80e9)
    kw = dict(flops=1e12, hbm_bytes=819e9 * 10, coll_bytes=1.0,
              per_op_coll={}, chips=1)
    r, mine = reyexam.Roofline(**kw), eyexam.Roofline(**kw, rates=V5E)
    assert mine.summary() == r.summary()
    assert mine.fraction_of_roofline(1e12) == r.fraction_of_roofline(1e12)
    assert eyexam.Roofline(**kw).t_memory == 819e9 * 10 / 3.35e12


@pytest.mark.parametrize("arch", CONFIGS + REDUCED_ALL)
def test_mlp_roofline_matches_reference(arch):
    cfg, rcfg = get_config(arch), rget_config(arch)
    for sparsity, eff, bm in ((0.75, 0.93, 8), (0.5, 0.8, 64),
                              (0.0, 1.0, 512)):
        assert pplan.mlp_roofline(cfg, sparsity, eff, bm, rates=V5E) == \
            rplan.mlp_roofline(rcfg, sparsity, eff, bm)


SHAPES = [
    ("gemm", ("q", 8, 2048, 2048)),
    ("gemm", ("up", 512, 2048, 22016)),
    ("gemm", ("qk", 64, 128, 64, 16)),
    ("conv", ("conv3", 1, 64, 128, 56, 56, 3, 3)),
    ("conv", ("stride2", 4, 32, 64, 112, 112, 3, 3, 2)),
    ("conv", ("depthwise", 1, 1, 1, 56, 56, 3, 3, 1, 64)),
]


def _shape(mod, kind, args):
    return getattr(mod, kind)(*args)


@pytest.mark.parametrize("noc", ["hmnoc", "broadcast"])
@pytest.mark.parametrize("n_pes", [256, 1024, 16384])
def test_eyexam_steps_match_reference(noc, n_pes):
    side = int(np.sqrt(n_pes))
    acc = eyexam.AcceleratorModel(n_pes=n_pes, array_h=side, array_w=side,
                                  noc=noc)
    racc = reyexam.AcceleratorModel(n_pes=n_pes, array_h=side, array_w=side,
                                    noc=noc)
    mine = [_shape(reuse, k, a) for k, a in SHAPES]
    ref = [_shape(rreuse, k, a) for k, a in SHAPES]
    for s, r in zip(mine, ref):
        assert dataclasses.astuple(s) == dataclasses.astuple(r)
        assert reuse.reuse(s) == rreuse.reuse(r)
        assert (s.effective_macs, s.psum_count) == (r.effective_macs,
                                                    r.psum_count)
        assert eyexam.seven_steps(s, acc) == reyexam.seven_steps(r, racc)
        assert eyexam.layer_cycles(s, acc) == reyexam.layer_cycles(r, racc)
    assert eyexam.network_performance(mine, acc) == \
        reyexam.network_performance(ref, racc)


@pytest.mark.parametrize("arch", CONFIGS + REDUCED_ALL)
def test_model_gemms_match_reference(arch):
    """Every layer kind's GEMMs, the recurrent ones (no MLP after an ssm
    layer) included."""
    cfg, rcfg = get_config(arch), rget_config(arch)
    for tokens in (1, 8, 4096):
        got = [dataclasses.astuple(g) for g in reuse.model_gemms(cfg, tokens)]
        want = [dataclasses.astuple(g)
                for g in rreuse.model_gemms(rcfg, tokens)]
        assert got == want


@pytest.mark.parametrize("arch", CONFIGS + REDUCED_ALL)
def test_param_count_and_cache_bytes_match_reference(arch):
    """The parameter count (all experts and active only) and the
    contiguous cache's bytes (counted from the allocated tree on the meta
    device: recurrent state, rings, global K/V) equal the reference's."""
    cfg, rcfg = get_config(arch), rget_config(arch)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.param_count(active_only=True) == \
        rcfg.param_count(active_only=True)
    for rows, cache_len in ((1, 64), (3, 1000), (4, 4096)):
        assert kvcache.cache_bytes(cfg, rows, cache_len) == \
            rkv.cache_bytes(rcfg, rows, cache_len)


@pytest.mark.parametrize("entry", ["stream", "generate", "DecodeEngine",
                                   "scheduler"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_archs_are_refused_by_the_serving_loops(arch, entry):
    """Vision patches, cross-attention and codebooks are served through
    ``make_generate_fn`` / ``prefill`` / ``serve_step``, not by the serving
    loops, whose refill prefills 2-D token batches with no patches or
    conditioning (the reference's cannot serve them either): each raises a
    ``ValueError`` naming those entry points, on the reduced and the full
    config, before any work. ``LLM`` itself still builds its plan."""
    from repro_torch.serve.engine import DecodeEngine
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler
    for name in (arch + "-reduced", arch):
        cfg = get_config(name)
        plan = pplan.plan_for_engine(cfg, slots=2, cache_len=64)
        with pytest.raises(ValueError, match="make_generate_fn") as err:
            if entry in ("stream", "generate"):
                llm = LLM(cfg, {}, device="cpu")
                assert llm.plan.rows >= 1
                getattr(llm, entry)([([1, 2, 3], 2)])
            elif entry == "DecodeEngine":
                DecodeEngine(cfg, {}, plan, device="cpu")
            else:
                ContinuousBatchingScheduler(cfg, {}, plan, device="cpu")
        assert cfg.name in str(err.value)


@pytest.mark.parametrize("arch", FRONTENDS + tuple(a + "-reduced"
                                                for a in FRONTENDS))
def test_frontend_plans_match_reference(arch):
    """``plan_for_scheduler``, ``plan_for_engine`` and ``plan_serve`` for
    internvl2-26b and musicgen-large at the reference's rates:
    ``to_json()`` and ``explain()`` equal, field for field (every layer
    global, so the scheduler's plan is paged)."""
    cfg, rcfg = get_config(arch), rget_config(arch)
    kw = dict(hbm_budget_bytes=8 << 30, expected_batch=4,
              expected_len_dist={"mean": 256, "max": 1024})
    for mine, ref in (
            (pplan.plan_for_scheduler(cfg, rows=4, cache_len=4096, rates=V5E),
             rplan.plan_for_scheduler(rcfg, rows=4, cache_len=4096)),
            (pplan.plan_for_engine(cfg, slots=4, cache_len=4096, rates=V5E),
             rplan.plan_for_engine(rcfg, slots=4, cache_len=4096)),
            (pplan.plan_serve(cfg, rates=V5E, **kw),
             rplan.plan_serve(rcfg, **kw))):
        assert mine.to_json() == ref.to_json()
        assert mine.explain().splitlines() == ref.explain().splitlines()
    assert pplan.plan_for_scheduler(cfg, rows=4, cache_len=4096).paged


# ------------------------------------------------------------- kvcache
@pytest.mark.parametrize("arch", [REDUCED, "gemma2-2b-reduced",
                                  *REDUCED_ALL[1:]])
def test_cache_accounting_matches_reference(arch):
    cfg, rcfg = get_config(arch), rget_config(arch)
    for rows, cache_len, pages, ps in ((2, 64, 9, 8), (4, 256, 20, 64)):
        for kv in ("fp", "int8"):
            assert kvcache.paged_cache_bytes(cfg, rows, cache_len, pages, ps,
                                             kv) == \
                rkv.paged_cache_bytes(rcfg, rows, cache_len, pages, ps, kv)
    for cache_len, chips in ((512, 1), (4096, 4)):
        assert kvcache.max_slots(cfg, cache_len, chips, rates=V5E) == \
            rkv.max_slots(rcfg, cache_len, chips)
        assert kvcache.cache_bytes_per_chip(cfg, 3, cache_len, chips) == \
            rkv.cache_bytes_per_chip(rcfg, 3, cache_len, chips)
    full = get_config("qwen2.5-3b")
    assert kvcache.max_slots(full, 512, 1) == int(
        40e9 // kvcache.cache_bytes(full, 1, 512))


def test_report_with_pager_matches_reference():
    """After the same allocations (a shared prefix among them) in both
    packages' allocators (``test_torch_prefix.Pair`` checks each call's
    result)."""
    cfg, rcfg = get_config(REDUCED), rget_config(REDUCED)
    pair = Pair(12, 8)
    prefix = list(range(30))
    for rid, tokens in ((0, prefix), (1, list(range(50, 60))),
                        (2, prefix[:24] + [99])):
        pair.adopt_prefix(rid, tokens)
        pair.ensure(rid, len(tokens))
        pair.set_length(rid, len(tokens))
        pair.register_prefix(rid, tokens)
    pair.free(1)
    for kv in ("fp", "int8"):
        mine = kvcache.report(cfg, 4, 64, 1, pager=pair.mine, kv_quant=kv,
                              rates=V5E)
        assert mine == rkv.report(rcfg, 4, 64, 1, pager=pair.ref,
                                  kv_quant=kv)
        assert mine["paged"]["pages_saved_sharing"] == 3    # not vacuous
    on_card = kvcache.report(cfg, 4, 64, 1)
    assert on_card["max_slots_half_hbm"] == int(
        40e9 // kvcache.cache_bytes(cfg, 1, 64))


# ---------------------------------------------------------- front door
@pytest.fixture(scope="module")
def qwen():
    rcfg = rget_config(REDUCED)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, get_config(REDUCED), bridge.params_from_numpy(
        jax.tree.map(np.asarray, rparams))


def test_llm_default_plan_serves_like_reference(qwen):
    """``LLM(cfg, params)`` with no plan: at the reference's rates the
    reference's default plan and report; four requests through ``stream``
    under both packages' defaults (guard and tracing on) give the
    reference's greedy tokens, every outcome ok."""
    rcfg, rparams, cfg, params = qwen
    ref = RLLM(rcfg, rparams, eos_id=-1)
    mine = LLM(cfg, params, device="cpu", rates=V5E, eos_id=-1)
    assert mine.plan.to_json() == ref.plan.to_json()
    assert mine.explain().splitlines() == ref.explain().splitlines()
    assert (mine.plan.paged, mine.plan.rows, mine.plan.cache_len) == \
        (True, 8, 512)
    prompts = [list(range(3, 8)), list(range(40, 57)), [7] * 30,
               list(range(100, 109))]
    reqs = [(p, 8) for p in prompts]
    want = ref.stream(reqs)
    got = mine.stream(reqs)
    assert all(r.outcome.ok for r in got)
    compare_streams(rcfg, rparams, prompts, [r.out for r in got],
                    [r.out for r in want])
    h100 = LLM(cfg, params, device="cpu")
    cap = {d.name: d for d in h100.plan.decisions}["capacity"]
    assert cap.numbers["hbm_budget_bytes"] == 40_000_000_000
    assert "fit the 40000000000 B budget" in h100.explain()


def test_llm_replicas(qwen):
    rcfg, rparams, cfg, params = qwen
    with pytest.raises(ValueError) as ref:
        RLLM(rcfg, rparams, replicas=0)
    with pytest.raises(ValueError) as mine:
        LLM(cfg, params, device="cpu", replicas=0)
    assert str(mine.value) == str(ref.value)
    # from 2 on, stream serves through the port's fleet on the default plan
    fleet = LLM(cfg, params, device="cpu", replicas=2, eos_id=-1)
    assert fleet._scheduler is None
    done = fleet.stream([([3, 5, 7], 4), ([4, 5, 7], 4)])
    assert [len(r.out) for r in done] == [4, 4]
    assert all(r.outcome.ok and r.replica in (0, 1) for r in done)
    assert fleet.phase_stats["replicas"] == 2


# ------------------------------------------------------------------ CLI
def test_cli_matches_reference(capsys):
    argv = ["--cfg", "gemma2_2b", "--hbm", "2GiB", "--batch", "4"]
    assert rplan.main(argv) == 0
    want = capsys.readouterr().out
    assert pplan.main(argv + ["--rates", "tpu-v5e"]) == 0
    assert capsys.readouterr().out == want
    assert pplan.main(["--cfg", "qwen2.5-3b", "--hbm", "40GB", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["decisions"][0]["numbers"]["hbm_budget_bytes"] == 40 * 10 ** 9
    argv = ["--cfg", "qwen2.5-3b", "--mesh", "tp=2"]
    assert rplan.main(argv) == 0
    want = capsys.readouterr().out
    assert pplan.main(argv + ["--rates", "tpu-v5e"]) == 0
    assert capsys.readouterr().out == want
    with pytest.raises(ValueError, match="num_kv_heads"):
        pplan.main(["--cfg", "qwen2.5-3b", "--mesh", "tp=4"])
