"""``repro_torch.serve.LLM.stream`` against the reference scheduler.

The reference is ``ContinuousBatchingScheduler(cfg, params, plan,
guard=None)`` on the plan the reference's ``plan_for_scheduler(...,
share_prefix=False)`` resolves; the port (``LLM(..., guard=False)``, the
guard-less scheduler) loads the same plan through ``ServePlan.from_dict``
and bridged parameters, and runs on the CPU. The
request mixes are those of ``tests/test_scheduler.py``. Greedy token streams
must be equal, request by request.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as rget_config
from repro.core import plan as rplan
from repro.models import transformer as rtfm
from repro.serve import sparse as rsparse
from repro.serve.scheduler import ContinuousBatchingScheduler
from repro.serve.scheduler import StreamRequest as RRequest

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import plan as pplan
from repro_torch.kernels import ops as pops
from repro_torch.serve import LLM, StreamRequest

ARCH = "qwen2.5-3b-reduced"
PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5, 4], [1, 2], [3, 3, 3, 3, 3]]

# name -> (plan geometry, max_new, arrivals)
MIXES = {
    "prompts": (dict(rows=2, cache_len=64, page_size=8, sync_every=4), 5,
                None),
    "staggered": (dict(rows=2, cache_len=64, page_size=8, sync_every=4), 4,
                  [0.0, 0.0, 6.0, 13.0]),
    "preemption": (dict(rows=3, cache_len=64, page_size=4, num_pages=6,
                        sync_every=4), 12, None),
}


@pytest.fixture(scope="module")
def weights():
    rcfg = rget_config(ARCH)
    dense = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    packed, _ = rsparse.sparsify_mlp_params(dense, rcfg, 0.5)
    return rcfg, {"dense": dense, "packed": packed}


def _streams(rcfg, rparams, mix, fused_m_max="plan", **plan_kw):
    """(reference streams, port streams, reference stats, port stats)."""
    geometry, max_new, arrivals = MIXES[mix]
    plan = rplan.plan_for_scheduler(rcfg, share_prefix=False,
                                    **{**geometry, **plan_kw})
    if fused_m_max != "plan":
        plan = dataclasses.replace(plan, mlp_fused_m_max=fused_m_max)
    arr = arrivals or [0.0] * len(PROMPTS)
    sch = ContinuousBatchingScheduler(rcfg, rparams, plan, eos_id=-1,
                                      guard=None)
    ref = sorted(sch.run([RRequest(i, p, max_new, arrival=a)
                          for i, (p, a) in enumerate(zip(PROMPTS, arr))]),
                 key=lambda r: r.rid)
    llm = LLM(get_config(ARCH),
              bridge.params_from_numpy(jax.tree.map(np.asarray, rparams)),
              pplan.ServePlan.from_dict(plan.as_dict()), eos_id=-1,
              device="cpu", guard=False)
    seen = {}
    got = llm.stream([StreamRequest(i, p, max_new, arrival=a)
                      for i, (p, a) in enumerate(zip(PROMPTS, arr))],
                     on_token=lambda r, t: seen.setdefault(r.rid, []).append(t))
    assert all(seen[r.rid] == r.out for r in got)      # streamed in order
    return ([r.out for r in ref], [r.out for r in got], sch.phase_stats,
            llm.phase_stats, ref, got)


@pytest.mark.parametrize("mix", list(MIXES))
def test_stream_matches_reference_dense(weights, mix):
    rcfg, params = weights
    ref, got, rst, pst, rreq, preq = _streams(rcfg, params["dense"], mix)
    assert got == ref
    for key in ("decode_chunks", "decode_steps", "prefill_batches",
                "preemptions", "idle_steps"):
        assert pst[key] == rst[key], key
    for r, p in zip(rreq, preq):
        assert (p.admitted_at, p.first_token_at, p.finished_at) == \
            (r.admitted_at, r.first_token_at, r.finished_at)
    if mix == "preemption":
        assert pst["preemptions"] > 0
        assert pst["pages"]["pages_free"] == pst["pages"]["pages_total"]


@pytest.mark.parametrize("fused_m_max", ["plan", 0])
def test_stream_matches_reference_packed(weights, monkeypatch, fused_m_max):
    """MLPs packed at 0.5, on the preemption mix. With the plan's crossover
    every MLP runs the fused sparse kernel; with ``mlp_fused_m_max=0`` every
    MLP takes the two-call arm: the GEMV at M <= 8 (decode, short prefills)
    and the GEMM above (re-prefills after preemption), in both packages."""
    rcfg, params = weights
    calls = {"bcsc_mlp_plain": 0, "bcsc_gemv_plain": 0,
             "bcsc_matmul_plain": 0}
    for name in calls:
        fn = getattr(pops._bcsc if "mlp" not in name else pops._bmlp, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(pops._bcsc if "mlp" not in name else pops._bmlp,
                            name, counted)
    ref, got, rst, pst, _, _ = _streams(rcfg, params["packed"], "preemption",
                                        fused_m_max=fused_m_max)
    assert got == ref
    assert pst["preemptions"] == rst["preemptions"] > 0
    if fused_m_max == 0:
        assert calls["bcsc_mlp_plain"] == 0
        assert calls["bcsc_gemv_plain"] > 0 and calls["bcsc_matmul_plain"] > 0
    else:
        assert calls["bcsc_mlp_plain"] > 0
        assert calls["bcsc_gemv_plain"] == calls["bcsc_matmul_plain"] == 0


def test_stream_int8_kv_matches_reference(weights):
    """int8 pages with per-(page, KV head) scales, preemption included."""
    rcfg, params = weights
    ref, got, rst, pst, _, _ = _streams(rcfg, params["dense"], "preemption",
                                        kv_quant="int8")
    assert pst["kv_quant"] == "int8" and got == ref
    assert pst["preemptions"] == rst["preemptions"] > 0


@pytest.mark.parametrize("arch,rows,cache_len,kw", [
    (ARCH, 2, 64, dict(page_size=8)),
    (ARCH, 3, 64, dict(page_size=4, num_pages=6, kv_quant="int8")),
    (ARCH, 2, 64, dict(attn_path="contiguous")),
    ("qwen2.5-3b", 8, 1024, dict(page_size=64)),
    ("qwen2.5-3b", 8, 1024, dict()),
    ("gemma2-2b-reduced", 2, 96, dict(page_size=8)),
    ("gemma2-2b-reduced", 3, 96, dict(page_size=8, num_pages=16,
                                      kv_quant="int8")),
    ("gemma2-2b", 4, 8192, dict(page_size=64)),
    ("gemma2-2b", 4, 8192, dict(page_size=64, attn_path="paged",
                                kv_quant="fp")),
])
def test_plan_for_scheduler_matches_reference(arch, rows, cache_len, kw):
    """Every dispatch field of the port's plan equals the reference's."""
    ref = rplan.plan_for_scheduler(rget_config(arch), rows=rows,
                                   cache_len=cache_len, share_prefix=False,
                                   **kw).as_dict()
    mine = pplan.plan_for_scheduler(get_config(arch), rows=rows,
                                    cache_len=cache_len, share_prefix=False,
                                    **kw).as_dict()
    assert set(mine) == set(ref)
    for key, value in mine.items():
        if key == "decisions":       # test_torch_telemetry holds the records
            continue
        want = ref[key]
        assert (tuple(value) if isinstance(value, (list, tuple)) else value) \
            == (tuple(want) if isinstance(want, (list, tuple)) else want), key


def test_unported_plan_features_raise(weights):
    rcfg, params = weights
    cfg = get_config(ARCH)
    tree = bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                 params["dense"]))
    base = pplan.plan_for_scheduler(cfg, rows=2, cache_len=64, page_size=8,
                                    share_prefix=False)
    for change in (dict(share_prefix=True), dict(spec_k=4), dict(tp=2)):
        with pytest.raises(NotImplementedError):
            LLM(cfg, tree, dataclasses.replace(base, **change), device="cpu")
    guarded = LLM(cfg, tree, base, eos_id=-1, device="cpu", guard=True)
    assert [r.outcome.status for r in guarded.stream([([1, 2, 3], 2)])] \
        == ["ok"]
    assert guarded.phase_stats["guard_enabled"]
    llm = LLM(cfg, tree, base, eos_id=-1, device="cpu")
    with pytest.raises(ValueError, match="cache_len"):
        llm.stream([([1] * 60, 8)])
    done = llm.stream([([1, 2, 3], 2), {"prompt": [4, 5], "max_new": 0}])
    assert [len(r.out) for r in done] == [2, 0]


def test_length_tier_matches_reference():
    from repro.serve.engine import length_tier as ref_tier
    from repro_torch.serve.engine import length_tier
    for plen in (1, 2, 3, 5, 8, 9, 63, 64, 65, 600):
        for cache_len in (0, 64, 1024):
            for recurrent in (False, True):
                assert length_tier(plen, recurrent, cache_len) == \
                    ref_tier(plen, recurrent, cache_len)


def test_allocators_match_reference():
    """The same seeded sequence of page and row operations through the
    reference's allocators and the port's copies: identical block tables,
    free counts, occupancy stats and row pop order."""
    from repro.serve.kvcache import SlotAllocator as RSlots
    from repro.serve.paging import PageAllocator as RPages
    from repro_torch.serve.kvcache import SlotAllocator
    from repro_torch.serve.paging import PageAllocator
    rng = np.random.default_rng(7)
    ref, mine = RPages(12, page_size=4), PageAllocator(12, page_size=4)
    rslots, slots = RSlots(4), SlotAllocator(4)
    live = {}
    for step in range(200):
        rid = int(rng.integers(0, 6))
        if rid in live and rng.random() < 0.3:
            assert ref.free(rid) == mine.free(rid)
            rslots.free(live[rid])
            slots.free(live.pop(rid))
        else:
            n = int(rng.integers(1, 20))
            ok = ref.ensure(rid, n)
            assert mine.ensure(rid, n) == ok
            if ok:
                ref.set_length(rid, n)
                mine.set_length(rid, n)
                if rid not in live and slots.available():
                    live[rid] = slots.alloc_many(1)[0]
                    assert rslots.alloc_many(1) == [live[rid]]
        assert ref.available() == mine.available()
        assert ref.in_use == mine.in_use and rslots.in_use == slots.in_use
        ours = mine.stats()                 # theirs adds sharing counters
        assert {k: ref.stats()[k] for k in ours} == ours
        for r in live:
            assert ref.table(r) == mine.table(r)
        rids = list(live) + [-1]
        np.testing.assert_array_equal(ref.block_table_rows(rids, 5),
                                      mine.block_table_rows(rids, 5))
    assert rslots.live_slots() == slots.live_slots()
