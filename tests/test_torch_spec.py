"""Speculative decoding in the port against the reference.

``decoding.verify_step`` (k candidates scored in one step over B·k virtual
rows) is held against the reference's ``verify_step`` on the same weights
and prefilled pages, within 1e-2 of max |logit| as every logits test of the
port, and against the port's own k sequential ``serve_step`` calls from the
same state: on the CPU within ``VERIFY_SEQ_TOL`` of max |logit| (the
flattened step's matmuls run at M = k, the sequential ones at M = 1; the
reference's own verifier parts from its sequential steps by up to 1.1e-5
relative here, which is why its bit-exact test fails on the CPU) with equal
argmaxes. Dead rows' appends drop, int8 pools take the sequential fallback
(bit-equal), non-global configs are refused. The fork ceremony and
``plan_serve``'s ``spec`` decision equal the reference's.

The scheduler cases are those of ``tests/test_spec_decode.py``, on
``qwen2.5-3b-reduced`` with the reference's weights bridged, greedy, through
the port's ``LLM.stream`` on ``plan_serve`` plans with ``spec_k`` pinned:
every speculative stream equals the port's sequential one (``spec_k=0``)
and the reference's. The speculative round as a CUDA graph (and the int8
rung under a speculative plan on the card) is tested in
``tests/test_torch_engine.py``, whose ``gpu`` tests need no JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import plan as rplan
from repro.models import decoding as rdec
from repro.models import transformer as rtfm
from repro.serve.scheduler import ContinuousBatchingScheduler
from repro.serve.scheduler import StreamRequest as RRequest

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import eyexam
from repro_torch.core import plan as pplan
from repro_torch.models import decoding as pdec
from repro_torch.models import transformer as ptfm
from repro_torch.serve import LLM, StreamRequest
from repro_torch.serve import engine as peng
from repro_torch.serve.guard import GuardConfig
from test_torch_prefix import Pair
from torch_dense_parity import compare_streams

ARCH = "qwen2.5-3b-reduced"          # GQA: 4 query heads over 2 KV heads
VERIFY_SEQ_TOL = 1e-5                # measured here: at most 1.4e-7
CACHE, PS, K = 64, 8, 4


@pytest.fixture(scope="module")
def qwen():
    rcfg = rget_config(ARCH)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, get_config(ARCH), ptfm.compute_copy(
        bridge.params_from_numpy(jax.tree.map(np.asarray, rparams)))


def _plan(cfg, kv_quant="fp"):
    return pplan.plan_for_scheduler(cfg, rows=1, cache_len=CACHE,
                                    page_size=PS, attn_path="paged",
                                    kv_quant=kv_quant)


def _port_row(cfg, params, prompt, kv_quant="fp", rows=1):
    """``prompt`` prefilled into row 0 of a paged cache (rows beyond it
    dead): (cache, block table (rows, MP), plan)."""
    plan = _plan(cfg, kv_quant)
    MP = CACHE // PS
    bt = torch.full((rows, MP), -1, dtype=torch.int32)
    bt[0] = torch.arange(MP)
    cache = pdec.init_paged_cache(cfg, rows, CACHE, rows * MP, PS, kv_quant)
    S = 1 << (len(prompt) - 1).bit_length()
    toks = torch.tensor([prompt + [0] * (S - len(prompt))])
    pp = pdec.PagedPrefill(cache=cache, block_table_rows=bt[:1],
                           slots=torch.arange(1),
                           write_start=torch.zeros(1, dtype=torch.int32))
    pdec.prefill_batched(params, toks, torch.tensor([len(prompt)]), cfg,
                         CACHE, plan=plan, paged=pp)
    return cache, bt, plan


def _clone(cache):
    return {"blocks": {n: {k: t.clone() for k, t in e.items()}
                       for n, e in cache["blocks"].items()}}


def _sequential(cfg, params, cache, bt, plan, cand, pos):
    out = []
    for i, t in enumerate(cand):
        lg, cache = pdec.serve_step(params, cache, torch.tensor([[t]]),
                                    torch.tensor([pos + i]), cfg, plan=plan,
                                    block_table=bt)
        out.append(lg[0, 0])
    return torch.stack(out), cache


def _gap(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ verify_step
@pytest.mark.parametrize("plen", [3, 6, 8, 13])
def test_verify_matches_reference_and_sequential(qwen, plen):
    """Candidate windows inside a page, across a page boundary and
    page-aligned (pages of 8: [3, 7), [6, 10), [8, 12), [13, 17))."""
    rcfg, rparams, cfg, params = qwen
    rng = np.random.default_rng(plen)
    prompt = [int(t) for t in rng.integers(0, 500, plen)]
    cand = [int(t) for t in rng.integers(0, 500, K)]
    cache, bt, plan = _port_row(cfg, params, prompt)
    seq, _ = _sequential(cfg, params, _clone(cache), bt, plan, cand, plen)
    flat, _ = pdec.verify_step(params, cache, torch.tensor([cand]),
                               torch.tensor([plen]), cfg, plan=plan,
                               block_table=bt)
    assert flat.shape == (1, K, cfg.vocab_padded)
    V = cfg.vocab_size
    assert _gap(flat[0, :, :V], seq[:, :V]) <= VERIFY_SEQ_TOL
    assert torch.equal(flat[0].argmax(-1), seq.argmax(-1))

    MP = CACHE // PS
    rbt = jnp.arange(MP, dtype=jnp.int32)[None]
    rcache = rdec.init_paged_cache(rcfg, 1, CACHE, MP, PS)
    S = 1 << (plen - 1).bit_length()
    pp = rdec.PagedPrefill(cache=rcache, block_table_rows=rbt,
                           slots=jnp.asarray([0]),
                           write_start=jnp.asarray([0]))
    _, rcache = rdec.prefill_batched(
        rparams, jnp.asarray([prompt + [0] * (S - plen)], jnp.int32),
        jnp.asarray([plen]), rcfg, CACHE, paged=pp)
    ref, _ = rdec.verify_step(rparams, rcache, jnp.asarray([cand]),
                              jnp.asarray([plen], jnp.int32), rcfg,
                              block_table=rbt)
    assert _gap(flat[0, :, :V], np.asarray(ref)[0, :, :V]) <= 1e-2


def test_verify_dead_row_writes_drop(qwen):
    """A second row with an all -1 table (an empty row) in the flattened
    batch: its appends drop and the live row's logits and pages are what
    the one-row verify gives."""
    _, _, cfg, params = qwen
    prompt, cand = [5, 6, 7], [11, 12, 13, 14]
    one, bt1, plan = _port_row(cfg, params, prompt)
    two, bt2, _ = _port_row(cfg, params, prompt, rows=2)
    want, one = pdec.verify_step(params, one, torch.tensor([cand]),
                                 torch.tensor([3]), cfg, plan=plan,
                                 block_table=bt1)
    got, two = pdec.verify_step(params, two, torch.tensor([cand, cand]),
                                torch.tensor([3, 0]), cfg, plan=plan,
                                block_table=bt2)
    assert torch.equal(got[0], want[0])
    MP = CACHE // PS
    for name, e in two["blocks"].items():
        for k in ("pk", "pv"):
            assert torch.equal(e[k][:, :MP], one["blocks"][name][k])
            assert not e[k][:, MP:].any()          # the dead row's pages


def test_verify_int8_fallback_matches_sequential(qwen):
    """int8 pools: the sequential fallback, bit-equal in logits and pools."""
    _, _, cfg, params = qwen
    prompt, cand = [9, 8, 7, 6, 5], [3, 4, 5, 6]
    cache, bt, plan = _port_row(cfg, params, prompt, "int8")
    seq, seq_cache = _sequential(cfg, params, _clone(cache), bt, plan, cand,
                                 5)
    flat, cache = pdec.verify_step(params, cache, torch.tensor([cand]),
                                   torch.tensor([5]), cfg, plan=plan,
                                   block_table=bt)
    assert torch.equal(flat[0], seq)
    for name, e in cache["blocks"].items():
        for k, t in e.items():
            assert torch.equal(t, seq_cache["blocks"][name][k])


def test_verify_rejects_non_global_configs():
    cfg = get_config("gemma2-2b-reduced")        # local and global layers
    params = ptfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    plan = _plan(cfg)
    cache = pdec.init_paged_cache(cfg, 1, 32, 4, 8)
    with pytest.raises(ValueError, match="all-global"):
        pdec.verify_step(params, cache, torch.tensor([[1, 2]]),
                         torch.tensor([0]), cfg, plan=plan,
                         block_table=torch.zeros((1, 4), dtype=torch.int32))


def test_ngram_successor_matches_reference():
    from repro.serve.engine import ngram_successor as rsucc
    rng = np.random.default_rng(4)
    hist = rng.integers(0, 5, (6, 24)).astype(np.int32)
    hist[:, 18:] = -1
    pos = np.array([0, 1, 5, 12, 18, 24], np.int32)
    tok = rng.integers(0, 6, 6).astype(np.int32)
    want = np.asarray(rsucc(jnp.asarray(hist), jnp.asarray(pos),
                            jnp.asarray(tok)))
    got = peng.ngram_successor(torch.from_numpy(hist), torch.from_numpy(pos),
                               torch.from_numpy(tok).long())
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ forks
def test_fork_ceremony_matches_reference():
    """Fork, abort, fork, grow the branch, commit; the CoW-tail fork; a
    fork under pressure returning None: both allocators, audited."""
    c = Pair(8, 4)
    assert c.ensure(0, 10)
    c.set_length(0, 10)
    pages = c.mine.table(0)
    assert c.fork_chain(0, -2) == ()
    assert all(c.mine.refcount(p) == 2 for p in pages)
    c.check("fork")
    assert c.abort_fork(-2) == 0
    assert all(c.mine.refcount(p) == 1 for p in pages)
    c.fork_chain(0, -2)
    assert c.ensure(-2, 14)
    c.set_length(-2, 14)
    c.commit_fork(0, -2)
    c.check("commit")
    assert c.mine.pages_of(0) == 4 and c.mine.snapshot()["lengths"][0] == 14
    d = Pair(8, 4)
    assert d.ensure(0, 6)
    d.set_length(0, 6)
    assert len(d.fork_chain(0, -2, cow_tail=True)) == 2
    t0, t1 = d.mine.table(0), d.mine.table(-2)
    assert t0[0] == t1[0] and t0[1] != t1[1]
    d.check("cow tail")
    e = Pair(2, 4)
    assert e.ensure(0, 6)
    e.set_length(0, 6)
    assert e.fork_chain(0, -2, cow_tail=True) is None
    assert e.mine.pages_of(-2) == 0
    e.check("fork under pressure")


# ------------------------------------------------------------------ plans
PLAN_CASES = [
    ("qwen2.5-3b", dict(hbm_budget_bytes=8 << 30, expected_batch=1,
                        expected_len_dist={"mean": 512, "max": 2048},
                        attn_path="paged")),
    ("qwen2.5-3b", dict(hbm_budget_bytes=8 << 30, expected_batch=4,
                        expected_len_dist={"mean": 512, "max": 2048},
                        attn_path="paged")),
    ("qwen2.5-3b", dict(hbm_budget_bytes=8 << 30, expected_batch=1,
                        expected_len_dist=[69, 128, 364, 575])),
    ("mistral-nemo-12b", dict(hbm_budget_bytes=16 << 30, expected_batch=1,
                              expected_len_dist={"mean": 1024,
                                                 "max": 4096})),
    ("gemma2-2b", dict(hbm_budget_bytes=8 << 30, expected_batch=1,
                       expected_len_dist={"mean": 512, "max": 2048})),
    (ARCH, dict(hbm_budget_bytes=1 << 30, expected_batch=2,
                expected_len_dist={"mean": 24, "max": 64}, page_size=8,
                attn_path="paged", spec_k=4)),
    (ARCH, dict(hbm_budget_bytes=1 << 20, expected_batch=8,
                expected_len_dist={"mean": 24, "max": 64}, page_size=8,
                num_pages=9, kv_quant="int8")),
]


@pytest.mark.parametrize("arch,kw", PLAN_CASES)
def test_plan_serve_matches_reference(arch, kw):
    """Every field of ``plan_serve``'s plan and every decision (name,
    choice, bound, why and numbers; the ``spec`` decision's among them)
    equal the reference's at the reference's device rates; the batch-1 rule
    speculates on qwen2.5-3b and mistral-nemo-12b, not at 4 rows nor on
    gemma2-2b."""
    ref = rplan.plan_serve(rget_config(arch), **kw)
    mine = pplan.plan_serve(get_config(arch), rates=eyexam.TPU_V5E, **kw)
    for key, value in mine.as_dict().items():
        if key != "decisions":
            want = getattr(ref, key)
            assert (tuple(value) if isinstance(value, (list, tuple))
                    else value) == (tuple(want) if isinstance(
                        want, (list, tuple)) else want), key
    assert [d.name for d in mine.decisions] == [
        "capacity", "matmul", "mlp", "attention", "kv_quant", "spec",
        "degrade", "prefill"]
    assert [dataclasses.asdict(d) for d in mine.decisions] == \
        [dataclasses.asdict(d) for d in ref.decisions]
    rule = kw.get("expected_batch") == 1 and arch in ("qwen2.5-3b",
                                                      "mistral-nemo-12b")
    if "spec_k" not in kw:
        assert (mine.spec_k > 0) == rule


def test_plan_spec_pin_validation():
    cfg = get_config(ARCH)
    kw = dict(hbm_budget_bytes=1 << 30, expected_batch=2,
              expected_len_dist={"mean": 24, "max": 64}, page_size=8,
              attn_path="paged")
    assert pplan.plan_serve(cfg, **kw, spec_k=4).spec_k == 4
    with pytest.raises(ValueError, match="spec_k must be 0 or in"):
        pplan.plan_serve(cfg, **kw, spec_k=1)
    with pytest.raises(ValueError, match="all-global"):
        pplan.plan_serve(get_config("gemma2-2b-reduced"), **kw, spec_k=4)
    with pytest.raises(ValueError, match="cannot hold"):
        pplan.plan_serve(cfg, **{**kw, "hbm_budget_bytes": 10})
    sharded = pplan.plan_serve(cfg, **kw, mesh="tp=2", spec_k=4)
    assert (sharded.tp, sharded.spec_k) == (2, 4)
    assert pplan.plan_for_scheduler(cfg, rows=2, cache_len=64,
                                    page_size=8).spec_k == 0


# -------------------------------------------------------------- scheduler
def _mkplan(mod, cfg, k, batch=2, ps=8, **kw):
    return mod.plan_serve(cfg, hbm_budget_bytes=1 << 30,
                          expected_batch=batch,
                          expected_len_dist={"mean": 24, "max": 64},
                          page_size=ps, attn_path="paged", spec_k=k, **kw)


def _port_run(qwen, plan, reqs, sync_every=4, eos_id=-1, **llm_kw):
    _, _, cfg, params = qwen
    llm = LLM(cfg, params, dataclasses.replace(plan, sync_every=sync_every),
              eos_id=eos_id, device="cpu", guard=False, **llm_kw)
    done = llm.stream([StreamRequest(i, list(p), m, arrival=t)
                       for i, (p, m, t) in enumerate(reqs)])
    return {r.rid: r.out for r in done}, llm


def _ref_run(qwen, plan, reqs, sync_every=4, eos_id=-1):
    rcfg, rparams, _, _ = qwen
    sch = ContinuousBatchingScheduler(rcfg, rparams, plan,
                                      sync_every=sync_every, eos_id=eos_id)
    done = sch.run([RRequest(i, list(p), m, arrival=t)
                    for i, (p, m, t) in enumerate(reqs)],
                   rng=jax.random.PRNGKey(7))
    return {r.rid: r.out for r in done}


def _spec_vs_both(qwen, reqs, k, sync_every=4, eos_id=-1, **plan_kw):
    """(port speculative run's LLM) after asserting its streams equal the
    port's sequential run's, and those the reference's sequential run's up
    to a parting at a near-tie of the reference's logits
    (``torch_dense_parity.compare_streams``)."""
    rcfg, rparams, cfg, _ = qwen
    want = _ref_run(qwen, _mkplan(rplan, rcfg, 0, **plan_kw), reqs,
                    sync_every, eos_id)
    seq, _ = _port_run(qwen, _mkplan(pplan, cfg, 0, **plan_kw), reqs,
                       sync_every, eos_id)
    spec, llm = _port_run(qwen, _mkplan(pplan, cfg, k, **plan_kw), reqs,
                          sync_every, eos_id)
    assert spec == seq
    rids = sorted(want)
    compare_streams(rcfg, rparams, [reqs[i][0] for i in rids],
                    [seq[i] for i in rids], [want[i] for i in rids])
    return llm


@pytest.mark.parametrize("sync_every", [1, 4])
def test_spec_staggered(qwen, sync_every):
    """Staggered arrivals (empty rows in early chunks: the fork-id case)."""
    reqs = [([5, 6, 7], 9, 0.0), ([3, 4], 3, 2.0), ([9, 9, 9, 2], 7, 5.0)]
    llm = _spec_vs_both(qwen, reqs, 4, sync_every)
    st = llm.phase_stats
    assert st["spec_k"] == 4 and st["spec_rounds"] > 0
    assert 0 < st["spec_accepted_tokens"] <= st["spec_drafted_tokens"]
    assert st["pages"]["pages_free"] == st["pages"]["pages_total"]
    m = llm.telemetry().metrics.counters
    assert m["spec_rounds"] == st["spec_rounds"]
    assert m["spec_accepted_tokens"] == st["spec_accepted_tokens"]
    assert [e for e in llm.telemetry().tracer.events
            if e.name == "spec_chunk"]


def test_spec_eos_inside_a_draft(qwen):
    """An EOS among accepted candidates ends the stream where the
    sequential path ends it (the EOS itself emitted)."""
    _, _, cfg, _ = qwen
    reqs = [([5, 6, 7], 12, 0.0), ([3, 4], 12, 0.0)]
    base, _ = _port_run(qwen, _mkplan(pplan, cfg, 0), reqs)
    eos = base[0][1]
    _spec_vs_both(qwen, reqs, 4, eos_id=eos)
    got, _ = _port_run(qwen, _mkplan(pplan, cfg, 4), reqs, eos_id=eos)
    assert got[0][-1] == eos and len(got[0]) == 2


def test_spec_preemption_and_fast_resume(qwen):
    """Page pressure under speculation: preemptions, and the suffix-only
    resume on the shared prefix, keep the streams."""
    pre = [7, 3, 9, 4, 2, 8, 6, 1]            # two shared pages of 4
    reqs = [(pre + [11, 12], 24, 0.0), (pre + [13, 14], 10, 1.0),
            (pre + [15, 16], 10, 2.0)]
    rcfg, _, cfg, _ = qwen
    want = _ref_run(qwen, _mkplan(rplan, rcfg, 0, batch=3, ps=4), reqs, 2)
    for k in (0, 2):
        plan = dataclasses.replace(_mkplan(pplan, cfg, k, batch=3, ps=4),
                                   num_pages=9)
        got, llm = _port_run(qwen, plan, reqs, 2)
        assert got == want, k
        st = llm.phase_stats
        assert st["preemptions"] > 0
        assert st["resume_fast_prompts"] > 0 and st["resume_fast_tokens"] > 0
    assert llm._scheduler.spec_on and st["spec_rounds"] > 0


def test_spec_seeded_sweep(qwen):
    """Request shapes, EOS ids, chunk lengths and draft depths drawn from a
    seeded generator: every speculative stream equals its sequential twin,
    and that the reference's (the first trial's first request parts at a
    near-tie of its prefill logits, 308 against 72)."""
    rng = np.random.default_rng(0)
    for _ in range(3):
        n = int(rng.integers(2, 5))
        reqs = [([int(t) for t in rng.integers(0, 500, rng.integers(1, 9))],
                 int(rng.integers(1, 12)), float(rng.integers(0, 8)))
                for _ in range(n)]
        eos = int(rng.integers(-1, 600))
        T = int(rng.choice([1, 2, 4]))
        k = int(rng.choice([2, 3, 8]))
        _spec_vs_both(qwen, reqs, k, T, eos)


def test_spec_off_with_temperature(qwen):
    """Sampling turns speculation off at run time (greedy only)."""
    _, _, cfg, params = qwen
    plan = _mkplan(pplan, cfg, 4)
    hot = LLM(cfg, params, plan, eos_id=-1, device="cpu", temperature=0.8)
    assert not hot._scheduler.spec_on and hot._scheduler._loop.spec_k == 0
    cold = LLM(cfg, params, plan, eos_id=-1, device="cpu")
    assert cold._scheduler.spec_on and cold._scheduler._loop.spec_k == 4


def test_spec_int8_rung_steps_plain(qwen, monkeypatch):
    """The int8 rung under a speculative plan (chunks of 2 rounds, so the
    rung fires at step 4 with live rows), with a stand-in step graph on the
    CPU: speculation ends at the rung, the loop captures the plain step
    over the int8 pools, the streams equal the eager run's and the
    sequential plan's."""
    from test_torch_guard import _StandInGraph
    _, _, cfg, params = qwen
    monkeypatch.setattr(peng, "StepGraph", _StandInGraph)
    reqs = [dict(rid=i, prompt=[3 + i, 5, 7, 11], max_new=16,
                 arrival=float(i)) for i in range(6)]
    outs = {}
    for name, k, graphed in (("seq", 0, False), ("eager", 4, False),
                             ("graphed", 4, True)):
        plan = dataclasses.replace(_mkplan(pplan, cfg, k, batch=4, ps=4),
                                   num_pages=16, sync_every=2)
        llm = LLM(cfg, params, plan, eos_id=-1, device="cpu",
                  guard=_rung_guard())
        loop = llm._scheduler._loop
        loop.use_graph = graphed
        done = llm.stream([StreamRequest(**r) for r in reqs])
        st = llm.phase_stats
        assert st["kv_quant"] == "int8" and st["degraded_to_int8_at"] > 0
        assert all(r.outcome.ok for r in done)
        outs[name] = [r.out for r in done]
        if k:
            assert st["spec_rounds"] > 0 and not llm._scheduler.spec_on
            assert loop.spec_k == 0 and loop.nxt.shape == (4,)
        if graphed:
            assert len(loop.captures) == 2
    assert outs["graphed"] == outs["eager"] == outs["seq"]


def _rung_guard():
    """The reference guard mixes' int8 rung: it fires at 30 % occupancy."""
    return GuardConfig(int8_pressure=0.3)
