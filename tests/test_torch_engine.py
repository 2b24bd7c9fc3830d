"""The port's drain engine and device-resident decode loop.

On the CPU: ``repro_torch``'s ``LLM.generate`` / ``DecodeEngine`` against the
reference ``DecodeEngine`` on the same bridged weights (dense, and MLPs
BCSC-packed at 0.5), with the cases of ``tests/test_decode_fastpath.py``:
EOS mid-chunk, budgets that end mid-chunk, more requests than slots, one
host transfer per decode chunk. Greedy streams must be equal, request by
request. ``plan_for_engine`` must resolve the reference's fields, and the
in-place step body that a ``StepGraph`` captures must equal the functional
``make_decode_step`` over several chunks, bit for bit.

The ``gpu``-marked tests hold the graphed decode step against the eager one
on the card and skip where there is none; like those of
``tests/test_torch_kernels.py`` they need neither JAX nor the reference
package (imported only through the ``ref`` fixture), so ``-m gpu`` runs on a
machine without JAX.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import plan as pplan
from repro_torch.kernels import _build
from repro_torch.kernels import ops as pops
from repro_torch.models import transformer as ptfm
from repro_torch.serve import LLM, DecodeEngine, Request, StreamRequest
from repro_torch.serve import engine as peng
from repro_torch.serve.graphs import WARMUP_STEPS
from repro_torch.serve.guard import RequestOutcome
from repro_torch.serve.sparse import sparsify_mlp_params
from repro_torch.serve.telemetry import Telemetry

ARCHS = ("qwen2.5-3b-reduced", "gemma2-2b-reduced")
# five requests over two slots, sync_every 4: every budget but the 8 ends
# inside a chunk, and three requests wait for a slot
PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5, 4], [1, 2], [3, 3, 3, 3, 3], [7, 11]]
BUDGETS = [6, 3, 8, 5, 2]
SLOTS, CACHE, T = 2, 48, 4


@pytest.fixture(scope="module")
def ref():
    """The reference package's pieces these tests compare against."""
    import jax
    from repro.configs import get_config as get_cfg
    from repro.core import plan
    from repro.models import decoding, transformer
    from repro.serve import engine, sparse
    return types.SimpleNamespace(jax=jax, get_config=get_cfg, plan=plan,
                                 decoding=decoding, transformer=transformer,
                                 engine=engine, sparse=sparse)


@pytest.fixture(scope="module")
def weights(ref):
    """arch -> (reference config, {"dense": params, "packed": params})."""
    out = {}
    for arch in ARCHS:
        rcfg = ref.get_config(arch)
        dense = ref.transformer.init_params(ref.jax.random.PRNGKey(0), rcfg)
        packed, _ = ref.sparse.sparsify_mlp_params(dense, rcfg, 0.5)
        out[arch] = (rcfg, {"dense": dense, "packed": packed})
    return out


def _bridged(ref, rparams):
    return bridge.params_from_numpy(ref.jax.tree.map(np.asarray, rparams))


def _ref_drain(ref, rcfg, rparams, eos_id):
    """The reference DecodeEngine over PROMPTS / BUDGETS: (plan, engine,
    requests ordered by rid)."""
    plan = ref.plan.plan_for_engine(rcfg, slots=SLOTS, cache_len=CACHE,
                                    sync_every=T)
    eng = ref.engine.DecodeEngine(rcfg, rparams, plan, eos_id=eos_id)
    done = eng.run([ref.engine.Request(i, p, n)
                    for i, (p, n) in enumerate(zip(PROMPTS, BUDGETS))])
    return plan, eng, sorted(done, key=lambda r: r.rid)


@pytest.mark.parametrize("kind", ["dense", "packed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference_engine(ref, weights, arch, kind):
    """Greedy streams equal the reference engine's, without EOS (every
    budget spent, most inside a chunk) and with an EOS id that a stream
    emits mid-chunk; one host transfer per decode chunk; the same phase
    counters, every request ``RequestOutcome("ok")``."""
    rcfg, params = weights[arch]
    rparams = params[kind]
    plan, reng, rdone = _ref_drain(ref, rcfg, rparams, -1)
    assert [len(r.out) for r in rdone] == BUDGETS
    eos = rdone[2].out[1]                  # emitted at step 1 of a chunk
    runs = [(-1, reng, rdone), (eos, *_ref_drain(ref, rcfg, rparams,
                                                  eos)[1:])]
    assert len(runs[1][2][2].out) < BUDGETS[2]
    tree = _bridged(ref, rparams)
    for eos_id, eng_ref, want in runs:
        llm = LLM(get_config(arch), tree,
                  pplan.ServePlan.from_dict(plan.as_dict()), eos_id=eos_id,
                  device="cpu")
        got = llm.generate(list(zip(PROMPTS, BUDGETS)))
        assert [r.rid for r in got] == list(range(len(PROMPTS)))
        assert [r.out for r in got] == [r.out for r in want]
        assert all(r.done and r.outcome == RequestOutcome("ok")
                   for r in got)
        st, rst = llm.phase_stats, eng_ref.phase_stats
        assert set(st) == set(rst)
        for key in ("decode_chunks", "prefill_batches", "prefill_prompts",
                    "prefill_real_tokens", "prefill_padded_tokens"):
            assert st[key] == rst[key], key
        assert llm._engine.host_syncs == st["decode_chunks"] \
            == eng_ref.host_syncs
        assert llm._engine.graph is None      # the CPU decodes eagerly


def test_generate_reuses_its_engine_and_takes_every_request_form(ref,
                                                                 weights):
    rcfg, params = weights[ARCHS[0]]
    plan, _, rdone = _ref_drain(ref, rcfg, params["dense"], -1)
    llm = LLM(get_config(ARCHS[0]), _bridged(ref, params["dense"]),
              pplan.ServePlan.from_dict(plan.as_dict()), eos_id=-1,
              device="cpu")
    forms = [Request(0, PROMPTS[0], BUDGETS[0]),
             {"prompt": PROMPTS[1], "max_new": BUDGETS[1]},
             (PROMPTS[2], BUDGETS[2]), {"rid": 3, "prompt": PROMPTS[3],
                                        "max_new": BUDGETS[3]},
             Request(4, PROMPTS[4], BUDGETS[4])]
    first = llm.generate(forms)
    engine = llm._engine
    again = llm.generate(list(zip(PROMPTS, BUDGETS)))
    assert llm._engine is engine and engine.host_syncs == \
        2 * llm.phase_stats["decode_chunks"]
    assert [r.out for r in first] == [r.out for r in again] \
        == [r.out for r in rdone]
    empty = llm.generate([([1, 2], 0), ([3], 2)])
    assert empty[0].out == [] and empty[0].outcome.reason
    with pytest.raises(ValueError, match="cache_len"):
        llm.generate([([1] * 40, 9)])


@pytest.mark.parametrize("arch,slots,cache_len,sync_every", [
    ("qwen2.5-3b-reduced", 2, 48, 4),
    ("gemma2-2b-reduced", 3, 96, 8),
    ("qwen2.5-3b", 8, 1024, 8),
    ("gemma2-2b", 4, 8192, 8),
])
def test_plan_for_engine_matches_reference(ref, arch, slots, cache_len,
                                           sync_every):
    """Every dispatch field of the drain engine's plan equals the
    reference's: contiguous, no pages, the same fused-MLP crossover, tiers
    and routes."""
    want = ref.plan.plan_for_engine(ref.get_config(arch), slots=slots,
                                    cache_len=cache_len,
                                    sync_every=sync_every).as_dict()
    mine = pplan.plan_for_engine(get_config(arch), slots=slots,
                                 cache_len=cache_len,
                                 sync_every=sync_every).as_dict()
    assert set(mine) == set(want)
    for key, value in mine.items():
        if key == "decisions":       # test_torch_telemetry holds the records
            continue
        w = want[key]
        assert (tuple(value) if isinstance(value, (list, tuple)) else value) \
            == (tuple(w) if isinstance(w, (list, tuple)) else w), key
    assert mine["attn_path"] == "contiguous" and mine["num_pages"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_generate_fn_match_reference(ref, weights, arch):
    """``decoding.prefill`` (through ``make_prefill_step``) against the
    reference's single-length prefill, and one ``make_serve_step`` step on
    its cache against the reference's ``serve_step``: logits within 1e-2
    of max |logit| (fp32 sums in another order flip bf16 roundings), equal
    argmax; the fused prefill + decode loop of ``make_generate_fn`` gives
    the reference's greedy tokens."""
    rcfg, params = weights[arch]
    cfg = get_config(arch)
    rparams = params["dense"]
    tree = ptfm.compute_copy(_bridged(ref, rparams))
    plan = pplan.plan_for_engine(cfg, slots=2, cache_len=40)
    toks = np.random.default_rng(3).integers(2, rcfg.vocab_size, (2, 9))
    want, _ = ref.decoding.prefill(rparams, toks.astype(np.int32), rcfg, 40)
    got, cache = peng.make_prefill_step(cfg, 40, plan)(
        tree, torch.from_numpy(toks))
    want = np.asarray(want, np.float32)[..., :rcfg.vocab_size]
    got = got.numpy()[..., :cfg.vocab_size]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).all()
    assert all(t.shape[2] == (40 if kind == "global" else cfg.window_size)
               for (name, kind) in ptfm.slot_names(cfg)
               for t in cache["blocks"][name].values())
    nxt = got[:, -1].argmax(-1)[:, None]
    want_step, _ = ref.decoding.serve_step(
        rparams, ref.decoding.prefill(rparams, toks.astype(np.int32), rcfg,
                                      40)[1],
        nxt.astype(np.int32), np.int32(9), rcfg)
    step, _ = peng.make_serve_step(cfg, plan)(tree, cache,
                                              torch.from_numpy(nxt),
                                              torch.tensor(9))
    want_step = np.asarray(want_step, np.float32)[..., :rcfg.vocab_size]
    np.testing.assert_allclose(step.numpy()[..., :cfg.vocab_size], want_step,
                               rtol=0, atol=1e-2 * np.abs(want_step).max())
    rgen = ref.engine.make_generate_fn(rcfg, 6)(
        rparams, toks.astype(np.int32), ref.jax.random.PRNGKey(0))
    mine = peng.make_generate_fn(cfg, 6, plan=plan)(tree,
                                                     torch.from_numpy(toks))
    np.testing.assert_array_equal(mine.numpy(), np.asarray(rgen))


def _loop_case(arch, paged, kv_quant, temperature, device, packed=False,
               fused_m_max="plan", graphs=False, params=None):
    """A DecodeLoop of three rows and 64 tokens (pages of 4, so a row
    takes a new page every chunk of 4) with rows 0 and 2 refilled."""
    cfg = get_config(arch)
    if params is None:
        dense = ptfm.init_params(cfg, torch.Generator(device).manual_seed(0),
                                 device)
        params = sparsify_mlp_params(dense, cfg, sparsity=0.5)[0] \
            if packed else dense
        params = ptfm.compute_copy(params)
    plan = pplan.plan_for_scheduler(
        cfg, rows=3, cache_len=64, page_size=4, share_prefix=False,
        attn_path="paged" if paged else "contiguous", kv_quant=kv_quant,
        sync_every=T)
    if fused_m_max != "plan":
        plan = dataclasses.replace(plan, mlp_fused_m_max=fused_m_max)
    loop = peng.DecodeLoop(cfg, params, plan, temperature=temperature,
                           eos_id=-1, device=torch.device(device),
                           paged=plan.paged, sync_every=T, graphs=graphs)
    return cfg, params, plan, loop


def _tables(chunk: int, max_pages: int) -> np.ndarray:
    """Rows 0 and 2's page tables for chunk ``chunk`` (prompts of 9 and 13
    tokens, 4 steps a chunk, pages of 4): one more page a chunk, handed out
    interleaved."""
    table = np.full((3, max_pages), -1, np.int32)
    for row, n in ((0, 4 + chunk), (2, 5 + chunk)):
        table[row, :n] = [2 * j + (row // 2) for j in range(n)]
    return table


def _fill(cfg, params, plan, loop, seed=3):
    state = loop.start(seed)
    bt = loop.set_block_table(_tables(0, plan.max_pages)) \
        if plan.paged else None
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9] = np.arange(2, 11)
    toks[1, :13] = np.arange(20, 33)
    peng.refill_rows(params, cfg, plan, state, toks, np.array([9, 13]),
                     np.array([0, 2]), np.array([5, 14]), block_table=bt)
    return state, bt


def _flat(state):
    return list(peng._tensors(state))


def _clone(state):
    """A copy of (cache, last, pos, live, budget) that shares nothing."""
    cache = {"blocks": {name: {k: t.clone() for k, t in entry.items()}
                        for name, entry in state[0]["blocks"].items()}}
    return (cache,) + tuple(t.clone() for t in state[1:])


@pytest.mark.parametrize("arch,paged,kv_quant,temperature", [
    ("qwen2.5-3b-reduced", True, "fp", 0.0),
    ("qwen2.5-3b-reduced", True, "int8", 0.0),
    ("gemma2-2b-reduced", False, "fp", 0.0),
    ("gemma2-2b-reduced", True, "fp", 20.0),
])
def test_step_in_place_matches_functional(arch, paged, kv_quant,
                                          temperature):
    """Three chunks of the in-place body (what a StepGraph captures, run
    eagerly here) against ``make_decode_step`` carried functionally from a
    copy of the same state, with the same generator seed and a new block
    table each chunk: equal tokens, emit flags and live flags, and equal
    state bits (cache, last, pos, live, budget) after every chunk. Row 0's
    budget ends inside the second chunk; row 1 is never filled."""
    cfg, params, plan, loop = _loop_case(arch, paged, kv_quant, temperature,
                                         "cpu")
    state, _ = _fill(cfg, params, plan, loop)
    carry = _clone(state)
    step = peng.make_decode_step(cfg, plan, temperature, -1)
    gen = torch.Generator().manual_seed(3)
    for c in range(3):
        bt = None
        if paged:
            bt = torch.from_numpy(_tables(c, plan.max_pages))
            loop.set_block_table(_tables(c, plan.max_pages))
        toks, emits, live = loop.chunk()
        want_t, want_e = [], []
        for _ in range(T):
            carry, (nxt, emit) = step(params, carry, gen, bt)
            want_t.append(nxt)
            want_e.append(emit)
        np.testing.assert_array_equal(toks, torch.stack(want_t).numpy())
        np.testing.assert_array_equal(emits, torch.stack(want_e).numpy())
        np.testing.assert_array_equal(live, carry[3].numpy())
        for got, want in zip(_flat(state), _flat(carry)):
            assert torch.equal(got, want)
    assert emits.sum() > 0 and not live[0] and live[2]
    if temperature > 0:
        assert len(set(toks[:, 2].tolist())) > 1     # draws, not argmax


def test_scheduler_keeps_its_state_buffers(ref, weights):
    """The scheduler writes the decode state in place and never rebinds
    it: the loop's buffers are the same tensors at every chunk and across
    runs (what lets a captured graph own them), and a second run on them
    gives the same streams."""
    rcfg, params = weights[ARCHS[0]]
    cfg = get_config(ARCHS[0])
    plan = pplan.plan_for_scheduler(cfg, rows=3, cache_len=64, page_size=4,
                                    num_pages=6, share_prefix=False,
                                    sync_every=4)
    llm = LLM(cfg, _bridged(ref, params["dense"]), plan, eos_id=-1,
              device="cpu", guard=False)
    loop = llm._scheduler._loop
    seen = []
    chunk = loop.chunk

    def watched():
        seen.append([t.data_ptr() for t in _flat(loop.state)]
                    + [loop.block_table.data_ptr()])
        return chunk()
    loop.chunk = watched
    reqs = [(p, 12) for p in PROMPTS[:4]]
    first = llm.stream(reqs)
    assert llm.phase_stats["preemptions"] > 0
    second = llm.stream(reqs)
    assert [r.out for r in first] == [r.out for r in second]
    assert len(seen) == 2 * llm.phase_stats["decode_chunks"]
    assert all(s == seen[0] for s in seen)


def test_engine_construction_rules():
    """The legacy kwargs build ``plan_for_engine``'s plan with a
    DeprecationWarning; a plan plus kwargs, or neither, is a TypeError;
    a shared Telemetry is taken as given; an over-long request is a
    ValueError; the engine defaults to the card."""
    cfg = get_config(ARCHS[0])
    plan = pplan.plan_for_engine(cfg, slots=2, cache_len=32, sync_every=4)
    with pytest.raises(TypeError):
        DecodeEngine(cfg, {}, plan, slots=2, device="cpu")
    with pytest.raises(TypeError):
        DecodeEngine(cfg, {}, device="cpu")
    with pytest.warns(DeprecationWarning):
        eng = DecodeEngine(cfg, {}, slots=2, cache_len=32, sync_every=4,
                           device="cpu")
    assert eng.plan == plan and eng.slots == 2 and eng.sync_every == 4
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError):
        DecodeEngine(cfg, {}, slots=0, cache_len=32, device="cpu")
    tel = Telemetry()
    assert DecodeEngine(cfg, {}, plan, telemetry=tel,
                        device="cpu").telemetry is tel
    with pytest.raises(ValueError, match="cache_len"):
        DecodeEngine(cfg, {}, plan, device="cpu").run(
            [Request(0, [1] * 30, 3)])


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCHS[0])
    plan = pplan.plan_for_engine(cfg, slots=1, cache_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(cfg, {}, plan)


def test_launch_counters_take_replays():
    """``set_launches`` undoes a capture's counts, ``add_launches`` adds a
    replay's tally; a StepGraph refuses the CPU."""
    from repro_torch.serve.graphs import StepGraph
    before = pops.launch_counts()
    try:
        pops.add_launches({"bcsc_mlp": 3, "paged_attention": 2})
        after = pops.launch_counts()
        assert after["bcsc_mlp"] == before["bcsc_mlp"] + 3
        assert after["paged_attention"] == before["paged_attention"] + 2
        pops.set_launches(before)
        assert pops.launch_counts() == before
    finally:
        pops.set_launches(before)
    state = (None, torch.zeros(2, 8), None, None, None)
    with pytest.raises(ValueError, match="on the card"):
        StepGraph(lambda *a: None, {}, state, torch.zeros(2),
                  torch.zeros(2, dtype=torch.bool))


def test_request_outcome_matches_reference():
    from repro.serve.guard import OUTCOMES, RequestOutcome as RO
    from repro_torch.serve import guard
    assert guard.OUTCOMES == OUTCOMES
    assert [f.name for f in dataclasses.fields(RequestOutcome)] == \
        [f.name for f in dataclasses.fields(RO)]
    assert RequestOutcome("ok").ok and not RequestOutcome("shed").ok
    with pytest.raises(ValueError):
        RequestOutcome("fine")
    with pytest.raises(dataclasses.FrozenInstanceError):
        RequestOutcome("ok").status = "failed"


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels they "
                    "replay run only on the card")
    return torch.device("cuda")


def _card_params(arch, cuda, packed=True):
    cfg = get_config(arch)
    params = ptfm.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                              cuda)
    if packed:
        params = sparsify_mlp_params(params, cfg, sparsity=0.5)[0]
    return cfg, ptfm.compute_copy(params)


def _counted(fn):
    pops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, pops.launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_graphed_stream_equals_eager(cuda, arch):
    """``LLM.stream`` on the preemption mix (rows refilled, preempted and
    freed between chunks; pages of 4 = sync_every, so every chunk has a new
    block table): the graphed streams equal the eager ones, in the first
    run (which captures) and a second (which replays the same graph), and
    the second run's launch counts equal the eager run's."""
    cfg, params = _card_params(arch, cuda)
    plan = pplan.plan_for_scheduler(cfg, rows=3, cache_len=64, page_size=4,
                                    num_pages=6, attn_path="paged",
                                    share_prefix=False, sync_every=T)
    graphed = LLM(cfg, params, plan, eos_id=-1, guard=False)
    eager = LLM(cfg, graphed.params, plan, eos_id=-1, decode_graphs=False,
                guard=False)
    reqs = [(p, 12) for p in PROMPTS[:4]]
    first = graphed.stream(reqs)
    graph = graphed._scheduler.graph
    assert graph is not None and eager._scheduler.graph is None
    want, n_eager = _counted(lambda: eager.stream(reqs))
    assert eager.phase_stats["preemptions"] > 0
    again, n_graphed = _counted(lambda: graphed.stream(reqs))
    assert graphed._scheduler.graph is graph
    assert [r.out for r in first] == [r.out for r in want] \
        == [r.out for r in again]
    assert n_graphed == n_eager
    assert n_graphed["paged_attention"] == graph.tally["paged_attention"] \
        * graphed.phase_stats["decode_steps"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,paged,kv_quant,packed,fused_m_max", [
    ("qwen2.5-3b-reduced", True, "fp", True, "plan"),
    ("qwen2.5-3b-reduced", True, "int8", True, 0),
    ("gemma2-2b-reduced", True, "fp", True, "plan"),
    ("gemma2-2b-reduced", False, "fp", False, "plan"),
])
def test_cuda_graphed_chunk_state_equals_eager(cuda, arch, paged, kv_quant,
                                               packed, fused_m_max):
    """One graphed and one eager DecodeLoop on the same weights and rows:
    equal tokens and equal state bits (cache, last, pos, live, budget)
    after each of three chunks, with a new block table every chunk; the
    int8 pool with ``mlp_fused_m_max=0`` runs the GEMV route inside the
    graph."""
    cfg, params, plan, eager = _loop_case(
        arch, paged, kv_quant, 0.0, cuda, packed=packed,
        fused_m_max=fused_m_max)
    _, _, _, graphed = _loop_case(arch, paged, kv_quant, 0.0, cuda,
                                  fused_m_max=fused_m_max, graphs=True,
                                  params=params)
    s_e, _ = _fill(cfg, params, plan, eager)
    s_g, _ = _fill(cfg, params, plan, graphed)
    assert graphed.graph is not None and eager.graph is None
    if fused_m_max == 0:
        assert graphed.graph.tally.get("bcsc_gemv", 0) > 0
        assert "bcsc_mlp" not in graphed.graph.tally
    for c in range(3):
        for loop in (eager, graphed):
            if paged:
                loop.set_block_table(_tables(c, plan.max_pages))
        got, want = graphed.chunk(), eager.chunk()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(_flat(s_g), _flat(s_e)):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_cuda_graphed_temperature_sampling(cuda):
    """Temperature 20 (random weights give peaked logits): the generator
    registered with the graph gives fresh draws at every replay, the same
    stream from the same seed twice, and the draws the eager step makes
    from that seed."""
    arch = ARCHS[0]
    cfg, params, plan, graphed = _loop_case(arch, True, "fp", 20.0, cuda,
                                            packed=True, graphs=True)
    _, _, _, eager = _loop_case(arch, True, "fp", 20.0, cuda, params=params)
    runs = []
    for loop in (graphed, graphed, eager):
        _fill(cfg, params, plan, loop, seed=11)
        runs.append(loop.chunk()[0])
    assert len(set(runs[0][:, 2].tolist())) > 1
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0], runs[2])


@pytest.mark.gpu
def test_cuda_fused_mlp_barrier_holds_over_replays(cuda):
    """The fused MLP captured alone and replayed 1000 times: every replay
    leaves the same bits as the eager call, the barrier's arrival word and
    the combine counters at zero, and the generation 1000 higher; an eager
    call after the replays still matches."""
    arch = ARCHS[0]
    cfg, params = _card_params(arch, cuda)
    p = ptfm.layer(params["blocks"]["slot0"], 0)["mlp"]
    plan = pplan.plan_for_scheduler(cfg, rows=8, cache_len=64,
                                    share_prefix=False)
    x = torch.randn(8, cfg.d_model, generator=torch.Generator(cuda)
                    .manual_seed(1), device=cuda).bfloat16()

    def mlp():
        return pops.bcsc_mlp_packed(
            x, p["wg"], p["wu"], p["wd"], d_ff=cfg.d_ff, n_out=cfg.d_model,
            plan=plan, activation="silu", counts=p.get("_bcsc_counts"))
    want = mlp()
    stream = torch.cuda.Stream(cuda)
    with torch.cuda.stream(stream):
        mlp()
    torch.cuda.synchronize()
    words = _build._SYNC_WORDS[(cuda.index or 0, stream.cuda_stream)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = mlp()
    gen0 = int(words[1])
    for _ in range(1000):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert int(words[1]) == gen0 + 1000 and int(words[0]) == 0
    assert not words[2:2 + cfg.d_model // 16].any()
    with torch.cuda.stream(stream):
        after = mlp()
    torch.cuda.synchronize()
    assert torch.equal(after, want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_graphed_generate_equals_eager(cuda, arch):
    """``LLM.generate`` on a ``plan_for_engine`` plan: graphed streams
    equal the eager ones, one host transfer per chunk, and the graphed
    run's launch counts (after the capturing run) equal the eager run's."""
    cfg, params = _card_params(arch, cuda)
    plan = pplan.plan_for_engine(cfg, slots=SLOTS, cache_len=CACHE,
                                 sync_every=T)
    graphed = LLM(cfg, params, plan, eos_id=-1)
    eager = LLM(cfg, graphed.params, plan, eos_id=-1, decode_graphs=False)
    reqs = list(zip(PROMPTS, BUDGETS))
    first = graphed.generate(reqs)
    want, n_eager = _counted(lambda: eager.generate(reqs))
    again, n_graphed = _counted(lambda: graphed.generate(reqs))
    assert [r.out for r in first] == [r.out for r in want] \
        == [r.out for r in again]
    assert [len(r.out) for r in again] == BUDGETS
    assert n_graphed == n_eager
    assert graphed._engine.graph is not None
    assert graphed._engine.host_syncs == \
        2 * graphed.phase_stats["decode_chunks"]


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_int8_rung_recaptures_mid_run(cuda, arch, temperature):
    """``LLM.stream`` under the default guard on a pool the staggered
    requests fill past ``int8_pressure``: the int8 rung fires at a boundary
    with live rows, the graphed run drops its fp step graph and captures a
    new one over the int8 pools (two captures), paged attention keeps
    launching from that graph, and the streams equal the eager run's token
    for token. A second graphed run starts on the int8 pool and replays the
    same graph. With temperature sampling the capture leaves the sampler's
    state as it was, so the draws match the eager run's too."""
    cfg, params = _card_params(arch, cuda)
    plan = pplan.plan_for_scheduler(cfg, rows=3, cache_len=96, page_size=8,
                                    num_pages=16, attn_path="paged",
                                    share_prefix=False, sync_every=T)
    prompts = [[int(t) for t in np.random.default_rng(i).integers(2, 500, n)]
               for i, n in enumerate((5, 60, 33, 17))]

    def reqs():
        return [StreamRequest(i, p, min(40, 96 - len(p)), arrival=4.0 * i)
                for i, p in enumerate(prompts)]
    graphed = LLM(cfg, params, plan, eos_id=-1, temperature=temperature)
    eager = LLM(cfg, graphed.params, plan, eos_id=-1, decode_graphs=False,
                temperature=temperature)
    n_global = pplan.num_global_layers(cfg)
    runs = {}
    for name, llm in (("graphed", graphed), ("eager", eager)):
        counts = []
        pops.reset_launches()
        done = llm.stream(reqs(), seed=5,
                          on_token=lambda r, t, llm=llm: counts.append(
                              ("degraded_to_int8_at" in llm.phase_stats,
                               pops.launch_counts()["paged_attention"],
                               llm.phase_stats["decode_steps"])))
        torch.cuda.synchronize()
        st = llm.phase_stats
        assert st["kv_quant"] == "int8" and st["degraded_to_int8_at"] > 0
        assert all(r.outcome.ok for r in done)
        # paged attention once per global layer per decode step on each
        # side of the rung; each capture adds its eager warm-up steps
        warm = WARMUP_STEPS * n_global if name == "graphed" else 0
        _, before, steps = [c for c in counts if not c[0]][-1]
        after = pops.launch_counts()["paged_attention"] - before
        assert before == n_global * steps + warm
        assert st["decode_steps"] > steps
        assert after == n_global * (st["decode_steps"] - steps) + warm
        runs[name] = [r.out for r in done]
    loop = graphed._scheduler._loop
    assert len(loop.captures) == 2
    assert loop.graph.tally["paged_attention"] == n_global
    for name, kind in ptfm.slot_names(cfg):
        if kind == "global":
            assert loop.state[0]["blocks"][name]["pk"].dtype == torch.int8
    assert runs["graphed"] == runs["eager"]
    graph = loop.graph
    again = graphed.stream(reqs())
    assert loop.graph is graph and len(loop.captures) == 2
    assert all(r.outcome.ok for r in again)


@pytest.mark.gpu
@pytest.mark.parametrize("guard", [None, False])
def test_cuda_one_device_to_host_copy_per_chunk(cuda, guard):
    """Under the default guard (and without one) the card runs exactly one
    device-to-host copy per decode chunk, counted in a profiler trace of
    the run rather than by the scheduler's own ``host_syncs``: a host read
    of a device tensor anywhere in the run (an ``.item()``, a ``.cpu()``,
    a ``bool(tensor)``) is one more copy."""
    from torch.profiler import ProfilerActivity, profile
    cfg, params = _card_params("qwen2.5-3b-reduced", cuda)
    plan = pplan.plan_for_scheduler(cfg, rows=3, cache_len=96, page_size=8,
                                    num_pages=16, attn_path="paged",
                                    share_prefix=False, sync_every=T)
    prompts = [[int(t) for t in np.random.default_rng(i).integers(2, 500, n)]
               for i, n in enumerate((5, 60, 33, 17))]
    llm = LLM(cfg, params, plan, eos_id=-1, guard=guard)

    def reqs():
        return [StreamRequest(i, p, min(40, 96 - len(p)), arrival=4.0 * i)
                for i, p in enumerate(prompts)]
    llm.stream(reqs())           # captures the step graph (and its rung's)
    syncs = llm._scheduler.host_syncs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        done = llm.stream(reqs())
        torch.cuda.synchronize()
    assert all(r.outcome is None or r.outcome.ok for r in done)
    dtoh = sum(1 for e in prof.profiler.kineto_results.events()
               if e.name().startswith("Memcpy DtoH"))
    chunks = llm.phase_stats["decode_chunks"]
    assert chunks > 0
    assert dtoh == chunks == llm._scheduler.host_syncs - syncs
