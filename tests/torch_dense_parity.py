"""Shared machinery of the port-vs-reference tests of the dense
attention-only configs (``tests/test_torch_mistral_nemo.py``,
``tests/test_torch_gemma3.py``). Not a test module itself.

Weights are the reference's ``init_params(PRNGKey(0), cfg)`` (MLPs packed
at 0.5 where asked), optionally with every norm scale redrawn from a seeded
numpy generator, bridged to the port as numpy. Logits are held to
``LOGIT_TOL`` of max |logit|: fp32 sums in another order flip bf16
roundings, which the layers carry forward.

Greedy agreement is asserted token for token, with one exemption: where
the two argmaxes differ, the reference's own top-2 margin at that step must
be below ``LOGIT_TOL`` of max |logit|, i.e. a near-tie of an untrained model
that a gap inside the tolerance may resolve either way. A stream that parts
at such a tie is compared up to that step only; one that parts anywhere
else fails.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as rget_config
from repro.core import plan as rplan
from repro.models import decoding as rdec
from repro.models import transformer as rtfm
from repro.serve import sparse as rsparse
from repro.serve.engine import DecodeEngine as RDecodeEngine
from repro.serve.engine import Request as RRequest
from repro.serve.scheduler import ContinuousBatchingScheduler
from repro.serve.scheduler import StreamRequest as RStreamRequest

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import plan as pplan
from repro_torch.kernels import ops as pops
from repro_torch.models import decoding as pdec
from repro_torch.models import transformer as ptfm
from repro_torch.serve import LLM, StreamRequest

LOGIT_TOL = 1e-2
NORM_KEYS = ("pre_norm", "pre_norm_mlp", "post_norm", "post_norm_mlp",
             "q_norm", "k_norm", "final_norm")


@dataclasses.dataclass
class Case:
    """One configuration and its weights on both sides."""
    rcfg: object
    cfg: object
    weights: dict          # None: dense, 0.5: MLPs packed at 0.5


def perturb_norms(tree, seed: int, std: float = 0.5):
    """Every norm scale of a reference params tree redrawn N(0, std) from a
    seeded numpy generator (``init_params`` leaves them at 0, so that
    ``(1 + scale)`` multiplies by exactly 1 and hides the scales' wiring)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in NORM_KEYS:
                out[k] = jnp.asarray(rng.normal(0.0, std, v.shape),
                                     v.dtype)
            else:
                out[k] = v
        return out
    return walk(tree)


def make_case(arch: str, *, head_dim: int = 0, norm_seed=None) -> Case:
    """``arch``'s reduced config on both sides (``head_dim`` replaced on
    both when given) and the reference's weights, dense and packed."""
    rcfg, cfg = rget_config(arch), get_config(arch)
    if head_dim:
        rcfg = dataclasses.replace(rcfg, head_dim=head_dim)
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    dense = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    if norm_seed is not None:
        dense = perturb_norms(dense, norm_seed)
    packed, _ = rsparse.sparsify_mlp_params(dense, rcfg, 0.5)
    return Case(rcfg, cfg, {None: dense, 0.5: packed})


def port_params(rparams):
    return ptfm.compute_copy(bridge.params_from_numpy(
        jax.tree.map(np.asarray, rparams)))


def port_plan(rplan_):
    return pplan.ServePlan.from_dict(rplan_.as_dict())


def block_table(n_rows: int, max_pages: int) -> np.ndarray:
    return np.asarray([[i + n_rows * j for j in range(max_pages)]
                       for i in range(n_rows)], np.int32)


def vocab(x, cfg) -> np.ndarray:
    return np.asarray(x, np.float32)[..., :cfg.vocab_size]


def rel_error(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def assert_close(got, want, frac: float = LOGIT_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


def top2_margin(logits) -> float:
    """The gap between the two largest logits over max |logit|."""
    row = np.sort(np.asarray(logits, np.float32).reshape(-1))
    return float((row[-1] - row[-2]) / np.abs(row).max())


def assert_greedy(got, want):
    """Equal argmax over the last axis, or a reference near-tie there."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for idx in np.argwhere(got.argmax(-1) != want.argmax(-1)):
        margin = top2_margin(want[tuple(idx)])
        assert margin < LOGIT_TOL, (
            f"argmax parts at {tuple(idx)} with a reference top-2 margin of "
            f"{margin:.3e} of max |logit|: not a tie")


# ------------------------------------------------- prefill + decode logits
def ref_run(rcfg, rparams, toks, lengths, cache_len, ps, steps, paged):
    """Reference prefill, then ``steps`` decode steps fed its own greedy
    tokens. Returns (prefill logits, [step logits], [fed tokens])."""
    B = toks.shape[0]
    MP = -(-cache_len // ps)
    bt = jnp.asarray(block_table(B, MP)) if paged else None
    if paged:
        cache = rdec.init_paged_cache(rcfg, B, cache_len, B * MP, ps, "fp")
        pp = rdec.PagedPrefill(cache=cache, block_table_rows=bt,
                               slots=jnp.arange(B))
        logits, cache = rdec.prefill_batched(
            rparams, jnp.asarray(toks), jnp.asarray(lengths), rcfg,
            cache_len, paged=pp)
    else:
        logits, cache = rdec.prefill_batched(
            rparams, jnp.asarray(toks), jnp.asarray(lengths), rcfg,
            cache_len)
    step = jax.jit(functools.partial(rdec.serve_step, cfg=rcfg))
    pos = np.asarray(lengths, np.int32)
    nxt = np.argmax(vocab(logits, rcfg)[:, -1], -1)[:, None]
    outs, fed = [], []
    for _ in range(steps):
        fed.append(nxt)
        out, cache = step(rparams, cache, jnp.asarray(nxt, jnp.int32),
                          jnp.asarray(pos), block_table=bt)
        outs.append(np.asarray(out))
        nxt = np.argmax(vocab(out, rcfg)[:, -1], -1)[:, None]
        pos = pos + 1
    return np.asarray(logits), outs, fed


def port_run(cfg, params, toks, lengths, cache_len, ps, plan, fed, paged):
    """The port's prefill and decode steps on the reference's tokens."""
    B = toks.shape[0]
    MP = -(-cache_len // ps)
    lens = torch.tensor(lengths, dtype=torch.int32)
    bt = torch.from_numpy(block_table(B, MP)) if paged else None
    if paged:
        cache = pdec.init_paged_cache(cfg, B, cache_len, B * MP, ps, "fp")
        pp = pdec.PagedPrefill(cache=cache, block_table_rows=bt,
                               slots=torch.arange(B))
        logits, cache = pdec.prefill_batched(params, torch.from_numpy(toks),
                                             lens, cfg, cache_len, plan=plan,
                                             paged=pp)
    else:
        logits, cache = pdec.prefill_batched(params, torch.from_numpy(toks),
                                             lens, cfg, cache_len, plan=plan)
    pos = lens.long()
    outs = []
    for nxt in fed:
        out, cache = pdec.serve_step(params, cache,
                                     torch.from_numpy(nxt).long(), pos, cfg,
                                     plan=plan, block_table=bt)
        outs.append(out)
        pos = pos + 1
    return logits, outs


def prompts_batch(vocab_size: int, lengths, tier: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    toks = np.zeros((len(lengths), tier), np.int32)
    for i, n in enumerate(lengths):
        toks[i, :n] = rng.integers(2, vocab_size, n)
    return toks


def logits_errors(case: Case, sparsity, paged, lengths, tier, cache_len, ps,
                  steps, port_cfg=None):
    """Prefill and ``steps`` teacher-forced decode steps through both
    packages. Returns (prefill error, [step errors]), each relative to the
    reference's max |logit|; greedy tokens are held by ``assert_greedy``
    unless ``port_cfg`` replaces the port's config (a control whose logits
    must not agree)."""
    rcfg, rparams = case.rcfg, case.weights[sparsity]
    cfg = port_cfg or case.cfg
    toks = prompts_batch(rcfg.vocab_size, lengths, tier)
    rp = rplan.plan_for_scheduler(rcfg, rows=len(lengths),
                                  cache_len=cache_len, page_size=ps,
                                  share_prefix=False)
    r_logits, r_steps, fed = ref_run(rcfg, rparams, toks, lengths, cache_len,
                                     ps, steps, paged)
    p_logits, p_steps = port_run(cfg, port_params(rparams), toks, lengths,
                                 cache_len, ps, port_plan(rp), fed, paged)
    assert p_logits.shape == r_logits.shape
    pairs = [(vocab(p_logits, cfg), vocab(r_logits, rcfg))] + [
        (vocab(g, cfg), vocab(w, rcfg)) for g, w in zip(p_steps, r_steps)]
    if port_cfg is None:
        for g, w in pairs:
            assert_greedy(g, w)
    errs = [rel_error(g, w) for g, w in pairs]
    return errs[0], errs[1:]


def paged_contiguous_packed_invariants(case: Case, lengths, tier, cache_len,
                                       ps, steps):
    """Inside the port: paged and contiguous layouts give equal prefill
    logits and decode logits within fp32 summation order (1e-5 of
    max |logit|); MLPs packed at sparsity 0 compute exactly the dense
    MLPs."""
    rcfg, cfg = case.rcfg, case.cfg
    params = port_params(case.weights[None])
    toks = prompts_batch(rcfg.vocab_size, lengths, tier)
    plan = port_plan(rplan.plan_for_scheduler(
        rcfg, rows=len(lengths), cache_len=cache_len, page_size=ps,
        share_prefix=False))
    _, _, fed = ref_run(rcfg, case.weights[None], toks, lengths, cache_len,
                        ps, steps, True)
    args = (toks, lengths, cache_len, ps, plan, fed)
    p_logits, p_steps = port_run(cfg, params, *args, True)
    c_logits, c_steps = port_run(cfg, params, *args, False)
    assert torch.equal(p_logits, c_logits)
    for p, c in zip(p_steps, c_steps):
        assert_close(p[..., :cfg.vocab_size], c[..., :cfg.vocab_size], 1e-5)
    from repro_torch.serve import sparse as psparse
    packed, _ = psparse.sparsify_mlp_params(params, cfg, 0.0)
    s_logits, s_steps = port_run(cfg, packed, *args, True)
    assert torch.equal(s_logits, p_logits)
    assert all(torch.equal(a, b) for a, b in zip(s_steps, p_steps))


# ------------------------------------------------------------------ streams
def _next_logits(rcfg, rparams, tokens):
    """The reference's logits for the token after ``tokens`` (one
    contiguous prefill of them)."""
    toks = jnp.asarray([tokens], jnp.int32)
    logits, _ = rdec.prefill_batched(rparams, toks,
                                     jnp.asarray([len(tokens)]), rcfg,
                                     len(tokens))
    return vocab(logits, rcfg)[0, -1]


def compare_streams(rcfg, rparams, prompts, got, want):
    """Request by request, ``got``'s tokens equal ``want``'s (the
    reference's) up to the first step where they part; there the
    reference's top-2 margin for the next token after the common prefix
    must be a tie (below LOGIT_TOL), and the request is compared no
    further."""
    assert [len(g) for g in got] == [len(w) for w in want]
    for prompt, g, w in zip(prompts, got, want):
        t = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if t is None:
            continue
        margin = top2_margin(_next_logits(rcfg, rparams,
                                          list(prompt) + list(w[:t])))
        assert margin < LOGIT_TOL, (
            f"stream parts at token {t} ({g[t]} vs {w[t]}) with a reference "
            f"top-2 margin of {margin:.3e} of max |logit|: not a tie")


def stream_vs_reference(case: Case, prompts, max_new, geometry, arrivals,
                        kv_quant):
    """Greedy ``LLM.stream`` (CPU, MLPs packed at 0.5) against the
    reference scheduler on one request mix; admission, first-token and
    finish steps and the phase counters must be equal (they depend on
    lengths and budgets only). Returns the port's phase stats."""
    rcfg, cfg, rparams = case.rcfg, case.cfg, case.weights[0.5]
    cache_len = geometry["cache_len"]
    plan = rplan.plan_for_scheduler(rcfg, share_prefix=False,
                                    kv_quant=kv_quant, **geometry)
    arr = arrivals or [0.0] * len(prompts)
    budgets = [min(max_new, cache_len - len(p)) for p in prompts]
    sch = ContinuousBatchingScheduler(rcfg, rparams, plan, eos_id=-1,
                                      guard=None)
    ref = sorted(sch.run([RStreamRequest(i, p, n, arrival=a)
                          for i, (p, n, a) in enumerate(zip(prompts, budgets,
                                                            arr))]),
                 key=lambda r: r.rid)
    llm = LLM(cfg, bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                         rparams)),
              port_plan(plan), eos_id=-1, device="cpu", guard=False)
    pops.reset_launches()
    got = llm.stream([StreamRequest(i, p, n, arrival=a)
                      for i, (p, n, a) in enumerate(zip(prompts, budgets,
                                                        arr))])
    compare_streams(rcfg, rparams, prompts, [r.out for r in got],
                    [r.out for r in ref])
    for r, p in zip(ref, got):
        assert (p.admitted_at, p.first_token_at, p.finished_at) == \
            (r.admitted_at, r.first_token_at, r.finished_at)
    pst, rst = llm.phase_stats, sch.phase_stats
    for key in ("decode_chunks", "decode_steps", "prefill_batches",
                "preemptions"):
        assert pst[key] == rst[key], key
    assert pst["kv_quant"] == kv_quant
    assert sum(pops.launch_counts().values()) == 0     # CPU: plain versions
    return pst


def generate_vs_reference(case: Case, prompts, budgets, slots, cache_len,
                          sync_every):
    """Greedy ``LLM.generate`` (the drain engine, MLPs packed at 0.5)
    against the reference ``DecodeEngine``: streams, phase counters and one
    host transfer per decode chunk."""
    rcfg, cfg, rparams = case.rcfg, case.cfg, case.weights[0.5]
    plan = rplan.plan_for_engine(rcfg, slots=slots, cache_len=cache_len,
                                 sync_every=sync_every)
    eng = RDecodeEngine(rcfg, rparams, plan, eos_id=-1)
    want = sorted(eng.run([RRequest(i, p, n) for i, (p, n)
                           in enumerate(zip(prompts, budgets))]),
                  key=lambda r: r.rid)
    llm = LLM(cfg, bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                         rparams)),
              port_plan(plan), eos_id=-1, device="cpu")
    got = llm.generate(list(zip(prompts, budgets)))
    compare_streams(rcfg, rparams, prompts, [r.out for r in got],
                    [r.out for r in want])
    st, rst = llm.phase_stats, eng.phase_stats
    for key in ("decode_chunks", "prefill_batches", "prefill_real_tokens",
                "prefill_padded_tokens"):
        assert st[key] == rst[key], key
    assert llm._engine.host_syncs == st["decode_chunks"] == eng.host_syncs


def plan_fields_equal(mine, want):
    """Every dispatch field of a port plan dict equals the reference's
    (the decision records are held by ``tests/test_torch_telemetry.py``)."""
    assert set(mine) == set(want)
    for key, value in mine.items():
        if key == "decisions":
            continue
        w = want[key]
        assert (tuple(value) if isinstance(value, (list, tuple)) else value) \
            == (tuple(w) if isinstance(w, (list, tuple)) else w), key


def full_plans(arch: str, rows: int, cache_len: int):
    """(reference dict, port dict) pairs of the full-size config's plans:
    the scheduler's on paged fp and int8 KV, and the drain engine's."""
    rcfg, cfg = rget_config(arch), get_config(arch)
    out = []
    for kv in ("fp", "int8"):
        kw = dict(rows=rows, cache_len=cache_len, page_size=64,
                  attn_path="paged", share_prefix=False, kv_quant=kv,
                  sync_every=8)
        out.append((rplan.plan_for_scheduler(rcfg, **kw).as_dict(),
                    pplan.plan_for_scheduler(cfg, **kw).as_dict()))
    out.append((rplan.plan_for_engine(rcfg, slots=8,
                                      cache_len=cache_len).as_dict(),
                pplan.plan_for_engine(cfg, slots=8,
                                      cache_len=cache_len).as_dict()))
    return out
