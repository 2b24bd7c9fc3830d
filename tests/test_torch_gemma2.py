"""The port against the reference on ``gemma2-2b-reduced``: local
(sliding-window, window 32) and global layers alternating, attention and
final logit softcaps, sandwich post-norms, GeGLU MLPs.

Reference parameters come from ``transformer.init_params(PRNGKey(0), cfg)``
(MLPs packed at 0.5 where stated) and are bridged to the port as numpy.
Prompts are longer than the window (tier 64 > 32), so prefill runs the
window mode of the sliding-window attention in the local layers, and decode
runs past position 64, so every local ring wraps. Logits are held to 1e-2
of max |logit| (fp32 sums in another order flip bf16 roundings, which the
layers carry forward) and greedy tokens must agree; greedy ``LLM.stream``
streams must equal the reference scheduler's, request by request.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.core import plan as rplan
from repro.models import decoding as rdec
from repro.models import transformer as rtfm
from repro.serve import sparse as rsparse
from repro.serve.scheduler import ContinuousBatchingScheduler
from repro.serve.scheduler import StreamRequest as RRequest

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import plan as pplan
from repro_torch.kernels import ops as pops
from repro_torch.models import decoding as pdec
from repro_torch.models import transformer as ptfm
from repro_torch.serve import LLM, StreamRequest
from repro_torch.serve import sparse as psparse

ARCH = "gemma2-2b-reduced"
CACHE, PS = 96, 8
LENGTHS = [40, 61, 9]
TIER = 64
STEPS = 30           # positions 40..69, 61..90 and 9..38: every ring wraps


@pytest.fixture(scope="module")
def setup():
    rcfg, cfg = rget_config(ARCH), get_config(ARCH)
    dense = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    packed, _ = rsparse.sparsify_mlp_params(dense, rcfg, 0.5)
    plan = rplan.plan_for_scheduler(rcfg, rows=len(LENGTHS), cache_len=CACHE,
                                    page_size=PS, share_prefix=False)
    rng = np.random.default_rng(0)
    toks = np.zeros((len(LENGTHS), TIER), np.int32)
    for i, n in enumerate(LENGTHS):
        toks[i, :n] = rng.integers(2, rcfg.vocab_size, n)
    return rcfg, cfg, {None: dense, 0.5: packed}, plan, toks


def _port_params(rparams):
    return ptfm.compute_copy(bridge.params_from_numpy(
        jax.tree.map(np.asarray, rparams)))


def _block_table(n_rows, max_pages):
    return np.asarray([[i + n_rows * j for j in range(max_pages)]
                       for i in range(n_rows)], np.int32)


def _close(got, want, frac=1e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


def _vocab(x, cfg):
    return np.asarray(x, np.float32)[..., :cfg.vocab_size]


def _ref_run(rcfg, rparams, toks, plan, paged):
    """Reference prefill, then STEPS decode steps fed its own greedy tokens.
    Returns (prefill logits, [step logits], [fed tokens])."""
    B, MP = toks.shape[0], plan.max_pages
    bt = jnp.asarray(_block_table(B, MP)) if paged else None
    if paged:
        cache = rdec.init_paged_cache(rcfg, B, CACHE, B * MP, PS, "fp")
        pp = rdec.PagedPrefill(cache=cache, block_table_rows=bt,
                               slots=jnp.arange(B))
        logits, cache = rdec.prefill_batched(
            rparams, jnp.asarray(toks), jnp.asarray(LENGTHS), rcfg, CACHE,
            paged=pp)
    else:
        logits, cache = rdec.prefill_batched(
            rparams, jnp.asarray(toks), jnp.asarray(LENGTHS), rcfg, CACHE)
    step = jax.jit(functools.partial(rdec.serve_step, cfg=rcfg))
    pos = np.asarray(LENGTHS, np.int32)
    nxt = np.argmax(_vocab(logits, rcfg)[:, -1], -1)[:, None]
    steps, fed = [], []
    for _ in range(STEPS):
        fed.append(nxt)
        out, cache = step(rparams, cache, jnp.asarray(nxt, jnp.int32),
                          jnp.asarray(pos), block_table=bt)
        steps.append(np.asarray(out))
        nxt = np.argmax(_vocab(out, rcfg)[:, -1], -1)[:, None]
        pos = pos + 1
    return np.asarray(logits), steps, fed


def _port_run(cfg, params, toks, plan, fed, paged):
    B, MP = toks.shape[0], plan.max_pages
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    bt = torch.from_numpy(_block_table(B, MP)) if paged else None
    if paged:
        cache = pdec.init_paged_cache(cfg, B, CACHE, B * MP, PS, "fp")
        pp = pdec.PagedPrefill(cache=cache, block_table_rows=bt,
                               slots=torch.arange(B))
        logits, cache = pdec.prefill_batched(params, torch.from_numpy(toks),
                                             lengths, cfg, CACHE, plan=plan,
                                             paged=pp)
    else:
        logits, cache = pdec.prefill_batched(params, torch.from_numpy(toks),
                                             lengths, cfg, CACHE, plan=plan)
    pos = lengths.long()
    steps = []
    for nxt in fed:
        out, cache = pdec.serve_step(params, cache,
                                     torch.from_numpy(nxt).long(), pos, cfg,
                                     plan=plan, block_table=bt)
        steps.append(out)
        pos = pos + 1
    return logits, steps, cache


@pytest.mark.parametrize("paged,sparsity", [(True, None), (True, 0.5),
                                            (False, None)])
def test_prefill_and_decode_match_reference(setup, paged, sparsity):
    """Prefill at tier 64 (window mode in the local layers), then 30
    decode steps across the ring wrap, paged and contiguous."""
    rcfg, cfg, weights, plan, toks = setup
    rparams = weights[sparsity]
    r_logits, r_steps, fed = _ref_run(rcfg, rparams, toks, plan, paged)
    p_logits, p_steps, _ = _port_run(cfg, _port_params(rparams), toks,
                                     pplan.ServePlan.from_dict(plan.as_dict()),
                                     fed, paged)
    assert p_logits.shape == r_logits.shape
    _close(_vocab(p_logits, cfg), _vocab(r_logits, rcfg))
    for got, want in zip(p_steps, r_steps):
        _close(_vocab(got, cfg), _vocab(want, rcfg))
        assert (_vocab(got, cfg).argmax(-1)
                == _vocab(want, rcfg).argmax(-1)).all()


def test_prefill_ring_matches_reference(setup):
    """The local layers' rings after a contiguous prefill hold each row's
    own last 32 positions (pad tokens never enter), as the reference's
    ``_gather_ring_ragged`` leaves them."""
    rcfg, cfg, weights, plan, toks = setup
    _, r_cache = rdec.prefill_batched(weights[None], jnp.asarray(toks),
                                      jnp.asarray(LENGTHS), rcfg, CACHE)
    _, p_cache = pdec.prefill_batched(
        _port_params(weights[None]), torch.from_numpy(toks),
        torch.tensor(LENGTHS, dtype=torch.int32), cfg, CACHE,
        plan=pplan.ServePlan.from_dict(plan.as_dict()))
    ring = p_cache["blocks"]["slot0"]
    assert tuple(ring["k"].shape) == (2, 3, rcfg.window_size,
                                      rcfg.num_kv_heads, rcfg.head_dim)
    for key in ("k", "v"):
        _close(ring[key].float(),
               np.asarray(r_cache["blocks"]["slot0"][key], np.float32))
        assert tuple(p_cache["blocks"]["slot1"][key].shape[2:3]) == (CACHE,)


def test_paged_equals_contiguous_and_packed_zero_equals_dense(setup):
    """Inside the port: the paged and contiguous layouts give equal prefill
    logits and decode logits within fp32 summation order (1e-5 of
    max |logit|); MLPs packed at sparsity 0 compute exactly the dense MLPs."""
    rcfg, cfg, weights, plan, toks = setup
    params = _port_params(weights[None])
    plan = pplan.ServePlan.from_dict(plan.as_dict())
    _, _, fed = _ref_run(rcfg, weights[None], toks, rplan.plan_for_scheduler(
        rcfg, rows=3, cache_len=CACHE, page_size=PS, share_prefix=False),
        True)
    fed = fed[:8]
    p_logits, p_steps, _ = _port_run(cfg, params, toks, plan, fed, True)
    c_logits, c_steps, _ = _port_run(cfg, params, toks, plan, fed, False)
    assert torch.equal(p_logits, c_logits)
    for p, c in zip(p_steps, c_steps):
        _close(p[..., :cfg.vocab_size], c[..., :cfg.vocab_size], 1e-5)
    packed, _ = psparse.sparsify_mlp_params(params, cfg, 0.0)
    s_logits, s_steps, _ = _port_run(cfg, packed, toks, plan, fed, True)
    assert torch.equal(s_logits, p_logits)
    assert all(torch.equal(a, b) for a, b in zip(s_steps, p_steps))


# ------------------------------------------------------------------ serving
# prompts of 5-60 tokens; prompt + max_new fills up to the 96-token cache,
# so rows decode far past the 32-token window
PROMPTS = [list(np.random.default_rng(i).integers(2, 503, n))
           for i, n in enumerate((5, 60, 33, 17))]

# name -> (plan geometry, max_new, arrivals); a request's budget is cut to
# what its prompt leaves of the cache
MIXES = {
    "staggered": (dict(rows=2, cache_len=CACHE, page_size=PS, sync_every=4),
                  40, [0.0, 0.0, 6.0, 13.0]),
    "preemption": (dict(rows=3, cache_len=CACHE, page_size=PS, num_pages=16,
                        sync_every=4), 40, None),
}


@pytest.mark.parametrize("mix,kv_quant", [("staggered", "fp"),
                                          ("preemption", "fp"),
                                          ("preemption", "int8")])
def test_stream_matches_reference(setup, mix, kv_quant):
    """Greedy streams of ``LLM.stream`` (CPU, MLPs packed at 0.5) equal the
    reference scheduler's, request by request, with the same admission,
    first-token and finish steps."""
    rcfg, cfg, weights, _, _ = setup
    geometry, max_new, arrivals = MIXES[mix]
    plan = rplan.plan_for_scheduler(rcfg, share_prefix=False,
                                    kv_quant=kv_quant, **geometry)
    arr = arrivals or [0.0] * len(PROMPTS)
    prompts = [[int(t) for t in p] for p in PROMPTS]
    sch = ContinuousBatchingScheduler(rcfg, weights[0.5], plan, eos_id=-1,
                                      guard=None)
    ref = sorted(sch.run([RRequest(i, p, min(max_new, CACHE - len(p)),
                                   arrival=a)
                          for i, (p, a) in enumerate(zip(prompts, arr))]),
                 key=lambda r: r.rid)
    llm = LLM(cfg, bridge.params_from_numpy(jax.tree.map(np.asarray,
                                                         weights[0.5])),
              pplan.ServePlan.from_dict(plan.as_dict()), eos_id=-1,
              device="cpu", guard=False)
    pops.reset_launches()
    got = llm.stream([StreamRequest(i, p, min(max_new, CACHE - len(p)),
                                    arrival=a)
                      for i, (p, a) in enumerate(zip(prompts, arr))])
    assert [r.out for r in got] == [r.out for r in ref]
    assert all(len(r.out) > 0 for r in got)
    for r, p in zip(ref, got):
        assert (p.admitted_at, p.first_token_at, p.finished_at) == \
            (r.admitted_at, r.first_token_at, r.finished_at)
    pst, rst = llm.phase_stats, sch.phase_stats
    for key in ("decode_chunks", "decode_steps", "prefill_batches",
                "preemptions"):
        assert pst[key] == rst[key], key
    if mix == "preemption":
        assert pst["preemptions"] > 0
    assert pst["kv_quant"] == kv_quant
    assert sum(pops.launch_counts().values()) == 0     # CPU: plain versions
