"""The port's frontend architectures against the reference on the CPU:
``musicgen-large-reduced`` (two global layers of 4 / 2 heads of 16, each
followed by cross-attention to 8 conditioning embeddings and an ungated
tanh-gelu MLP; four codebooks, sinusoidal positions) and
``internvl2-26b-reduced`` (two global layers with RoPE behind 8 vision
patch embeddings prepended to the text).

Weights are the reference's ``init_params(PRNGKey(0), cfg)`` with every
norm scale redrawn from a seeded numpy generator (at 0 a scale multiplies
by exactly 1 and hides its wiring), bridged to the port as numpy; tokens,
patches and conditioning are numpy-seeded, the embeddings rounded to bf16
once and handed to both sides. The reference runs compiled with XLA's
excess precision off (``xla_allow_excess_precision`` False, as
``tests/test_torch_moe.py`` runs it), which computes what it computes op by
op. Tolerances:

* the sinusoidal table within 1e-6 (XLA's and torch's fp32 ``sin`` /
  ``cos`` differ in the last bits);
* cross-attention within ``LAYER_TOL`` (1e-3) of max |out|: the same
  operations, at most a rare bf16 rounding of an fp32 sum taken in another
  order;
* the four-codebook embedding bit-equal (the K rows summed in fp32, then
  one rounding);
* whole-model logits within ``torch_dense_parity.LOGIT_TOL`` (1e-2) of max
  |logit|; greedy streams equal or parted at a reference near-tie (top-2
  margin under 1e-2 of max |logit|);
* the port's own invariants: paged == contiguous decode at K 4 bit-equal,
  prefill of S tokens against S - 1 and one step within 1e-2 of max
  |logit|.

The reference's serving loops cannot serve these models (its
``prefill_batched`` asserts there are no patches, its refill passes no
``cond``): the port's refuse them with a ``ValueError``
(``tests/test_torch_plan.py``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget_config
from repro.models import decoding as rdec
from repro.models import layers as rlayers
from repro.models import transformer as rtfm
from repro.serve import engine as reng

from repro_torch.configs import get_config
from repro_torch.core import plan as pplan
from repro_torch.models import decoding as pdec
from repro_torch.models import frontend as pfront
from repro_torch.models import layers as players
from repro_torch.models import transformer as ptfm
from repro_torch.serve import engine as peng
import torch_dense_parity as tdp

MUSICGEN = "musicgen-large-reduced"
INTERNVL = "internvl2-26b-reduced"
ARCHS = (MUSICGEN, INTERNVL)
LAYER_TOL = 1e-3
B, S, STEPS = 2, 11, 4
CACHE = 40
STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The reduced models' ops are tiny; under the suite's parallel workers
    torch's intra-op threads would only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _strict(fn):
    """``fn`` jitted with XLA's excess precision off."""
    return jax.jit(fn, compiler_options=STRICT)


def _perturb(tree, seed: int):
    """Every norm scale (``*norm*`` keys, ``pre_norm_cross`` among them)
    redrawn N(0, 0.5) from a seeded numpy generator."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                jnp.asarray(rng.normal(0.0, 0.5, v.shape), v.dtype)
                if "norm" in k else v for k, v in t.items()}
    return walk(tree)


def _bf16(rng, shape, scale=1.0):
    """Seeded normal values rounded to bf16 once (numpy fp32 holding them
    exactly)."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                         * scale)
    return x.bfloat16().float().numpy()


@dataclasses.dataclass
class Case:
    rcfg: object
    cfg: object
    rparams: dict
    params: dict        # the port's, bf16 compute copies
    toks: np.ndarray    # (B, S) or (B, K, S) int32
    extra: dict         # the reference's keywords: patch_embeds or cond

    def port_extra(self):
        return {k: torch.from_numpy(v).bfloat16()
                for k, v in self.extra.items()}

    def ref_extra(self):
        return {k: jnp.asarray(v, jnp.bfloat16)
                for k, v in self.extra.items()}


@pytest.fixture(scope="module")
def cases():
    out = {}
    for seed, arch in enumerate(ARCHS):
        rcfg, cfg = rget_config(arch), get_config(arch)
        rparams = _perturb(rtfm.init_params(jax.random.PRNGKey(0), rcfg),
                           seed)
        rng = np.random.default_rng(10 + seed)
        K = rcfg.num_codebooks
        shape = (B, K, S) if K > 1 else (B, S)
        toks = rng.integers(2, rcfg.vocab_size, shape).astype(np.int32)
        extra = {}
        if rcfg.cross_attn_cond:
            extra["cond"] = _bf16(rng, (B, rcfg.cross_attn_cond,
                                        rcfg.d_model), 0.5)
        if rcfg.frontend == "vision":
            extra["patch_embeds"] = _bf16(rng, (B, rcfg.num_patches,
                                                rcfg.d_model), 0.5)
        out[arch] = Case(rcfg, cfg, rparams, tdp.port_params(rparams), toks,
                         extra)
    return out


def _offset(case) -> int:
    return case.rcfg.num_patches if case.rcfg.frontend == "vision" else 0


def _greedy(logits, cfg):
    """The next tokens of (B, 1, Vp) or (B, 1, K, Vp) logits: (B, 1) or
    (B, K, 1)."""
    return np.argmax(tdp.vocab(logits, cfg)[:, -1], -1)[..., None] \
        .astype(np.int32)


@pytest.fixture(scope="module")
def reference_runs(cases):
    """Per arch: the reference's ``prefill`` (patches or conditioning
    given) and ``STEPS`` ``serve_step`` calls fed its own greedy tokens.
    Returns ([logits], [fed tokens])."""
    out = {}
    for arch, case in cases.items():
        rcfg, kw = case.rcfg, case.ref_extra()
        logits, cache = _strict(functools.partial(
            rdec.prefill, cfg=rcfg, cache_len=CACHE))(
            case.rparams, jnp.asarray(case.toks), **kw)
        step = _strict(functools.partial(rdec.serve_step, cfg=rcfg))
        cond = kw.get("cond")
        pos = S + _offset(case)
        want, fed = [np.asarray(logits)], []
        for _ in range(STEPS):
            fed.append(_greedy(want[-1], rcfg))
            lg, cache = step(case.rparams, cache, jnp.asarray(fed[-1]),
                             jnp.int32(pos), cond=cond)
            want.append(np.asarray(lg))
            pos += 1
        out[arch] = (want, fed)
    return out


def _plan(cfg):
    return pplan.plan_for_engine(cfg, slots=B, cache_len=CACHE)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("d_model", [64, 2048])
def test_sinusoidal_pos_matches_reference(monkeypatch, d_model):
    """Positions 0..8191 (musicgen's ``max_seq_len``), per row and as a
    (B, 1) decode column. XLA's fp32 ``exp`` and torch's differ by one ulp
    on some frequencies, which moves an angle p·f by up to 8191 · 2^-23 ·
    f (< 1e-3 rad): the table within 1e-3, the frequencies within one ulp.
    With XLA's ``exp`` in place of torch's the table is within 1e-6 (the
    two ``sin`` / ``cos`` differ in the last fp32 bits only)."""
    pos = np.arange(8192, dtype=np.int32).reshape(4, 2048)
    want = np.asarray(rlayers.sinusoidal_pos(jnp.asarray(pos), d_model))
    got = players.sinusoidal_pos(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    unit = np.zeros((1, 1), np.int32) + 1
    half = d_model // 2
    np.testing.assert_allclose(
        players.sinusoidal_pos(torch.from_numpy(unit), d_model)[0, 0, half:],
        np.asarray(rlayers.sinusoidal_pos(jnp.asarray(unit), d_model))[
            0, 0, half:], rtol=0, atol=1e-6)
    xla = jax.jit(jnp.exp)
    monkeypatch.setattr(torch, "exp", lambda x: torch.from_numpy(
        np.array(xla(x.numpy()))))
    same_exp = players.sinusoidal_pos(torch.from_numpy(pos), d_model)
    col = players.sinusoidal_pos(torch.tensor([[5], [8191]]), d_model)
    monkeypatch.undo()
    np.testing.assert_allclose(same_exp.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(col.numpy(), want.reshape(-1, d_model)[
        [5, 8191]][:, None], rtol=0, atol=1e-6)


def test_cross_attention_matches_reference(cases):
    """musicgen's first layer's cross-attention (wk / wv at (d, H, D)) on
    bf16 queries of 11 positions and 8 conditioning embeddings."""
    case = cases[MUSICGEN]
    rp = jax.tree.map(lambda a: a[0],
                      case.rparams["blocks"]["slot0"]["cross_attn"])
    assert rp["wk"].shape == (64, case.rcfg.num_heads, 16)
    x = _bf16(np.random.default_rng(3), (B, S, case.rcfg.d_model))
    want = _strict(functools.partial(rlayers.cross_attention,
                                     cfg=case.rcfg))(
        rp, jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(case.extra["cond"], jnp.bfloat16))
    got = players.cross_attention(
        ptfm.layer(case.params["blocks"]["slot0"]["cross_attn"], 0),
        torch.from_numpy(x).bfloat16(),
        torch.from_numpy(case.extra["cond"]).bfloat16(), case.cfg)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    tdp.assert_close(got.float().numpy(), want, LAYER_TOL)


def test_codebook_embedding_and_head(cases):
    """The four-codebook embedding bit-equal (fp32 rows summed, one
    rounding; the port keeps this embedding in fp32), and the head's
    (B, S, K, Vp) logits, pad vocab masked, within 1e-5 of max |logit|."""
    case = cases[MUSICGEN]
    rcfg, cfg = case.rcfg, case.cfg
    assert case.params["embed"].dtype == torch.float32
    assert tuple(case.params["embed"].shape) == (4, rcfg.vocab_padded, 64)
    want = np.asarray(rtfm.embed_tokens(case.rparams,
                                        jnp.asarray(case.toks), rcfg))
    got = ptfm.embed_tokens(case.params, torch.from_numpy(case.toks), cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, 64)
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))
    x = _bf16(np.random.default_rng(4), (B, S, 64))
    want = np.asarray(_strict(functools.partial(rtfm.lm_logits, cfg=rcfg))(
        case.rparams, jnp.asarray(x, jnp.bfloat16)))
    got = ptfm.lm_logits(case.params, torch.from_numpy(x).bfloat16(), cfg)
    assert got.shape == want.shape == (B, S, 4, rcfg.vocab_padded)
    tdp.assert_close(tdp.vocab(got.numpy(), cfg), tdp.vocab(want, rcfg),
                     1e-5)
    assert (got[..., rcfg.vocab_size:] == players.NEG_INF).all()


# ------------------------------------------------------------------- model
def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def test_layout_matches_reference(cases):
    """The port's ``init_params`` and caches keep the reference's trees
    key for key and shape for shape: ``cross_attn`` and ``pre_norm_cross``
    on musicgen's attention layers, (K, Vp, d) embedding and (K, d, Vp)
    head."""
    for arch, case in cases.items():
        mine = ptfm.init_params(case.cfg, torch.Generator(), "meta")
        want = jax.eval_shape(functools.partial(rtfm.init_params,
                                                cfg=case.rcfg),
                              jax.random.PRNGKey(0))
        assert _shapes(mine) == _shapes(want), arch
        assert _shapes(pdec.init_cache(case.cfg, 3, 64)) == \
            _shapes(rdec.init_cache(case.rcfg, 3, 64)), arch
    blocks = cases[MUSICGEN].params["blocks"]["slot0"]
    assert "cross_attn" in blocks and "pre_norm_cross" in blocks
    assert "cross_attn" not in cases[INTERNVL].params["blocks"]["slot0"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_steps_match_reference(cases, reference_runs, arch):
    """``prefill(cond=)`` (musicgen) or ``prefill(patch_embeds=)``
    (internvl2, 8 patches before 11 text tokens) and 4 ``serve_step``
    calls on the reference's tokens: logits within 1e-2 of max |logit|,
    greedy tokens equal or parted at a reference near-tie."""
    case = cases[arch]
    want, fed = reference_runs[arch]
    kw = case.port_extra()
    plan = _plan(case.cfg)
    logits, cache = pdec.prefill(case.params, torch.from_numpy(case.toks),
                                 case.cfg, CACHE, plan=plan, **kw)
    got = [logits]
    pos = S + _offset(case)
    for tok in fed:
        lg, cache = pdec.serve_step(case.params, cache,
                                    torch.from_numpy(tok), torch.tensor(pos),
                                    case.cfg, plan=plan, cond=kw.get("cond"))
        got.append(lg)
        pos += 1
    K = case.cfg.num_codebooks
    for g, w in zip(got, want):
        assert g.shape == w.shape == ((B, 1, K, case.cfg.vocab_padded)
                                      if K > 1 else
                                      (B, 1, case.cfg.vocab_padded))
        g, w = tdp.vocab(g.numpy(), case.cfg), tdp.vocab(w, case.rcfg)
        tdp.assert_close(g, w)
        tdp.assert_greedy(g, w)


def _streams_agree(got, fed, want, cfg):
    """``got`` (B, T[, K]) against the reference's greedy tokens ``fed``
    (T of (B, 1) or (B, K, 1)) row by row up to the first step where any
    codebook parts; there every parting codebook's reference top-2 margin
    must be a near-tie, and the row is compared no further."""
    ref = np.stack([f[..., 0] for f in fed], axis=1)        # (B, T[, K])
    assert got.shape == ref.shape
    for b in range(got.shape[0]):
        for t in range(got.shape[1]):
            differ = np.atleast_1d(got[b, t] != ref[b, t])
            if not differ.any():
                continue
            logits = tdp.vocab(want[t], cfg)[b, -1].reshape(-1, cfg
                                                            .vocab_size)
            for k in np.flatnonzero(differ):
                assert tdp.top2_margin(logits[k]) < tdp.LOGIT_TOL, (b, t, k)
            break


def test_generate_fn_matches_reference_internvl(cases, reference_runs):
    """The port's ``make_generate_fn`` with patches against the
    reference's (its scan, compiled strict): the same greedy tokens, or a
    parting at a reference near-tie."""
    case = cases[INTERNVL]
    rgen = _strict(lambda p, t, r, pe: reng.make_generate_fn(
        case.rcfg, STEPS)(p, t, r, patch_embeds=pe))(
        case.rparams, jnp.asarray(case.toks), jax.random.PRNGKey(0),
        case.ref_extra()["patch_embeds"])
    got = peng.make_generate_fn(case.cfg, STEPS, plan=_plan(case.cfg))(
        case.params, torch.from_numpy(case.toks), **case.port_extra())
    assert got.shape == (B, STEPS)
    want, _ = reference_runs[INTERNVL]
    rgen = np.asarray(rgen)
    _streams_agree(got.numpy(), [rgen[:, t, None] for t in range(STEPS)],
                   want, case.cfg)


def test_generate_fn_matches_reference_musicgen(cases, reference_runs):
    """The port's ``make_generate_fn`` at four codebooks against a greedy
    loop over the reference's ``prefill(cond=)`` and ``serve_step(cond=)``
    (``reference_runs``). Not against the reference's ``make_generate_fn``:
    at K > 1 it indexes the codebook axis of the last logits where the
    last position was meant (``src/repro/serve/engine.py:66-71``) and
    raises on the reshape to (B, K, 1). The port samples every codebook at
    the last position, as the reference's ``make_decode_step`` does."""
    case = cases[MUSICGEN]
    want, fed = reference_runs[MUSICGEN]
    with pytest.raises(TypeError):
        reng.make_generate_fn(case.rcfg, STEPS)(
            case.rparams, jnp.asarray(case.toks), jax.random.PRNGKey(0),
            cond=case.ref_extra()["cond"])
    got = peng.make_generate_fn(case.cfg, STEPS, plan=_plan(case.cfg))(
        case.params, torch.from_numpy(case.toks), **case.port_extra())
    assert got.shape == (B, STEPS, 4)
    _streams_agree(got.numpy(), fed, want, case.cfg)


def test_generate_fn_counts_patches_without_them(cases):
    """A vision config's ``cfg.num_patches`` count into the prompt and
    cache lengths even with no patches given, as the reference counts
    them: the port's plan-less ``make_generate_fn(cfg, n)`` decodes from
    position S + P and gives the reference's greedy tokens (both without
    patches; the reference compiled strict)."""
    case = cases[INTERNVL]
    rgen = _strict(lambda p, t, r: reng.make_generate_fn(case.rcfg, STEPS)(
        p, t, r))(case.rparams, jnp.asarray(case.toks),
                  jax.random.PRNGKey(0))
    got = peng.make_generate_fn(case.cfg, STEPS)(
        case.params, torch.from_numpy(case.toks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(rgen))


def test_decode_step_first_codebook_carries_eos(cases):
    """``make_decode_step`` at four codebooks: every codebook is sampled
    from the (B, K, Vp) last logits, only the first one's token ends a
    row (EOS), and the (B, K, 1) tokens are fed back: the step's logits
    equal ``serve_step`` on them."""
    case = cases[MUSICGEN]
    cfg, params = case.cfg, case.params
    cond = case.port_extra()["cond"]
    toks = torch.from_numpy(case.toks)
    logits, cache = pdec.prefill(params, toks, cfg, CACHE, cond=cond)
    last = logits[:, -1]                                    # (B, K, Vp)
    heads = last.argmax(-1)                                 # (B, K)
    # row 0's first codebook token is EOS; a later codebook's token equal
    # to EOS in row 1 must not end it
    eos = int(heads[0, 0])
    assert int(heads[1, 0]) != eos
    pos = torch.full((B,), S, dtype=torch.long)
    live = torch.ones(B, dtype=torch.bool)
    budget = torch.full((B,), 5, dtype=torch.int32)
    twin = {k: {n: {m: t.clone() for m, t in e.items()}
                for n, e in part.items()} for k, part in cache.items()}
    step = peng.make_decode_step(cfg, 0.0, eos)
    carry, (nxt, emit) = step(params, (cache, last, pos, live, budget),
                              cond=cond)
    assert torch.equal(nxt, heads) and emit.all()
    assert carry[3].tolist() == [False, True]
    want, _ = pdec.serve_step(params, twin, heads[..., None], pos, cfg,
                              cond=cond)
    assert torch.equal(carry[1], want[:, -1])
    assert carry[1].shape == (B, cfg.num_codebooks, cfg.vocab_padded)


def test_generate_fn_samples_each_codebook(cases):
    """At temperature > 0 every codebook draws its own token, from one
    seeded generator: the same seed gives the same (B, T, K) tokens."""
    case = cases[MUSICGEN]
    gen = peng.make_generate_fn(case.cfg, 3, temperature=1.0,
                                plan=_plan(case.cfg))
    outs = [gen(case.params, torch.from_numpy(case.toks),
                torch.Generator().manual_seed(7), **case.port_extra())
            for _ in range(2)]
    assert outs[0].shape == (B, 3, 4) and torch.equal(outs[0], outs[1])
    assert ((outs[0] >= 0) & (outs[0] < case.cfg.vocab_size)).all()


def _functional_generate(cfg, num_steps, temperature, *, plan):
    """The eager loop ``make_generate_fn`` ran before its steps became the
    in-place body on fixed buffers: prefill, then ``num_steps`` rounds of
    sample, ``serve_step`` on the fed-back tokens, advance."""
    def generate(params, tokens, generator=None, patch_embeds=None,
                 cond=None):
        patches = cfg.num_patches if cfg.frontend == "vision" else 0
        prompt_len = tokens.shape[-1] + patches
        logits, cache = pdec.prefill(
            params, tokens, cfg, prompt_len + num_steps, plan=plan,
            patch_embeds=patch_embeds, cond=cond)
        pos = torch.full((tokens.shape[0],), prompt_len, dtype=torch.long)
        out = []
        for _ in range(num_steps):
            nxt = peng.sample_temperature(logits[:, -1], temperature,
                                          generator)
            out.append(nxt)
            logits, cache = pdec.serve_step(params, cache, nxt[..., None],
                                            pos, cfg, plan=plan, cond=cond)
            pos = pos + 1
        return torch.stack(out, dim=1)
    return generate


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_fn_in_place_equals_functional_loop(cases, arch,
                                                     temperature):
    """``make_generate_fn``'s decode steps run as the loop's in-place body
    (what a ``StepGraph`` captures on the card; eager here) on fixed
    buffers: the same tokens, bit for bit, as the functional eager loop
    from the same prefill, greedy and at temperature 1.0 from one seeded
    generator, which both leave in the same state; patches and ``cond``
    given, four codebooks at musicgen."""
    case = cases[arch]
    plan = _plan(case.cfg)
    toks = torch.from_numpy(case.toks)
    outs, states = [], []
    for make in (peng.make_generate_fn, _functional_generate):
        gen = torch.Generator().manual_seed(11)
        outs.append(make(case.cfg, STEPS, temperature, plan=plan)(
            case.params, toks, gen, **case.port_extra()))
        states.append(gen.get_state())
    K = case.cfg.num_codebooks
    assert outs[0].shape == ((B, STEPS, K) if K > 1 else (B, STEPS))
    assert outs[0].dtype == outs[1].dtype and torch.equal(outs[0], outs[1])
    assert torch.equal(states[0], states[1])
    if temperature > 0:
        assert len(set(outs[0].flatten().tolist())) > 2   # draws, not argmax


def test_generate_fn_keeps_a_loop_per_input_shape(cases):
    """``generate.loops`` holds one decode loop (on the card, one captured
    step) per input shape, reused by a later call of that shape, with its
    buffers the same tensors: a call on another prompt length adds one, a
    call on another dict of the same leaves keeps them all, and a call
    whose params differ in a leaf releases every loop. The second call of
    a shape gives the first call's tokens."""
    case = cases[INTERNVL]
    gen = peng.make_generate_fn(case.cfg, STEPS, plan=_plan(case.cfg))
    toks = torch.from_numpy(case.toks)
    pe = case.port_extra()["patch_embeds"]
    first = gen(case.params, toks, patch_embeds=pe)
    (key, loop), = gen.loops.items()
    assert key == (tuple(toks.shape), tuple(pe.shape), None)
    buffers = [id(t) for t in peng._tensors(loop.state)]
    assert torch.equal(gen(case.params, toks, patch_embeds=pe), first)
    assert gen.loops[key] is loop
    assert [id(t) for t in peng._tensors(loop.state)] == buffers
    gen(case.params, toks[:, :-2], patch_embeds=pe)
    assert len(gen.loops) == 2
    other = dict(case.params)
    assert torch.equal(gen(other, toks, patch_embeds=pe), first)
    assert len(gen.loops) == 2 and gen.loops[key] is loop
    assert loop.params is other
    other["embed"] = other["embed"].clone()
    shorter = gen.loops[(tuple(toks[:, :-2].shape), tuple(pe.shape), None)]
    assert torch.equal(gen(other, toks, patch_embeds=pe), first)
    assert list(gen.loops) == [key] and gen.loops[key] is not loop
    assert loop.state is None and shorter.state is None     # released
    assert all(not lp.captures for lp in gen.loops.values())  # CPU: eager


def test_generate_fn_reads_a_replaced_leaf(cases):
    """A leaf replaced in the same params dict is read by the next call:
    its tokens are those of a fresh function on the new tree, not of the
    loop built on the old leaf."""
    case = cases[INTERNVL]
    plan = _plan(case.cfg)
    toks = torch.from_numpy(case.toks)
    pe = case.port_extra()["patch_embeds"]
    params = dict(case.params)
    gen = peng.make_generate_fn(case.cfg, STEPS, plan=plan)
    before = gen(params, toks, patch_embeds=pe)
    params["lm_head"] = params["lm_head"].flip(-1).contiguous()
    after = gen(params, toks, patch_embeds=pe)
    fresh = peng.make_generate_fn(case.cfg, STEPS, plan=plan)(
        params, toks, patch_embeds=pe)
    assert torch.equal(after, fresh) and not torch.equal(after, before)


def test_generate_fn_keeps_the_last_max_loops_shapes(cases):
    """At ``max_loops`` = 2 a third input shape releases the loop of the
    shape used least recently; a shape used again moves to the end."""
    case = cases[INTERNVL]
    gen = peng.make_generate_fn(case.cfg, STEPS, plan=_plan(case.cfg),
                                max_loops=2)
    toks = torch.from_numpy(case.toks)
    pe = case.port_extra()["patch_embeds"]
    shape = lambda n: (tuple(toks[:, :n].shape), tuple(pe.shape), None)
    gen(case.params, toks[:, :9], patch_embeds=pe)
    gen(case.params, toks[:, :10], patch_embeds=pe)
    nine = gen.loops[shape(9)]
    gen(case.params, toks[:, :9], patch_embeds=pe)
    ten = gen.loops[shape(10)]
    gen(case.params, toks, patch_embeds=pe)
    assert list(gen.loops) == [shape(9), shape(S)]
    assert gen.loops[shape(9)] is nine and ten.state is None


# ------------------------------------------------------ port invariants
def test_paged_equals_contiguous_at_four_codebooks(cases):
    """musicgen's four codebooks through a paged cache (``prefill_batched``
    writing the pools, ``serve_step`` with a block table) and the
    contiguous one: the prefill and two decode steps' (B, 1, K, Vp) logits
    bit-equal, as the reference's ``test_serve_step_paged_multi_codebook``
    holds its own two paths."""
    case = cases[MUSICGEN]
    cfg, params = case.cfg, case.params
    cond = case.port_extra()["cond"]
    plan = _plan(cfg)
    ps, MP = 4, CACHE // 4
    toks = torch.from_numpy(case.toks)
    lens = torch.full((B,), S, dtype=torch.int32)
    bt = torch.from_numpy(tdp.block_table(B, MP))
    pool = pdec.init_paged_cache(cfg, B, CACHE, B * MP, ps)
    pg_logits, pool = pdec.prefill_batched(
        params, toks, lens, cfg, CACHE, plan=plan, cond=cond,
        paged=pdec.PagedPrefill(cache=pool, block_table_rows=bt,
                                slots=torch.arange(B)))
    c_logits, cache = pdec.prefill(params, toks, cfg, CACHE, plan=plan,
                                   cond=cond)
    assert c_logits.shape == (B, 1, 4, cfg.vocab_padded)
    assert torch.equal(pg_logits, c_logits)
    pos = lens.long()
    for _ in range(2):
        nxt = c_logits[:, -1].argmax(-1)[..., None]               # (B,K,1)
        pg_logits, pool = pdec.serve_step(params, pool, nxt, pos, cfg,
                                          plan=plan, block_table=bt,
                                          cond=cond)
        c_logits, cache = pdec.serve_step(params, cache, nxt, pos, cfg,
                                          plan=plan, cond=cond)
        assert torch.equal(pg_logits, c_logits)
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_step_equals_longer_prefill(cases, arch):
    """Prefill of S tokens (after the patches) against prefill of S - 1
    and one step with the last: the last position's logits within 1e-2 of
    max |logit| (bf16 K/V of the cache against prefill's own; fp32 sums in
    another order)."""
    case = cases[arch]
    cfg, kw = case.cfg, case.port_extra()
    plan = _plan(cfg)
    toks = torch.from_numpy(case.toks)
    want, _ = pdec.prefill(case.params, toks, cfg, CACHE, plan=plan, **kw)
    _, cache = pdec.prefill(case.params, toks[..., :-1], cfg, CACHE,
                            plan=plan, **kw)
    got, _ = pdec.serve_step(case.params, cache, toks[..., -1:],
                             torch.tensor(S - 1 + _offset(case)), cfg,
                             plan=plan, cond=kw.get("cond"))
    tdp.assert_close(tdp.vocab(got.numpy(), cfg), tdp.vocab(want.numpy(),
                                                            cfg))


def test_verify_step_repeats_cond_per_candidate(cases):
    """``verify_step`` with ``cond`` on musicgen's layers at one codebook:
    each row's k virtual rows read that row's conditioning, so its logits
    equal k sequential ``serve_step`` calls' within 1e-5 of max |logit|
    (fp32 sums of another batch shape)."""
    case = cases[MUSICGEN]
    cfg = dataclasses.replace(case.cfg, num_codebooks=1)
    params = dict(case.params, embed=case.params["embed"][0],
                  lm_head=case.params["lm_head"][0])
    cond = case.port_extra()["cond"]
    plan = _plan(cfg)
    ps, MP, k = 4, CACHE // 4, 3
    toks = torch.from_numpy(case.toks[:, 0])
    lens = torch.full((B,), S, dtype=torch.int32)
    bt = torch.from_numpy(tdp.block_table(B, MP))
    outs = []
    for verify in (True, False):
        pool = pdec.init_paged_cache(cfg, B, CACHE, B * MP, ps)
        _, pool = pdec.prefill_batched(
            params, toks, lens, cfg, CACHE, plan=plan, cond=cond,
            paged=pdec.PagedPrefill(cache=pool, block_table_rows=bt,
                                    slots=torch.arange(B)))
        cand = toks[:, :k]
        if verify:
            outs.append(pdec.verify_step(params, pool, cand, lens.long(),
                                         cfg, plan=plan, block_table=bt,
                                         cond=cond)[0])
            continue
        steps = []
        for i in range(k):
            lg, pool = pdec.serve_step(params, pool, cand[:, i:i + 1],
                                       lens.long() + i, cfg, plan=plan,
                                       block_table=bt, cond=cond)
            steps.append(lg)
        outs.append(torch.cat(steps, dim=1))
    tdp.assert_close(tdp.vocab(outs[0].numpy(), cfg),
                     tdp.vocab(outs[1].numpy(), cfg), 1e-5)


def test_missing_inputs_are_refused(cases):
    """A cross-attention config without ``cond`` and a vision config in
    ``prefill_batched`` raise ``ValueError`` naming what to pass."""
    m, v = cases[MUSICGEN], cases[INTERNVL]
    with pytest.raises(ValueError, match="pass cond"):
        pdec.prefill(m.params, torch.from_numpy(m.toks), m.cfg, CACHE,
                     plan=_plan(m.cfg))
    with pytest.raises(ValueError, match="prefill"):
        pdec.prefill_batched(v.params, torch.from_numpy(v.toks), [S, S],
                             v.cfg, CACHE, plan=_plan(v.cfg))


def test_synthetic_embeddings():
    """``frontend``'s shape helpers and seeded bf16 draws at the full
    configs' widths (the reference's specs and scale)."""
    for arch in ("musicgen-large", "internvl2-26b"):
        cfg = get_config(arch)
        shape, dtype = (pfront.cond_embed_spec if cfg.cross_attn_cond
                        else pfront.patch_embed_spec)(3, cfg)
        assert dtype == torch.bfloat16
        assert shape == ((3, 64, 2048) if cfg.cross_attn_cond
                         else (3, 256, 6144))
    cfg = get_config(MUSICGEN)
    draws = [pfront.synth_cond_embeds(torch.Generator().manual_seed(1), 2,
                                      cfg) for _ in range(2)]
    assert draws[0].dtype == torch.bfloat16 and draws[0].shape == (2, 8, 64)
    assert torch.equal(draws[0], draws[1])
    assert 0.005 < float(draws[0].float().std()) < 0.05
    cfg = get_config(INTERNVL)
    pe = pfront.synth_patch_embeds(torch.Generator().manual_seed(1), 2, cfg)
    assert pe.shape == (2, 8, 64) and pe.dtype == torch.bfloat16


def test_full_size_layout():
    """musicgen-large at its 48 layers (3.26e9 parameters: cross-attention
    on every layer, four 2048-row codebooks) and internvl2-26b at its 48
    (the depth the card serves it at), on the meta device."""
    cfg = get_config("musicgen-large")
    params = ptfm.init_params(cfg, torch.Generator(), "meta")
    blk = params["blocks"]["slot0"]
    assert tuple(blk["cross_attn"]["wk"].shape) == (48, 2048, 32, 64)
    assert tuple(blk["mlp"]["w1"].shape) == (48, 2048, 8192)
    assert tuple(params["embed"].shape) == (4, 2048, 2048)
    assert tuple(params["lm_head"].shape) == (4, 2048, 2048)
    assert cfg.param_count() == 3_255_076_864
    vl = get_config("internvl2-26b")
    params = ptfm.init_params(vl, torch.Generator(), "meta")
    assert tuple(params["blocks"]["slot0"]["mlp"]["wg"].shape) == \
        (48, 6144, 16384)
    assert tuple(params["embed"].shape) == (vl.vocab_padded, 6144)
