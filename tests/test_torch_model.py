"""The port's model path against the reference on ``qwen2.5-3b-reduced``.

Reference parameters come from ``transformer.init_params(PRNGKey(0), cfg)``
and are bridged to the port as numpy; prompts are made with numpy from a
seed. Both packages compute in bf16 with fp32 accumulation, norms and
softmax, so they differ only where an fp32 sum taken in another order flips
a bf16 rounding; logits are held to 1e-2 of max |logit| and greedy tokens
must agree.
"""
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

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.plan import ServePlan
from repro_torch.models import decoding as pdec
from repro_torch.models import transformer as ptfm
from repro_torch.serve import sparse as psparse

ARCH = "qwen2.5-3b-reduced"
CACHE, PS = 32, 4
LENGTHS = [5, 11, 8]


@pytest.fixture(scope="module")
def setup():
    rcfg, cfg = rget_config(ARCH), get_config(ARCH)
    rparams = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    plan = rplan.plan_for_scheduler(rcfg, rows=len(LENGTHS), cache_len=CACHE,
                                    page_size=PS, share_prefix=False)
    rng = np.random.default_rng(0)
    toks = np.zeros((len(LENGTHS), 16), np.int32)
    for i, n in enumerate(LENGTHS):
        toks[i, :n] = rng.integers(2, rcfg.vocab_size, n)
    return rcfg, cfg, rparams, plan, toks


def _port_params(rparams):
    return ptfm.compute_copy(bridge.params_from_numpy(
        jax.tree.map(np.asarray, rparams)))


def _block_table(n_rows, max_pages):
    """Rows' pages interleaved over the pool (row i holds i, i+n, ...)."""
    return np.asarray([[i + n_rows * j for j in range(max_pages)]
                       for i in range(n_rows)], np.int32)


def _close(got, want, frac=1e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


def _ref_paged(rcfg, rparams, toks, plan):
    """Reference prefill (paged) then one decode step with a block table."""
    B = toks.shape[0]
    MP = plan.max_pages
    bt = jnp.asarray(_block_table(B, MP))
    cache = rdec.init_paged_cache(rcfg, B, CACHE, B * MP, PS, "fp")
    pp = rdec.PagedPrefill(cache=cache, block_table_rows=bt,
                           slots=jnp.arange(B))
    logits, cache = rdec.prefill_batched(rparams, jnp.asarray(toks),
                                         jnp.asarray(LENGTHS), rcfg, CACHE,
                                         paged=pp)
    nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    step, cache2 = rdec.serve_step(rparams, cache, nxt,
                                   jnp.asarray(LENGTHS, jnp.int32), rcfg,
                                   block_table=bt)
    return logits, cache, step, cache2


def _port_paged(cfg, params, toks, plan, paged=True):
    B = toks.shape[0]
    MP = plan.max_pages
    bt = torch.from_numpy(_block_table(B, MP))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
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
        bt = None
    pool = {k: v.clone() for k, v in cache["blocks"]["slot0"].items()}
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    step, _ = pdec.serve_step(params, cache, nxt, lengths.long(), cfg,
                              plan=plan, block_table=bt)
    return logits, pool, step


@pytest.mark.parametrize("sparsity", [None, 0.5])
def test_prefill_and_serve_step_match_reference(setup, sparsity):
    """Paged prefill logits and pool pages, then a decode step's logits
    through the block table: dense weights, and MLPs packed at 0.5 (fused
    sparse MLP at these widths in both packages)."""
    rcfg, cfg, rparams, plan, toks = setup
    if sparsity is not None:
        rparams, _ = rsparse.sparsify_mlp_params(rparams, rcfg, sparsity)
    r_logits, r_cache, r_step, _ = _ref_paged(rcfg, rparams, toks, plan)
    params = _port_params(rparams)
    p_logits, p_pool, p_step = _port_paged(cfg, params, toks,
                                           ServePlan.from_dict(plan.as_dict()))
    assert p_logits.shape == r_logits.shape and p_logits.dtype == torch.float32
    _close(p_logits[..., :cfg.vocab_size], r_logits[..., :rcfg.vocab_size])
    assert (p_logits[..., cfg.vocab_size:] == -2.0e38).all()
    for k in ("pk", "pv"):
        want = np.asarray(r_cache["blocks"]["slot0"][k].astype(jnp.float32))
        _close(p_pool[k].float(), want)
    _close(p_step[..., :cfg.vocab_size], r_step[..., :rcfg.vocab_size])
    assert (p_step.argmax(-1).numpy() == np.asarray(r_step.argmax(-1))).all()


def test_int8_pool_prefill_and_append_match_reference(setup):
    """int8 pages: quantized payloads and per-(page, KV head) scales after a
    prefill and one append, and the decode logits read through them."""
    rcfg, cfg, rparams, plan, toks = setup
    B, MP = toks.shape[0], plan.max_pages
    bt = _block_table(B, MP)
    cache = rdec.init_paged_cache(rcfg, B, CACHE, B * MP, PS, "int8")
    pp = rdec.PagedPrefill(cache=cache, block_table_rows=jnp.asarray(bt),
                           slots=jnp.arange(B))
    r_logits, r_cache = rdec.prefill_batched(
        rparams, jnp.asarray(toks), jnp.asarray(LENGTHS), rcfg, CACHE,
        paged=pp)
    nxt = jnp.argmax(r_logits[:, -1], axis=-1)[:, None]
    r_step, r_cache = rdec.serve_step(rparams, r_cache, nxt,
                                      jnp.asarray(LENGTHS, jnp.int32), rcfg,
                                      block_table=jnp.asarray(bt))
    params = _port_params(rparams)
    pplan = ServePlan.from_dict(plan.as_dict())
    cache = pdec.init_paged_cache(cfg, B, CACHE, B * MP, PS, "int8")
    pp = pdec.PagedPrefill(cache=cache, block_table_rows=torch.from_numpy(bt),
                           slots=torch.arange(B))
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    p_logits, cache = pdec.prefill_batched(params, torch.from_numpy(toks),
                                           lengths, cfg, CACHE, plan=pplan,
                                           paged=pp)
    p_step, cache = pdec.serve_step(
        params, cache, bridge.tensor_from_numpy(nxt).long(),
        lengths.long(), cfg, plan=pplan, block_table=torch.from_numpy(bt))
    _close(p_logits[..., :cfg.vocab_size], r_logits[..., :rcfg.vocab_size])
    _close(p_step[..., :cfg.vocab_size], r_step[..., :rcfg.vocab_size])
    got, want = cache["blocks"]["slot0"], r_cache["blocks"]["slot0"]
    for k in ("pk_scale", "pv_scale"):
        _close(got[k], want[k], frac=1e-2)
    for k in ("pk", "pv"):
        diff = got[k].int() - bridge.tensor_from_numpy(want[k]).int()
        # a bf16 rounding flipped upstream moves a code, or a page's scale,
        # by a last step; the dequantized pages agree like the logits do
        assert float((diff != 0).float().mean()) < 0.02
        deq = (got[k].float() * got[k + "_scale"][:, :, None, :, None]
               / 127.0)
        want_deq = np.asarray(want[k], np.float32) * np.asarray(
            want[k + "_scale"])[:, :, None, :, None] / 127.0
        _close(deq, want_deq)


def test_sparsify_matches_reference_packs(setup):
    """Packing at 0.5 gives the reference's packs: identical payload bits,
    row and column ids, real counts and per-layer ``_bcsc_counts``."""
    rcfg, cfg, rparams, _, _ = setup
    rpacked, rstats = rsparse.sparsify_mlp_params(rparams, rcfg, 0.5)
    ppacked, pstats = psparse.sparsify_mlp_params(
        bridge.params_from_numpy(jax.tree.map(np.asarray, rparams)), cfg, 0.5)
    rm = jax.tree.map(np.asarray, rpacked["blocks"]["slot0"]["mlp"])
    pm = ppacked["blocks"]["slot0"]["mlp"]
    for name in ("wg", "wu", "wd"):
        for key in ("blocks", "row_ids", "col_ids", "nnzb"):
            want = bridge.tensor_from_numpy(rm[name][key])
            got = pm[name][key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            assert torch.equal(got, want), (name, key)
    assert torch.equal(pm["_bcsc_counts"],
                       bridge.tensor_from_numpy(rm["_bcsc_counts"]))
    for key in ("packed", "kept_blocks", "total_blocks", "padded_blocks"):
        assert pstats[key] == rstats[key], key


def test_packed_at_zero_sparsity_equals_dense(setup):
    """Inside the port: every block kept, the packed MLP computes exactly
    the dense one (same bf16 products, same fp32 sums, same roundings)."""
    _, cfg, rparams, plan, toks = setup
    dense = _port_params(rparams)
    packed, _ = psparse.sparsify_mlp_params(dense, cfg, 0.0)
    pplan = ServePlan.from_dict(plan.as_dict())
    d_logits, _, d_step = _port_paged(cfg, dense, toks, pplan)
    s_logits, _, s_step = _port_paged(cfg, packed, toks, pplan)
    assert torch.equal(d_logits, s_logits)
    assert torch.equal(d_step, s_step)


def test_paged_equals_contiguous(setup):
    """Inside the port: the block-table path and the contiguous cache give
    the same prefill logits and the same next-token logits to within fp32
    summation order (1e-5 of max |logit|)."""
    _, cfg, rparams, plan, toks = setup
    params = _port_params(rparams)
    pplan = ServePlan.from_dict(plan.as_dict())
    p_logits, _, p_step = _port_paged(cfg, params, toks, pplan, paged=True)
    c_logits, _, c_step = _port_paged(cfg, params, toks, pplan, paged=False)
    assert torch.equal(p_logits, c_logits)
    _close(p_step[..., :cfg.vocab_size], c_step[..., :cfg.vocab_size], 1e-5)
    assert torch.equal(p_step.argmax(-1), c_step.argmax(-1))


def test_init_params_shapes_and_bridge_keys(setup):
    """The port's own init has the reference's tree, shapes and scales."""
    rcfg, cfg, rparams, _, _ = setup
    mine = ptfm.init_params(cfg, torch.Generator().manual_seed(0))
    ref = jax.tree.map(np.asarray, rparams)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}.{k}")
            else:
                assert tuple(a[k].shape) == b[k].shape, f"{path}.{k}"
    walk(mine, ref)
    wq = mine["blocks"]["slot0"]["attn"]["wq"]
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.1


def test_bcsc_encode_decode_match_reference():
    """Vectorised encode == the reference's loop (column-major blocks, row
    ids, address vector), including an empty block-column that
    ``ensure_nonempty_cols`` fills; decode inverts it."""
    import importlib
    from repro.core import sparsity as rsp
    # the reference's kernels package exports a function of the same name
    rbm = importlib.import_module("repro.kernels.bcsc_matmul")
    from repro_torch.core import sparsity as psp
    from repro_torch.kernels import bcsc_matmul as pbm
    w = np.random.default_rng(4).standard_normal((64, 96)).astype(np.float32)
    w[:, 16:32] = 0
    w[32:48, 48:] = 0
    for fill in (False, True):
        ref = rsp.bcsc_encode(w, 16, 16)
        mine = psp.bcsc_encode(torch.from_numpy(w), 16, 16)
        if fill:
            ref, mine = rbm.ensure_nonempty_cols(ref), \
                pbm.ensure_nonempty_cols(mine)
        for key in ("blocks", "row_ids", "col_ptr"):
            assert torch.equal(getattr(mine, key), bridge.tensor_from_numpy(
                getattr(ref, key))), key
        assert torch.equal(psp.bcsc_decode(mine), torch.from_numpy(w))
    assert torch.equal(pbm.expand_col_ptr(mine.col_ptr),
                       torch.from_numpy(rbm.expand_col_ptr(ref.col_ptr)))
