"""The port's kernels against the reference's Pallas kernels.

Every case makes its inputs with numpy from a seed, hands identical bf16
values to ``repro.kernels.ops`` (Pallas in interpret mode off TPU) and to
``repro_torch.kernels.ops`` (the plain PyTorch version, since the tensors lie
on the CPU), and compares. The ``gpu``-marked tests hold each CUDA kernel
against its plain version and skip where there is no card; they need
neither JAX nor the reference package, which the other tests import through
the ``ref`` fixture, so ``-m gpu`` runs on a machine without JAX.
"""
import math
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core import plan as pplan
from repro_torch.kernels import epilogue as pepi
from repro_torch.kernels import local_attention as pswa
from repro_torch.kernels import ops as pops
from repro_torch.kernels import paged_attention as ppa
from repro_torch.kernels import rs_matmul as prs
from repro_torch.serve import sparse as psparse


@pytest.fixture(scope="module")
def ref():
    """The reference package's pieces these tests compare against."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as get_cfg
    from repro.core import dataflow, plan
    from repro.core.sparsity import block_magnitude_prune
    from repro.kernels import epilogue, ops
    from repro.kernels import ref as oracles
    from repro.models import flash
    from repro.serve import sparse
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_config=get_cfg, dataflow=dataflow, plan=plan,
        prune=block_magnitude_prune, epilogue=epilogue, ops=ops,
        sparse=sparse, oracles=oracles, flash=flash)


def _bf16(rng, shape, scale=1.0):
    """bf16 values as fp32 numpy (exactly representable in both packages)."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)
    return x.bfloat16().float().numpy()


def _plan(ref=None):
    """The reduced qwen plan: resolved by the reference and loaded here, or
    (``ref`` None) resolved by the port."""
    if ref is None:
        return pplan.plan_for_scheduler(get_config("qwen2.5-3b-reduced"),
                                        rows=2, cache_len=64, page_size=8,
                                        share_prefix=False)
    plan = ref.plan.plan_for_scheduler(ref.get_config("qwen2.5-3b-reduced"),
                                       rows=2, cache_len=64, page_size=8,
                                       share_prefix=False)
    return pplan.ServePlan.from_dict(plan.as_dict())


def _paged_case(lengths, ps, KV=2, R=4, D=16, seed=0, int8=False):
    """Pools, a permuted block table (-1 past each row's pages), lengths."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    MP = max(-(-n // ps) for n in lengths) + 1       # a never-touched column
    P = sum(-(-n // ps) for n in lengths) + 2
    q = _bf16(rng, (B, 1, KV * R, D))
    if int8:
        kp = rng.integers(-127, 128, (P, ps, KV, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, ps, KV, D)).astype(np.int8)
        scales = (rng.random((2, P, KV)) * 3).astype(np.float32)
    else:
        kp, vp = _bf16(rng, (P, ps, KV, D)), _bf16(rng, (P, ps, KV, D))
        scales = None
    bt = np.full((B, MP), -1, np.int32)
    perm = rng.permutation(P)
    i = 0
    for b, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            bt[b, j] = perm[i]
            i += 1
    return q, kp, vp, bt, np.asarray(lengths, np.int32), scales


# ------------------------------------------------------------ paged attention
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_paged_attention_matches_reference(ref, int8, softcap):
    """fp32 online softmax (reference) vs one masked softmax (port) on the
    same bf16 / int8 inputs: only the summation order differs, so 1e-5."""
    ps = 8
    q, kp, vp, bt, lens, sc = _paged_case([ps, ps + 1, 3 * ps - 1, 2], ps,
                                          int8=int8)
    jnp = ref.jnp
    pool_dt = jnp.int8 if int8 else jnp.bfloat16
    rkw = {} if sc is None else dict(k_scale=jnp.asarray(sc[0]),
                                     v_scale=jnp.asarray(sc[1]))
    want = ref.ops.paged_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, pool_dt),
        jnp.asarray(vp, pool_dt), jnp.asarray(bt), jnp.asarray(lens),
        softcap=softcap, **rkw)
    tdt = torch.int8 if int8 else torch.bfloat16
    pkw = {} if sc is None else dict(k_scale=torch.from_numpy(sc[0]),
                                     v_scale=torch.from_numpy(sc[1]))
    got = pops.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).to(tdt),
        torch.from_numpy(vp).to(tdt), torch.from_numpy(bt),
        torch.from_numpy(lens), softcap=softcap, **pkw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_paged_attention_reads_nothing_past_length():
    """Garbage (NaN) in every slot past a row's length, in its unused table
    pages and in never-referenced pool pages never reaches the output."""
    ps = 4
    q, kp, vp, bt, lens, _ = _paged_case([5, 9], ps, seed=2)
    clean = pops.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(bt),
        torch.from_numpy(lens))
    kd, vd = kp.copy(), vp.copy()
    used = np.zeros(kp.shape[:2], bool)
    for b, n in enumerate(lens):
        for t in range(n):
            used[bt[b, t // ps], t % ps] = True
    kd[~used] = np.nan
    vd[~used] = np.nan
    dirty = pops.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kd).bfloat16(),
        torch.from_numpy(vd).bfloat16(), torch.from_numpy(bt),
        torch.from_numpy(lens))
    assert torch.equal(clean, dirty)


def _hole_case():
    """A table with a -1 inside row 0's occupancy (its second page) and a
    -1 past row 1's; page 0 holds real data."""
    q, kp, vp, bt, lens, _ = _paged_case([20, 9], 8, seed=5)
    bt[0, 1] = -1
    return q, kp, vp, bt, lens


def test_paged_attention_hole_in_table_reads_page_zero(ref):
    """As the reference does, an entry of -1 inside a row's occupancy is
    clamped to page 0 and that page is read: the plain version against
    ``ref.paged_attention_ref`` and the Pallas kernel in interpret mode,
    1e-5 (fp32 sums in another order)."""
    q, kp, vp, bt, lens = _hole_case()
    jnp = ref.jnp
    B, _, H, D = q.shape
    KV = kp.shape[2]
    rq = jnp.asarray(q, jnp.bfloat16)
    rk, rv = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
    want_oracle = np.asarray(ref.oracles.paged_attention_ref(
        rq.reshape(B, KV, H // KV, D), rk, rv, jnp.asarray(bt),
        jnp.asarray(lens))).reshape(q.shape)
    want_kernel = np.asarray(ref.ops.paged_attention(
        rq, rk, rv, jnp.asarray(bt), jnp.asarray(lens)))
    got = pops.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(bt),
        torch.from_numpy(lens)).numpy()
    for want in (want_oracle, want_kernel):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the hole really read page 0: naming another page changes row 0
    fixed = bt.copy()
    fixed[0, 1] = kp.shape[0] - 1
    other = pops.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(fixed),
        torch.from_numpy(lens)).numpy()
    assert not np.allclose(other[0], got[0])


def test_work_steps_count_only_occupied_pages():
    assert ppa.row_work_steps(9, 4) == 3
    assert ppa.work_steps([1, 4, 5, 0], 4) == 1 + 1 + 2 + 0


H100_SMS = 132


def split_runs(length, page_size, MP, pages_per_split):
    """The page runs [lo, hi) of a row's table that the CUDA kernel's splits
    read, in split order (csrc/paged_attention.cu): split s reads entries
    s * pages_per_split onward, cut at the row's occupancy
    min(ceil(len / page_size), MP); a split that starts at or past it
    returns without reading and is left out."""
    n = min(int(ppa.row_work_steps(max(int(length), 0), page_size)), MP)
    return [(lo, min(lo + pages_per_split, n))
            for lo in range(0, n, pages_per_split)]


@pytest.mark.parametrize("B,KV,MP", [(8, 2, 16), (4, 4, 128), (1, 1, 1),
                                     (1, 2, 300), (64, 8, 4), (3, 1, 7),
                                     (264, 1, 512)])
def test_split_plan_fills_the_card(B, KV, MP):
    """Shapes only: at least 2 blocks per SM of an H100, or one page per
    split (every page of a row its own block); the splits cover the table.
    (8, 2, 16) and (4, 4, 128) are qwen2.5-3b's and gemma2-2b's decode."""
    pages, n_split = ppa.split_plan(B, KV, MP, H100_SMS)
    assert 1 <= pages <= ppa.MAX_RUN
    assert n_split * pages >= MP > (n_split - 1) * pages
    assert B * KV * n_split >= 2 * H100_SMS or pages == 1
    if (B, KV, MP) == (4, 4, 128):     # gemma2-2b: 94-page rows split 14 ways
        assert (pages, n_split) == (7, 19)


@pytest.mark.parametrize("ps,MP,pages", [(64, 16, 1), (64, 128, 7),
                                         (8, 20, 3), (16, 5, 5)])
def test_split_runs_count_work_steps(ps, MP, pages):
    """The pages the splits read below each row's occupancy sum to the
    reference's structural count ``work_steps`` (``row_work_steps`` per
    row), each page once and in table order, at lengths that are not
    multiples of the run, of one token, of exactly one run, and of 0."""
    rng = np.random.default_rng(ps + MP)
    lengths = [n for n in (0, 1, ps * pages, ps * pages + 1, ps - 1,
                           *rng.integers(1, MP * ps + 1, 6)) if n <= MP * ps]
    covered = 0
    for n in lengths:
        runs = split_runs(n, ps, MP, pages)
        flat = [j for lo, hi in runs for j in range(lo, hi)]
        assert flat == list(range(ppa.row_work_steps(n, ps)))
        assert all(lo == s * pages for s, (lo, _) in enumerate(runs))
        assert len(runs) <= -(-MP // pages)
        covered += len(flat)
    assert covered == ppa.work_steps(lengths, ps)
    assert split_runs(0, ps, MP, pages) == []
    assert split_runs(ps * pages, ps, MP, pages) == [(0, pages)]
    # a length past the table reads its MP pages, as the plain version does
    assert split_runs(MP * ps + 5, ps, MP, pages)[-1][1] == MP


def _split_combine_model(q, k_pool, v_pool, block_table, lengths, *,
                         k_scale=None, v_scale=None, softcap=0.0,
                         pages_per_split=2, tile=64):
    """The CUDA kernels' arithmetic in torch: each split's fp32 online
    softmax over tiles of ``tile`` tokens into a workspace that starts as
    NaN (as ``torch.empty`` may), then the combine over the splits below
    each row's occupancy, in split order."""
    B, KV, R, D = q.shape
    P, ps = k_pool.shape[:2]
    MP = block_table.shape[1]
    n_split = -(-MP // pages_per_split)
    neg = ppa.NEG_INF
    ws_acc = torch.full((B, KV, n_split, R, D), float("nan"))
    ws_m = torch.full((B, KV, n_split, R), float("nan"))
    ws_l = torch.full((B, KV, n_split, R), float("nan"))
    qf = q.float()
    for b in range(B):
        n = int(lengths[b])
        for s, (j0, j1) in enumerate(split_runs(n, ps, MP,
                                                    pages_per_split)):
            toks = torch.arange(j0 * ps, min(j1 * ps, n))
            pages = block_table[b, toks // ps].long().clamp(0, P - 1)
            kd = k_pool[pages, toks % ps].float()             # (T, KV, D)
            vd = v_pool[pages, toks % ps].float()
            if k_scale is not None:
                kd = kd * (k_scale[pages] * (1.0 / 127.0))[..., None]
                vd = vd * (v_scale[pages] * (1.0 / 127.0))[..., None]
            m = torch.full((KV, R), neg)
            l = torch.zeros(KV, R)
            acc = torch.zeros(KV, R, D)
            for t0 in range(0, len(toks), tile):
                kt, vt = kd[t0:t0 + tile], vd[t0:t0 + tile]
                sc = torch.einsum("grd,tgd->grt", qf[b], kt) \
                    * (1.0 / math.sqrt(D))
                if softcap > 0:
                    sc = torch.tanh(sc / softcap) * softcap
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.where(sc > neg / 2, torch.exp(sc - m_new[..., None]),
                                torch.zeros_like(sc))
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum("grt,tgd->grd", p,
                                                           vt)
                m = m_new
            ws_acc[b, :, s], ws_m[b, :, s], ws_l[b, :, s] = acc, m, l
    out = torch.empty(B, KV, R, D)
    for b in range(B):
        used = len(split_runs(int(lengths[b]), ps, MP, pages_per_split))
        ms = ws_m[b, :, :used]                                 # (KV, S, R)
        m = ms.amax(1, keepdim=True) if used else torch.full((KV, 1, R), neg)
        w = torch.where(ms > neg / 2, torch.exp(ms - m), torch.zeros_like(ms))
        lsum = (ws_l[b, :, :used] * w).sum(1)
        asum = (ws_acc[b, :, :used] * w[..., None]).sum(1)
        out[b] = asum / lsum.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("pages_per_split,tile", [(1, 8), (2, 3), (3, 64)])
def test_split_combine_model_matches_plain(int8, softcap, pages_per_split,
                                           tile):
    """Split-and-combine equals one masked softmax within 1e-5: rows of 0
    and 1 tokens, of exactly one split, not a multiple of the split, a -1
    hole inside the occupancy, splits past the occupancy left unwritten
    (NaN) and never read."""
    ps = 8
    lens = [0, 1, ps * pages_per_split, 5 * ps + 3, 2 * ps - 1]
    q, kp, vp, bt, lens, sc = _paged_case(lens, ps, KV=2, R=3, D=16,
                                          seed=11, int8=int8)
    bt[3, 1] = -1                                   # reads page 0
    dt = torch.int8 if int8 else torch.bfloat16
    args = (torch.from_numpy(q).bfloat16().reshape(len(lens), 2, 3, 16),
            torch.from_numpy(kp).to(dt), torch.from_numpy(vp).to(dt),
            torch.from_numpy(bt), torch.from_numpy(lens))
    kw = {} if sc is None else dict(k_scale=torch.from_numpy(sc[0]),
                                    v_scale=torch.from_numpy(sc[1]))
    want = ppa.paged_attention_plain(*args, softcap=softcap, **kw)
    got = _split_combine_model(*args, softcap=softcap,
                               pages_per_split=pages_per_split, tile=tile,
                               **kw)
    assert torch.isfinite(got).all()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


# ----------------------------------------------------------------- BCSC packs
def _packed_pair(ref, K, N, sparsity, seed, capacity=None):
    """A weight pruned and packed by the reference, and the same pack
    bridged into the port (optionally padded to ``capacity`` blocks)."""
    rng = np.random.default_rng(seed)
    jnp = ref.jnp
    w = np.asarray(ref.prune(jnp.asarray(rng.standard_normal((K, N)),
                                         jnp.float32), sparsity, 16, 16))
    packed = ref.sparse.pack_weight(w, 16, 16, jnp.bfloat16)
    if capacity is not None:
        packed = ref.sparse.pad_packed(packed, capacity)
    return packed, bridge.params_from_numpy(
        {k: np.asarray(v) for k, v in packed.items()})


def _port_pack(K, N, sparsity, seed, device):
    """A weight pruned and packed by the port alone."""
    from repro_torch.core import sparsity as sp
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(K, N, generator=g) / K ** 0.5
    packed = psparse.pack_weight(sp.block_magnitude_prune(w, sparsity, 16,
                                                          16), 16, 16,
                                 torch.bfloat16)
    return {k: v.to(device) for k, v in packed.items()}


@pytest.mark.parametrize("M", [3, 8, 24, 40])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
def test_bcsc_apply_packed_both_arms(ref, M, act):
    """M <= 8 takes the GEMV arm (bias + activation fused into the flush),
    M > 8 the GEMM arm (epilogue as a post-op), in both packages. fp32 sums
    of identical bf16 products in another order: 1e-5 of max |out|."""
    rng = np.random.default_rng(M)
    rpack, port = _packed_pair(ref, 64, 128, 0.5, seed=M)
    x = _bf16(rng, (M, 64))
    bias = rng.standard_normal(128).astype(np.float32)
    plan = _plan(ref)
    assert plan.matmul_route(M) == ("gemv" if M <= 8 else "gemm")
    jnp = ref.jnp
    want = np.asarray(ref.ops.bcsc_apply_packed(
        jnp.asarray(x, jnp.bfloat16), rpack, n_out=128,
        bias=jnp.asarray(bias), activation=act))
    got = pops.bcsc_apply_packed(
        torch.from_numpy(x).bfloat16(), port, n_out=128, plan=plan,
        bias=torch.from_numpy(bias), activation=act)
    assert got.dtype == torch.float32 and got.shape == (M, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("M", [1, 8, 20])
def test_bcsc_mlp_packed_padded_counts(ref, M):
    """The fused MLP over packs padded past their real block count, with a
    real ``counts``. The hidden is rounded to bf16 in both; a last-bit
    difference in its fp32 sum can flip one such rounding, so 2e-3 of
    max |out| (one bf16 step is 2^-8 of a hidden value)."""
    rng = np.random.default_rng(10 + M)
    packs = [_packed_pair(ref, K, N, 0.6, seed=s, capacity=cap)
             for K, N, s, cap in ((64, 128, 1, 24), (64, 128, 2, 24),
                                  (128, 64, 3, 32))]
    counts = np.asarray([int(r["nnzb"]) for r, _ in packs], np.int32)
    assert all(counts < np.asarray([24, 24, 32]))
    x = _bf16(rng, (M, 64))
    jnp = ref.jnp
    want = np.asarray(ref.ops.bcsc_mlp_packed(
        jnp.asarray(x, jnp.bfloat16), *(r for r, _ in packs), d_ff=128,
        n_out=64, activation="silu", counts=jnp.asarray(counts)))
    got = pops.bcsc_mlp_packed(
        torch.from_numpy(x).bfloat16(), *(p for _, p in packs), d_ff=128,
        n_out=64, plan=_plan(ref), activation="silu",
        counts=torch.from_numpy(counts))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-3 * np.abs(want).max())


@pytest.mark.parametrize("act", [None, "none", "relu", "silu", "gelu"])
def test_fused_epilogue_every_activation(ref, act):
    """Bias then activation in fp32, both packages: 1e-6."""
    rng = np.random.default_rng(3)
    acc = rng.standard_normal((4, 32)).astype(np.float32) * 4
    bias = rng.standard_normal(32).astype(np.float32)
    want = np.asarray(ref.epilogue.fused_epilogue(
        ref.jnp.asarray(acc), ref.jnp.asarray(bias), act))
    got = pepi.fused_epilogue(torch.from_numpy(acc), torch.from_numpy(bias),
                              act)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_dispatch_refuses_unknown_impl_and_device():
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    port = _port_pack(64, 128, 0.5, 0, "cpu")
    with pytest.raises(ValueError, match="impl"):
        pops.bcsc_apply_packed(x, port, n_out=128, plan=_plan(),
                               impl="fast")
    with pytest.raises(RuntimeError, match="no kernel"):
        pops._use_kernel(x.to("meta"), None)


def test_plan_routes_match_reference_dataflow(ref):
    """The port's plan queries give the reference's routes at every M."""
    plan = pplan.plan_for_scheduler(get_config("qwen2.5-3b"), rows=8,
                                    cache_len=1024)
    rdf = ref.dataflow
    for M in (1, 7, 8, 9, 16, 63, 64, 65, 512, 4096):
        assert plan.matmul_route(M) == rdf.matmul_path(M)
        assert plan.bcsc_bm(M) == rdf.bcsc_tile_m(M)
        assert plan.mlp_route(M) == rdf.mlp_path(M, 11008, 2048)
    assert plan.mlp_fused_m_max == 64
    cfg = get_config("qwen2.5-3b")
    assert cfg.vocab_padded == 152064 and cfg.param_count() > 3.0e9


# --------------------------------------------- sliding-window attention
def _swa_case(S, B=2, KV=2, R=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return (_bf16(rng, (B, S, KV * R, D)), _bf16(rng, (B, S, KV, D)),
            _bf16(rng, (B, S, KV, D)))


def _flash_fp32(ref, q, k, v, window, softcap):
    """``models.flash``'s forward in fp32 (before its bf16 cast), in the
    mode and block size that ``models.layers._flash_call`` picks."""
    jnp = ref.jnp
    B, S, H, D = q.shape
    KV = k.shape[2]
    blk = pswa.block_size(S)
    mode = "causal" if window >= S else "window"
    qf = jnp.asarray(q, jnp.bfloat16).reshape(B, S, KV, H // KV, D) \
        .transpose(0, 2, 3, 1, 4)
    kf = jnp.asarray(k, jnp.bfloat16).transpose(0, 2, 1, 3)
    vf = jnp.asarray(v, jnp.bfloat16).transpose(0, 2, 1, 3)
    out, _ = ref.flash._fwd_impl(qf, kf, vf, jnp.arange(S, dtype=jnp.int32),
                                 mode, window if mode == "window" else S,
                                 softcap, blk, blk)
    return np.asarray(out).transpose(0, 3, 1, 2, 4).reshape(B, S, H, D)


def _port_swa(q, k, v, window, softcap, **kw):
    return pops.sliding_window_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), window=window, softcap=softcap,
        **kw)


@pytest.mark.parametrize("S,window", [(40, 40), (40, 12), (100, 100),
                                      (100, 33), (300, 300), (300, 70),
                                      (1100, 600)])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_sliding_window_plain_matches_flash(ref, monkeypatch, S, window,
                                            softcap):
    """The plain version is ``models/flash.py``'s forward: the same block
    schedule (ragged S, several blocks, causal and window modes, blocks
    skipped), the same fp32 online softmax and bf16 PV. With XLA's exp and
    tanh in place of torch's, every output is within 1e-5. With torch's own,
    which differ from XLA's in the last fp32 bits, a p now and then rounds
    to the other bf16 neighbour (2^-8 of it): 99 % of the outputs stay
    within 1e-5, and each (position, head) row within 2e-3 of its own
    max |out|."""
    q, k, v = _swa_case(S, D=16 if S < 1000 else 8, seed=S + window)
    want = _flash_fp32(ref, q, k, v, window, softcap)
    got = _port_swa(q, k, v, window, softcap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    diff = np.abs(got.numpy() - want)
    assert (diff <= 1e-5).mean() >= 0.99
    assert (diff.max(-1) <= 2e-3 * np.abs(want).max(-1)).all()
    for name in ("exp", "tanh"):
        xla = ref.jax.jit(getattr(ref.jnp, name))
        monkeypatch.setattr(torch, name, lambda x, f=xla: torch.from_numpy(
            np.array(f(x.numpy()))))
    same_math = _port_swa(q, k, v, window, softcap).numpy()
    monkeypatch.undo()
    np.testing.assert_allclose(same_math, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("S,window,softcap", [(40, 12, 0.0), (40, 40, 50.0),
                                              (100, 33, 50.0)])
def test_sliding_window_plain_matches_pallas_and_oracle(ref, S, window,
                                                        softcap):
    """Against the Pallas band kernel in interpret mode and the exact
    oracle, both of which keep p in fp32 where flash (and the port) round
    it to bf16 for the PV product: 2e-2 of max |out|."""
    jnp = ref.jnp
    q, k, v = _swa_case(S, seed=7)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    got = _port_swa(q, k, v, window, softcap).numpy()
    for want in (ref.ops.sliding_window_attention(*args, window=window,
                                                  softcap=softcap),
                 ref.oracles.sliding_window_attention_ref(
                     *args, window, softcap=softcap)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


def test_flash_attention_entry_is_causal_window(ref):
    q, k, v = _swa_case(24, seed=3)
    got = pops.flash_attention(*(torch.from_numpy(a).bfloat16()
                                 for a in (q, k, v)), softcap=30.0)
    assert torch.equal(got, _port_swa(q, k, v, 24, 30.0))


# -------------------------------------------------------------- rs_matmul
@pytest.mark.parametrize("M,K,N", [(8, 16, 8), (48, 100, 72), (129, 257, 65)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "relu", "silu", "gelu"])
def test_rs_matmul_plain_matches_reference(ref, M, K, N, dtype, act):
    """Against the Pallas row-stationary kernel in interpret mode, with bias
    and each activation, on outputs of order 1: 1e-5 in fp32 (sums in
    another order), 5e-2 in bf16 (the reference's own tolerance for its
    kernel, tests/test_kernels.py)."""
    jnp = ref.jnp
    rng = np.random.default_rng(M + K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    bias = rng.standard_normal(N).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref.ops.rs_matmul(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), bias=jnp.asarray(bias),
        activation=act))
    got = pops.rs_matmul(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt),
                         bias=torch.from_numpy(bias), activation=act)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    half = pops.rs_matmul(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(w).to(tdt),
                          bias=torch.from_numpy(bias), activation=act,
                          out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and torch.equal(half,
                                                        got.bfloat16())


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc "
                    "for sm_90a and run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("KV,R,D,softcap", [(2, 8, 128, 30.0),
                                            (4, 2, 256, 50.0)])
def test_cuda_paged_attention_matches_plain(cuda, KV, R, D, softcap):
    """qwen2.5-3b's head layout, and gemma2-2b's (head_dim 256, softcap 50)
    on rows up to 6000 tokens."""
    lengths = [64, 65, 1, 130] if D == 128 else [6000, 7, 4724, 1523]
    for int8 in (False, True):
        q, kp, vp, bt, lens, sc = _paged_case(lengths, 64, KV=KV, R=R, D=D,
                                              int8=int8)
        dt = torch.int8 if int8 else torch.bfloat16
        args = (torch.from_numpy(q).bfloat16().to(cuda),
                torch.from_numpy(kp).to(dt).to(cuda),
                torch.from_numpy(vp).to(dt).to(cuda),
                torch.from_numpy(bt).to(cuda), torch.from_numpy(lens).to(cuda))
        kw = {} if sc is None else dict(
            k_scale=torch.from_numpy(sc[0]).to(cuda),
            v_scale=torch.from_numpy(sc[1]).to(cuda))
        got = pops.paged_attention(*args, softcap=softcap, **kw)
        want = pops.paged_attention(*args, softcap=softcap, impl="plain",
                                    **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [1, 2, 8, 16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_cuda_paged_attention_split_edges(cuda, R, D, int8, softcap):
    """The split kernel and its combine at the edges of ``split_plan``'s
    runs: rows of 0 and 1 tokens, of exactly one run, of a page count that
    is not a multiple of the run, one of 94 pages (gemma2-2b's longest) with
    a -1 hole inside its occupancy (reads page 0). 1e-4 absolute."""
    ps, KV, B, MP = 64, 2, 5, 96
    pages, _ = ppa.split_plan(B, KV, MP, ppa._sm_count(cuda.index or 0))
    assert pages > 1
    lengths = [0, 1, pages * ps, (2 * pages + 1) * ps - 3, 6000]
    q, kp, vp, bt, lens, sc = _paged_case(lengths, ps, KV=KV, R=R, D=D,
                                          int8=int8)
    table = np.full((B, MP), -1, np.int32)
    table[:, :bt.shape[1]] = bt
    table[4, 3] = -1
    dt = torch.int8 if int8 else torch.bfloat16
    args = (torch.from_numpy(q).bfloat16().to(cuda),
            torch.from_numpy(kp).to(dt).to(cuda),
            torch.from_numpy(vp).to(dt).to(cuda),
            torch.from_numpy(table).to(cuda), torch.from_numpy(lens).to(cuda))
    kw = {} if sc is None else dict(
        k_scale=torch.from_numpy(sc[0]).to(cuda),
        v_scale=torch.from_numpy(sc[1]).to(cuda))
    got = pops.paged_attention(*args, softcap=softcap, **kw)
    want = pops.paged_attention(*args, softcap=softcap, impl="plain", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_cuda_paged_attention_refuses_what_it_cannot_take(cuda):
    q, kp, vp, bt, lens, _ = _paged_case([5], 8, KV=1, R=17, D=16)
    args = [torch.from_numpy(a).to(cuda) for a in (kp, vp, bt, lens)]
    qt = torch.from_numpy(q).bfloat16().to(cuda).reshape(1, 1, 17, 16)
    with pytest.raises(ValueError, match="16 query heads"):
        ppa.paged_attention_cuda(qt, args[0].bfloat16(), args[1].bfloat16(),
                                 *args[2:])
    q, kp, vp, bt, lens, _ = _paged_case([5], 8, KV=1, R=1, D=48)
    with pytest.raises(ValueError, match="head_dim"):
        ppa.paged_attention_cuda(
            torch.from_numpy(q).bfloat16().to(cuda).reshape(1, 1, 1, 48),
            torch.from_numpy(kp).bfloat16().to(cuda),
            torch.from_numpy(vp).bfloat16().to(cuda),
            torch.from_numpy(bt).to(cuda), torch.from_numpy(lens).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 40])
def test_cuda_bcsc_apply_matches_plain(cuda, M):
    """GEMV (M <= 8) and GEMM (M > 8) kernels against the plain product."""
    port = _port_pack(256, 512, 0.75, M, cuda)
    x = torch.randn(M, 256, device=cuda).bfloat16()
    bias = torch.randn(512, device=cuda)
    plan = _plan()
    got = pops.bcsc_apply_packed(x, port, n_out=512, plan=plan, bias=bias,
                                 activation="silu")
    want = pops.bcsc_apply_packed(x, port, n_out=512, plan=plan, bias=bias,
                                  activation="silu", impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 64])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_cuda_bcsc_mlp_matches_plain(cuda, M, act):
    """SwiGLU (qwen2.5-3b) and GeGLU with tanh-gelu (gemma2-2b)."""
    packs = [_port_pack(K, N, 0.75, s, cuda) for K, N, s
             in ((256, 1024, 1), (256, 1024, 2), (1024, 256, 3))]
    x = torch.randn(M, 256, device=cuda).bfloat16()
    kw = dict(d_ff=1024, n_out=256, plan=_plan(), activation=act)
    got = pops.bcsc_mlp_packed(x, *packs, **kw)
    want = pops.bcsc_mlp_packed(x, *packs, impl="plain", **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2e-3 * float(want.abs().max()))


@pytest.mark.gpu
def test_cuda_paged_attention_hole_reads_page_zero(cuda):
    q, kp, vp, bt, lens = _hole_case()
    args = (torch.from_numpy(q).bfloat16().to(cuda),
            torch.from_numpy(kp).bfloat16().to(cuda),
            torch.from_numpy(vp).bfloat16().to(cuda),
            torch.from_numpy(bt).to(cuda), torch.from_numpy(lens).to(cuda))
    got = pops.paged_attention(*args)
    want = pops.paged_attention(*args, impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("S,window,R,D", [(300, 300, 2, 256), (300, 70, 2, 256),
                                          (200, 200, 8, 128), (130, 40, 1, 64)])
def test_cuda_sliding_window_matches_plain(cuda, S, window, R, D):
    """The kernel walks keys in another order than flash's schedule and
    sums its tensor-core products in its own: 1e-3 of max |out|."""
    q, k, v = (torch.from_numpy(a).bfloat16().to(cuda)
               for a in _swa_case(S, KV=2, R=R, D=D, seed=S))
    got = pops.sliding_window_attention(q, k, v, window=window, softcap=50.0)
    want = pops.sliding_window_attention(q, k, v, window=window,
                                         softcap=50.0, impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("S,window", [(300, 70), (300, 300), (130, 40),
                                      (4097, 4096)])
@pytest.mark.parametrize("R", [1, 2, 8])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_cuda_sliding_window_tile_edges(cuda, S, window, R, D, softcap):
    """S and window not multiples of the 64-key tile (ragged last q and key
    tiles, the band's far edge inside a tile, masked and unmasked tiles),
    4097 with a 4096 window (one key past the window, the global causal
    shape's long walk): 1e-3 of max |out|."""
    q, k, v = (torch.from_numpy(a).bfloat16().to(cuda)
               for a in _swa_case(S, B=1 if S > 1000 else 2, KV=2, R=R, D=D,
                                  seed=S + window + R))
    got = pops.sliding_window_attention(q, k, v, window=window,
                                        softcap=softcap)
    want = pops.sliding_window_attention(q, k, v, window=window,
                                         softcap=softcap, impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(8, 2304, 9216), (100, 300, 70)])
def test_cuda_rs_matmul_matches_plain(cuda, M, K, N):
    x = torch.randn(M, K, device=cuda).bfloat16()
    w = (torch.randn(K, N, device=cuda) / K ** 0.5).bfloat16()
    bias = torch.randn(N, device=cuda)
    got = pops.rs_matmul(x, w, bias=bias, activation="gelu")
    want = pops.rs_matmul(x, w, bias=bias, activation="gelu", impl="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))
    with pytest.raises(ValueError, match="bf16"):
        pops.rs_matmul(x.float(), w.float())
